"""The port's serving slice (uvc_tpu_torch) against the JAX package, on the
CPU: physical compaction, the compact forward, and the eval step.  Also
that the port imports nothing of JAX or the JAX package, and that its
entry points refuse to fall back to the CPU when CUDA is asked for.

Compaction is slicing, so its weights must be equal.  f32 forwards agree
to 2e-4 (the same arithmetic in another summation order), and the eval
step's integer counts must be equal.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.infer import compact as jcompact
from uvc_tpu.models import vit as jvit
from uvc_tpu.train.state import TrainHParams
from uvc_tpu.train.step import build_eval_step
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.infer import compact as tcompact
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.train.step import eval_step

REPO = Path(__file__).resolve().parents[1]
CFG = jconfigs.get_config("testing").replace(
    embed_dim=16, num_heads=2, depth=3, num_classes=7, img_size=64)
TCFG = tconfigs.get_config("testing").replace(
    embed_dim=16, num_heads=2, depth=3, num_classes=7, img_size=64)


def setup_model():
    """Head 0 of layer 0 pruned, within-head dims pruned in layer 1, MLP
    units pruned everywhere, block 2 gated off."""
    params = jvit.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(0)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape), jnp.float32)
    s = jnp.array([[1.0, 32.0], [0.0, 20.0], [0.0, 40.0]])
    r = jnp.array([[0.0, 0.0], [2.0, 3.0], [0.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, CFG)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [-1.0, 1.0],
                                        [1.0, -1.0]])
    np_params = jax.tree.map(np.asarray, params)
    np_masks = jax.tree.map(np.asarray, masks)
    return (params, masks, params_from_numpy(np_params, device="cpu"),
            masks_from_numpy(np_masks, device="cpu"))


def images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.img_size, CFG.img_size, CFG.in_chans)).astype(np.float32)


def test_compact_model_matches():
    params, masks, tparams, tmasks = setup_model()
    jl, jtop = jcompact.compact_model(params, masks, CFG)
    tl, ttop = tcompact.compact_model(tparams, tmasks, TCFG,
                                      dtype=torch.float32, device="cpu")
    assert len(tl) == len(jl) == 2
    assert [blk["num_heads"] for blk in tl] == [1, 2]
    for jb, tb in zip(jl, tl):
        assert jb["num_heads"] == tb["num_heads"]
        for name in ("ln1", "qkv", "proj", "ln2", "fc1", "fc2"):
            for leaf in jb[name]:
                np.testing.assert_array_equal(tb[name][leaf].numpy(),
                                              np.asarray(jb[name][leaf]))
    assert sorted(jtop) == sorted(ttop)
    np.testing.assert_array_equal(ttop["pos_embed"].numpy(),
                                  np.asarray(jtop["pos_embed"]))
    for ratio in (None, 0.7):
        assert tcompact.compact_flops_fraction(tl, TCFG, ratio) == \
            pytest.approx(jcompact.compact_flops_fraction(jl, CFG, ratio),
                          rel=1e-12)


def test_compact_model_is_built_in_the_serving_dtype():
    """The default (bf16) compaction is the f32 one cast once, with the
    kernels' all-ones masks stored beside the weights."""
    _, _, tparams, tmasks = setup_model()
    l32, top32 = tcompact.compact_model(tparams, tmasks, TCFG,
                                        dtype=torch.float32, device="cpu")
    l16, top16 = tcompact.compact_model(tparams, tmasks, TCFG, device="cpu")
    for b32, b16 in zip(l32, l16):
        for name in ("qkv", "proj", "fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                assert b16[name][leaf].dtype == torch.bfloat16
                assert torch.equal(b16[name][leaf],
                                   b32[name][leaf].to(torch.bfloat16))
        assert b16["ln1"]["scale"].dtype == torch.float32
        da, fk = b16["proj"]["kernel"].shape[0], b16["fc1"]["kernel"].shape[1]
        assert torch.equal(b16["ctx_mask"], torch.ones(da, dtype=torch.bfloat16))
        assert torch.equal(b16["hidden_mask"],
                           torch.ones(fk, dtype=torch.bfloat16))
    for k in top16:
        want = (torch.bfloat16 if k in ("patch_embed", "pos_embed",
                                        "cls_token") else torch.float32)
        for leaf in jax.tree.leaves(top16[k]):
            assert leaf.dtype == want, k


@pytest.mark.parametrize("token_ratio", [None, 0.7])
def test_apply_compact_matches(token_ratio):
    params, masks, tparams, tmasks = setup_model()
    x = images(1, 4)
    jl, jtop = jcompact.compact_model(params, masks, CFG)
    ref = jcompact.apply_compact(jl, jtop, jnp.asarray(x), CFG,
                                 dtype=jnp.float32, token_ratio=token_ratio)
    tl, ttop = tcompact.compact_model(tparams, tmasks, TCFG,
                                      dtype=torch.float32, device="cpu")
    out = tcompact.apply_compact(tl, ttop, torch.from_numpy(x), TCFG,
                                 dtype=torch.float32, token_ratio=token_ratio)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("masked,patch_gating", [(True, 2), (False, 0)])
def test_eval_step_matches(masked, patch_gating):
    params, masks, tparams, tmasks = setup_model()
    x = images(2, 6)
    labels = np.array([0, 3, 6, 2, -1, -1], np.int32)   # two padding rows
    jhp = JHParams(enable_patch_gating=patch_gating, patch_ratio=0.7)
    thp = THParams(enable_patch_gating=patch_gating, patch_ratio=0.7)
    ref = build_eval_step(CFG, jhp, TrainHParams(compute_dtype=jnp.float32),
                          masked=masked)(params, masks, jnp.asarray(x),
                                         jnp.asarray(labels),
                                         jax.random.PRNGKey(0))
    out = eval_step(tparams, tmasks if masked else None, torch.from_numpy(x),
                    torch.from_numpy(labels).long(), TCFG, thp,
                    dtype=torch.float32)
    assert int(out["count"]) == int(ref["count"]) == 4
    assert int(out["correct"]) == int(ref["correct"])
    assert float(out["loss_sum"]) == pytest.approx(float(ref["loss_sum"]),
                                                   rel=2e-4)


def test_hparams_fields_match_the_jax_defaults():
    j = JHParams()
    for field, value in vars(THParams()).items():
        assert getattr(j, field) == value


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import uvc_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(uvc_tpu_torch.__path__,"
        " 'uvc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'uvc_tpu'))\n"
        "assert not bad, bad\n"
        "assert {'uvc_tpu_torch.ops.performer',"
        " 'uvc_tpu_torch.models.t2t_vit',"
        " 'uvc_tpu_torch.models.t2t_ablations'} <= set(sys.modules)\n"
        "print(len([n for n in sys.modules"
        " if n.startswith('uvc_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params, masks, tparams, tmasks = setup_model()
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvit.init_params(torch.Generator().manual_seed(0), TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(np_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        masks_from_numpy(jax.tree.map(np.asarray, masks))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcompact.compact_model(tparams, tmasks, TCFG)


def test_t2t_compact_serving_is_not_ported():
    """The T2T stem of the plain T2T-ViT family serves (see
    test_torch_port_t2t.py); the architecture ablations' stems do not."""
    cfg = tconfigs.get_config("t2t_vit_14_se")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcompact.apply_compact([], {}, torch.zeros(1, 224, 224, 3), cfg)
