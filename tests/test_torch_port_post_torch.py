"""Stage 2 from a reference-layout torch stage-1 checkpoint
(uvc_tpu_torch/cli/post_train.py with models/convert.py's
``masks_from_torch_state_dict``), on the CPU.

The reference's stage-1 artifact is the model's ``state_dict`` with a
binary ``mask`` buffer on every weighted module, rebuilt from the
discovered architecture by ``prune_w_mask``: zero columns of
``attn.proj`` (the pruned context dims), zero rows of ``mlp.fc1`` and
zero columns of ``mlp.fc2`` (the pruned units), ones elsewhere; the
pruned coordinates keep their shrunken nonzero weights.  The test lays the
buffers out from JAX's ``build_masks`` of a seeded ``s``, ``r`` on
DeiT-Tiny (3 heads, 12 blocks) at 32 px, saves the ``.pth.tar``, and
holds the port to JAX: the weights are JAX's ``load_torch_checkpoint``'s
bit for bit, the masks JAX's ``build_masks`` (never JAX's all-ones
substitute), and a 1-epoch ``post_train`` from the file is the run from
the equivalent ``.ckpt``.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.models import convert as jconvert
from uvc_tpu.models import vit as jvit
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.cli import post_train as t_post
from uvc_tpu_torch.models import convert as tconvert
from uvc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

MODEL = "deit_tiny_patch16_224"
# the two routes' trees hold their top-level keys in another order (a
# checkpoint's are sorted), so the global gradient norm sums its leaves in
# another order: the runs agree to f32 rounding, not bit for bit
SUM_ORDER_TOL = 1e-6
JCFG = jconfigs.get_config(MODEL).replace(img_size=32, num_classes=1000)
TCFG = tconfigs.get_config(MODEL).replace(img_size=32, num_classes=1000)
RUN = ["--model_type", MODEL, "--dataset", "synthetic", "--img_size", "32",
       "--train_batch_size", "8", "--eval_batch_size", "8",
       "--synthetic_steps", "2", "--num_epochs", "1",
       "--enable_patch_gating", "0", "--dp", "1", "--device", "cpu"]


def _arch(seed=3):
    """A seeded discovered architecture: per layer, up to one of 3 heads
    and up to 400 of 768 units pruned, up to 20 dims in each head."""
    rng = np.random.default_rng(seed)
    l, h = JCFG.depth, JCFG.num_heads
    s = np.stack([rng.integers(0, 2, l), rng.integers(0, 401, l)],
                 axis=1).astype(np.float32)
    r = rng.integers(0, 21, (l, h)).astype(np.float32)
    return jnp.asarray(s), jnp.asarray(r)


def reference_state_dict(seed=3):
    """(state dict with ``*.mask`` buffers, JAX params, JAX masks)."""
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(0.2 * rng.standard_normal(a.shape),
                              jnp.float32), params)
    params["block_gating"] = jnp.tile(jnp.array([-1.0, 1.0]),
                                      (JCFG.depth, 1))
    masks = jmasks.build_masks(params, *_arch(seed), JCFG)
    np_params = jax.tree.map(np.asarray, params)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          jconvert.to_torch_state_dict(np_params, JCFG).items()}
    attn, mlp = np.asarray(masks["attn"]), np.asarray(masks["mlp"])
    # a mask buffer on every weighted module, ones but where pruning zeroes
    for key in [k for k in sd if k.endswith(".weight")]:
        sd[key[:-len("weight")] + "mask"] = torch.ones_like(sd[key])
    for i in range(JCFG.depth):
        sd[f"blocks.{i}.attn.proj.mask"] *= torch.from_numpy(attn[i])[None]
        sd[f"blocks.{i}.mlp.fc2.mask"] *= torch.from_numpy(mlp[i])[None]
        sd[f"blocks.{i}.mlp.fc1.mask"] *= torch.from_numpy(mlp[i])[:, None]
    return sd, np_params, masks


def test_masks_and_weights_of_the_buffers_match_jax(tmp_path):
    sd, _, masks = reference_state_dict()
    path = str(tmp_path / "stage1.pth.tar")
    torch.save({"model": sd, "epoch": 29}, path)
    params, tmasks = t_post.stage1_params_and_masks(path, TCFG)
    for k in ("attn", "mlp"):
        np.testing.assert_array_equal(tmasks[k].numpy(), np.asarray(masks[k]))
        assert tmasks[k].dtype == torch.float32
    # a real architecture: neither all ones nor all zeros
    assert 0 < float(tmasks["mlp"].mean()) < 1
    assert 0 < float(tmasks["attn"].mean()) < 1
    ref = jconvert.load_torch_checkpoint(path, JCFG)
    paths = {p for p, _ in tree_leaves_with_path(params)}
    assert paths == {tuple(str(getattr(k, "key", k)) for k in p) for p, _ in
                     jax.tree_util.tree_leaves_with_path(ref)}
    for p, leaf in tree_leaves_with_path(params):
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(leaf_at(ref, p)),
                                      err_msg=str(p))
    # the pruned coordinates keep their nonzero weights (prune_w_mask)
    off = tmasks["mlp"][0] == 0
    assert params["blocks"]["fc2"]["kernel"][0][off].abs().min() > 0


def test_post_train_from_pth_tar_is_the_ckpt_run(tmp_path):
    """One epoch of ``post_train`` from the ``.pth.tar`` and from the
    ``.ckpt`` holding the same params and masks: the two stage-2
    checkpoints agree (masks, counters and exact zeros bit for bit), and
    the run trained under the buffers' masks (the first moments exactly
    zero at the pruned units' fc1 columns)."""
    sd, _, masks = reference_state_dict()
    pth = str(tmp_path / "stage1.pth.tar")
    torch.save({"model": sd}, pth)
    params, tmasks = t_post.stage1_params_and_masks(pth, TCFG)
    ckpt = str(tmp_path / "stage1.ckpt")
    save_checkpoint(ckpt, {"params": params, "masks": tmasks})
    for name, src in (("pth", pth), ("ckpt", ckpt)):
        t_post.main(RUN + ["--checkpoint_dir", src, "--output_dir",
                           str(tmp_path), "--name", name])
    out = f"{MODEL}_post_0.ckpt"
    ck = load_checkpoint(str(tmp_path / "pth" / out))
    ref = load_checkpoint(str(tmp_path / "ckpt" / out))
    leaves = dict(tree_leaves_with_path(ck))
    assert sorted(leaves) == sorted(p for p, _ in tree_leaves_with_path(ref))
    for p, want in tree_leaves_with_path(ref):
        got = leaves[p]
        if not torch.is_tensor(want) or not want.is_floating_point() \
                or p[0] == "masks":
            assert np.array_equal(np.asarray(got), np.asarray(want)), p
        elif want.any():
            rel = float((got - want).norm() / want.norm())
            assert rel <= SUM_ORDER_TOL, p
        else:
            assert not got.any(), p
    np.testing.assert_array_equal(ck["masks"]["mlp"].numpy(),
                                  np.asarray(masks["mlp"]))
    mu = ck["opt_state"]["0"]["mu"]["blocks"]["fc1"]["kernel"]
    off = np.asarray(masks["mlp"]) == 0
    for i in range(JCFG.depth):
        assert not mu[i][:, torch.from_numpy(off[i])].any()
        assert mu[i][:, torch.from_numpy(~off[i])].any()


def _broken(case):
    sd, _, _ = reference_state_dict()
    if case == "fc1_rows_disagree":
        sd["blocks.1.mlp.fc1.mask"] = torch.ones_like(
            sd["blocks.1.mlp.fc1.mask"])
    elif case == "ragged_column":
        sd["blocks.2.attn.proj.mask"][5, 0] = 1 - \
            sd["blocks.2.attn.proj.mask"][5, 0]
    elif case == "pruned_qkv":
        sd["blocks.0.attn.qkv.mask"][0, 0] = 0.0
    elif case == "not_binary":
        sd["blocks.3.mlp.fc2.mask"] = 0.5 * sd["blocks.3.mlp.fc2.mask"]
    elif case == "missing":
        del sd["blocks.4.mlp.fc2.mask"]
    return sd


@pytest.mark.parametrize("case", ["fc1_rows_disagree", "ragged_column",
                                  "pruned_qkv", "not_binary", "missing"])
def test_inconsistent_buffers_raise(case):
    with pytest.raises(ValueError):
        tconvert.masks_from_torch_state_dict(_broken(case), TCFG)


def test_module_prefix_is_dropped():
    sd, _, masks = reference_state_dict()
    out = tconvert.masks_from_torch_state_dict(
        {f"module.{k}": v for k, v in sd.items()}, TCFG)
    np.testing.assert_array_equal(out["attn"].numpy(),
                                  np.asarray(masks["attn"]))
