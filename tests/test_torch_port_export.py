"""The port's serving export (uvc_tpu_torch/infer/export.py) on the CPU,
against the JAX package's (uvc_tpu/infer/export.py) and the port's own
``apply_compact``.

The compact model is ``tests/test_export.py``'s (the testing config at
width 16, two heads, three blocks, block 2 gated off, one head and half
the units of block 0 pruned), its JAX parameters and masks carried into
the port.  A ``torch.export`` program runs the same operators as the
eager forward, so the served logits are ``apply_compact``'s bit for bit;
against JAX's StableHLO artifact they agree within 1e-5 in f32.  The
artifact's graph calls the kernels' operators (``torch.library``, defined
in ``ops/_library.py``): ``uvc_tpu_torch.layer_attention_ln`` and
``mlp_ln`` once per kept block and ``performer`` twice for the T2T stem.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.compress.masks import build_masks as jbuild_masks
from uvc_tpu.configs import get_config as jget_config
from uvc_tpu.infer import compact as jcompact
from uvc_tpu.infer import export as jexport
from uvc_tpu.models import vit as jvit
from uvc_tpu_torch.compress.masks import build_masks
from uvc_tpu_torch.configs import get_config
from uvc_tpu_torch.infer.compact import apply_compact, compact_model
from uvc_tpu_torch.infer.export import (ServingModel, export_serving,
                                        load_serving, save_serving)
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.models import t2t_vit
from uvc_tpu_torch.ops import attention as tatt
from uvc_tpu_torch.ops import mlp as tmlp
from uvc_tpu_torch.ops import performer as tperf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(embed_dim=16, num_heads=2, depth=3, num_classes=7)
JCFG = jget_config("testing").replace(**CUT)
TCFG = get_config("testing").replace(**CUT)
JAX_TOL = 1e-5


def _jax_compact():
    """``tests/test_export.py``'s JAX parameters and masks, with a random
    head (the zero-initialised one serves all-zero logits)."""
    params = jvit.init_params(jax.random.PRNGKey(0), JCFG)
    params["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(9), params["head"]["kernel"].shape)
    s = jnp.array([[1.0, 32.0], [0.0, 32.0], [0.0, 32.0]])
    masks = jbuild_masks(params, s, jnp.zeros((3, 2)), JCFG)
    params["block_gating"] = jnp.array(
        [[-1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]])
    return params, masks


def _port_compact(dtype=torch.float32):
    """The port's compact model of the carried JAX parameters and masks,
    with JAX's own compact model beside it."""
    params, masks = _jax_compact()
    jlayers, jtop = jcompact.compact_model(params, masks, JCFG)
    np_ = jax.tree.map(np.asarray, params)
    layers, top = compact_model(
        params_from_numpy(np_, device="cpu"),
        masks_from_numpy(jax.tree.map(np.asarray, masks), device="cpu"),
        TCFG, dtype=dtype, device="cpu")
    return (layers, top), (jlayers, jtop)


def _images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, TCFG.img_size, TCFG.img_size, 3)).astype(np.float32)


def _served(layers, top, x, token_ratio=None, dtype=torch.float32):
    out = apply_compact(layers, top, torch.from_numpy(x).to(dtype), TCFG,
                        dtype=dtype, token_ratio=token_ratio)
    return 0.5 * (out.logits + out.logits_kd) if TCFG.distilled \
        else out.logits


def _jax_served(jlayers, jtop, x, batches, token_ratio=None):
    model = jexport.ServingModel(jexport.export_serving(
        jlayers, jtop, JCFG, batch_sizes=batches, token_ratio=token_ratio,
        dtype=jnp.float32))
    return np.asarray(model(jnp.asarray(x)))


def test_carried_compact_model_is_jax_s():
    """The port compacts the carried parameters into JAX's compact layers,
    leaf for leaf."""
    (layers, top), (jlayers, jtop) = _port_compact()
    assert [blk["num_heads"] for blk in layers] == \
        [blk["num_heads"] for blk in jlayers] == [1, 2]
    for blk, jblk in zip(layers, jlayers):
        for k in ("ln1", "qkv", "proj", "ln2", "fc1", "fc2"):
            for leaf in jblk[k]:
                np.testing.assert_array_equal(blk[k][leaf].numpy(),
                                              np.asarray(jblk[k][leaf]))


def test_export_roundtrip_matches_apply_compact(tmp_path):
    """One artifact (batch 4) saved and loaded serves ``apply_compact``'s
    logits bit for bit and JAX's artifact's within 1e-5 (f32)."""
    (layers, top), (jlayers, jtop) = _port_compact()
    arts = export_serving(layers, top, TCFG, batch_sizes=(4,),
                          dtype=torch.float32)
    assert set(arts) == {"b4"}
    path = str(tmp_path / "serve.npz")
    save_serving(path, arts)
    model = load_serving(path)
    assert model.batch_sizes == [4]
    x = _images(1, 4)
    got = model(torch.from_numpy(x))
    assert torch.equal(got, _served(layers, top, x))
    np.testing.assert_allclose(got.numpy(), _jax_served(jlayers, jtop, x,
                                                        (4,)),
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_export_pads_partial_batch():
    """A batch of 3 pads to the b4 program and trims back; b2 fits
    exactly; past the largest batch JAX's ValueError."""
    (layers, top), (jlayers, jtop) = _port_compact()
    model = ServingModel(export_serving(layers, top, TCFG,
                                        batch_sizes=(2, 4),
                                        dtype=torch.float32))
    x = torch.from_numpy(_images(2, 3))
    out3 = model(x)
    assert out3.shape == (3, TCFG.num_classes)
    np.testing.assert_allclose(out3.numpy(), _jax_served(
        jlayers, jtop, x.numpy(), (2, 4)), rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(model(x[:2]).numpy(), out3[:2].numpy(),
                               rtol=JAX_TOL, atol=JAX_TOL)
    with pytest.raises(ValueError,
                       match="batch 5 exceeds largest exported size 4"):
        model(torch.zeros(5, TCFG.img_size, TCFG.img_size, 3))


def test_export_token_slimming_artifact():
    """The token drop at ratio 0.7 stays a static top-k in the program."""
    (layers, top), (jlayers, jtop) = _port_compact()
    model = ServingModel(export_serving(layers, top, TCFG, batch_sizes=(2,),
                                        token_ratio=0.7,
                                        dtype=torch.float32))
    x = _images(3, 2)
    got = model(torch.from_numpy(x))
    assert torch.equal(got, _served(layers, top, x, token_ratio=0.7))
    np.testing.assert_allclose(got.numpy(), _jax_served(
        jlayers, jtop, x, (2,), token_ratio=0.7), rtol=JAX_TOL,
        atol=JAX_TOL)


def _kernel_nodes(art: bytes) -> list:
    program = torch.export.load(io.BytesIO(art))
    return [str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("uvc_tpu_torch.")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_calls_the_kernel_operators(dtype):
    """The program calls K1 and K2 as operators, once per kept block (two
    of three), and holds no decomposition of them: bit for bit the eager
    forward in the serving dtype."""
    (layers, top), _ = _port_compact(dtype)
    arts = export_serving(layers, top, TCFG, batch_sizes=(2,), dtype=dtype)
    assert _kernel_nodes(arts["b2"]) == [
        "uvc_tpu_torch.layer_attention_ln.default",
        "uvc_tpu_torch.mlp_ln.default"] * 2
    x = _images(4, 2)
    assert torch.equal(ServingModel(arts)(torch.from_numpy(x)),
                       _served(layers, top, x, dtype=dtype))


def test_t2t_export_calls_the_performer_operator():
    """A T2T-ViT-14 cut to 32 px and two blocks: the stem's two performer
    stages are operator calls, the artifact bit for bit
    ``apply_compact``."""
    cfg = get_config("t2t_vit_14").replace(img_size=32, depth=2,
                                           num_classes=10)
    params = t2t_vit.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape,
        generator=torch.Generator().manual_seed(1))
    masks = build_masks(params, torch.tensor([[3.0, 576.0]] * 2),
                        torch.tensor([[0.0, 2, 0, 5, 0, 1]] * 2), cfg)
    layers, top = compact_model(params, masks, cfg, dtype=torch.bfloat16,
                                device="cpu")
    arts = export_serving(layers, top, cfg, batch_sizes=(2,))
    assert _kernel_nodes(arts["b2"]) == (
        ["uvc_tpu_torch.performer.default"] * 2
        + ["uvc_tpu_torch.layer_attention_ln.default",
           "uvc_tpu_torch.mlp_ln.default"] * 2)
    x = torch.from_numpy(_images(5, 2))
    want = apply_compact(layers, top, x.to(torch.bfloat16), cfg).logits
    assert torch.equal(ServingModel(arts)(x), want)


def test_load_side_needs_no_model_code(tmp_path):
    """A fresh interpreter that imports ``uvc_tpu_torch.infer.export``
    alone loads and serves the artifact: no ``models``, ``infer.compact``,
    ``train`` or JAX module is loaded, and the logits are the ones served
    in this process."""
    (layers, top), _ = _port_compact()
    path = tmp_path / "serve.npz"
    save_serving(str(path), export_serving(layers, top, TCFG,
                                           batch_sizes=(2,),
                                           dtype=torch.float32))
    x = _images(6, 2)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "from uvc_tpu_torch.infer.export import load_serving\n"
        f"m = load_serving({str(path)!r})\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, m(x).numpy())\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'uvc_tpu') or n.startswith(("
        "'uvc_tpu_torch.models', 'uvc_tpu_torch.infer.compact', "
        "'uvc_tpu_torch.train')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    assert np.array_equal(np.load(tmp_path / "y.npy"),
                          _served(layers, top, x).numpy())


def _operator_args(name):
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=0.1):
        return scale * torch.randn(shape, generator=g)

    if name == "layer_attention_ln":
        return tatt.layer_attention_ln_op, (
            r(2, 5, 16, scale=1.0), 1 + r(16), r(16), r(16, 48), r(48),
            r(16, 16), r(16), torch.ones(16), 2, 0.35, 1e-6)
    if name == "mlp_ln":
        return tmlp.mlp_ln_op, (
            r(2, 5, 16, scale=1.0), 1 + r(16), r(16), r(16, 64), r(64),
            r(64, 16), r(16), torch.ones(64), 1e-6)
    dim, emb, m = 24, 64, 32
    return tperf.performer_op, (
        r(2, 7, dim, scale=1.0), 1 + r(dim), r(dim), r(dim, 3 * emb),
        r(3 * emb), r(m, emb, scale=1.0), torch.ones(dim), r(emb, emb),
        r(emb), 1 + r(emb), r(emb), r(emb, emb), r(emb), r(emb, emb),
        r(emb), float(dim))


@pytest.mark.parametrize("name", ["layer_attention_ln", "mlp_ln",
                                  "performer"])
def test_operators_pass_opcheck(name):
    """``torch.library.opcheck`` on the CPU: the schema, the fake
    implementation's shapes, dtypes and strides against the plain
    version's outputs, and tracing; the operator is the plain version."""
    op, args = _operator_args(name)
    torch.library.opcheck(op, args)
    plain = {"layer_attention_ln": lambda *a: tatt.layer_attention_ln_plain(
        *a[:8], num_heads=a[8], scale=a[9], eps=a[10]),
        "mlp_ln": lambda *a: tmlp.mlp_ln_plain(*a[:8], eps=a[8]),
        "performer": lambda *a: tperf.performer_plain(*a[:15],
                                                      fcount=a[15])}[name]
    got, want = op(*args), plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
