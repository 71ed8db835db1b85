"""The port's sublayer ops (uvc_tpu_torch/ops) against the JAX package.

The same numpy inputs go through the JAX function and the port's plain
PyTorch version on the CPU:

* bf16 against the Pallas kernels in interpret mode
  (``fused_layer_attention_ln`` / ``fused_mlp_ln`` / ``fused_mlp_ln_blend``
  with ``interpret=True``): both round at the same places, and differ by
  the f32 summation order and by GELU (the Pallas body uses the
  Abramowitz-Stegun erf, |err| < 1.5e-7; the port the exact erf), i.e.
  by one-ulp bf16 flips of single elements -> relative Frobenius <= 2e-2;
* f32 against the JAX CPU composition: the same arithmetic in another
  summation order -> relative Frobenius <= 2e-4.

On the CPU the wrappers take the plain version, and their launch counters
stay at 0.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import attention as jattn
from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops.attention import (layer_attention, layer_attention_ln,
                                         layer_attention_ln_plain)
from uvc_tpu_torch.ops.mlp import (mlp_ln, mlp_ln_blend, mlp_ln_blend_plain,
                                   mlp_ln_plain)

BF16_TOL = 2e-2
F32_TOL = 2e-4
EPS = 1e-6


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def jax_np(x):
    return np.asarray(x.astype(jnp.float32))


def attention_inputs(seed, b, n, dm, da):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        g1=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b1=(0.1 * rng.standard_normal(dm)).astype(f32),
        wqkv=(rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask)


def mlp_inputs(seed, b, n, dm, f):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(f) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        xin=rng.standard_normal((b, n, dm)).astype(f32),
        g2=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b2=(0.1 * rng.standard_normal(dm)).astype(f32),
        wfc1=(rng.standard_normal((dm, f)) / np.sqrt(dm)).astype(f32),
        bfc1=(0.1 * rng.standard_normal(f)).astype(f32),
        wfc2=(rng.standard_normal((f, dm)) / np.sqrt(f)).astype(f32),
        bfc2=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask)


# layer norm parameters stay f32 in both packages; the rest is cast
LN_KEYS = ("g1", "b1", "g2", "b2")


def cast_all(inp, conv, dtype, f32):
    return {k: conv(v, f32 if k in LN_KEYS else dtype) for k, v in inp.items()}


# (batch, tokens, model width, attention width, heads): N not a multiple
# of 16, and attention widths below the model width (compacted layers)
ATTN_CASES = [(2, 13, 16, 16, 2), (2, 21, 16, 8, 1), (1, 40, 32, 16, 2)]


@pytest.mark.parametrize("b,n,dm,da,heads", ATTN_CASES)
def test_attention_plain_matches_pallas_bf16(b, n, dm, da, heads):
    inp = attention_inputs(0, b, n, dm, da)
    scale = (da // heads) ** -0.5
    j = cast_all(inp, to_jax, jnp.bfloat16, jnp.float32)
    ref = jattn.fused_layer_attention_ln(
        j["x"], j["g1"], j["b1"], j["wqkv"], j["bqkv"], j["wproj"],
        j["bproj"], j["mask"], num_heads=heads, scale=scale, eps=EPS,
        interpret=True)
    t = cast_all(inp, to_torch, torch.bfloat16, torch.float32)
    out = layer_attention_ln_plain(
        t["x"], t["g1"], t["b1"], t["wqkv"], t["bqkv"], t["wproj"],
        t["bproj"], t["mask"], num_heads=heads, scale=scale, eps=EPS)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, dm)
    assert rel_fro(out.float().numpy(), jax_np(ref)) <= BF16_TOL


@pytest.mark.parametrize("b,n,dm,da,heads", ATTN_CASES)
def test_attention_plain_matches_composition_f32(b, n, dm, da, heads):
    inp = attention_inputs(1, b, n, dm, da)
    scale = (da // heads) ** -0.5
    j = cast_all(inp, to_jax, jnp.float32, jnp.float32)
    ref = jattn.layer_attention_ln(
        j["x"], j["g1"], j["b1"], j["wqkv"], j["bqkv"], j["wproj"],
        j["bproj"], j["mask"], num_heads=heads, scale=scale, eps=EPS)
    t = cast_all(inp, to_torch, torch.float32, torch.float32)
    out = layer_attention_ln(
        t["x"], t["g1"], t["b1"], t["wqkv"], t["bqkv"], t["wproj"],
        t["bproj"], t["mask"], num_heads=heads, scale=scale, eps=EPS)
    assert rel_fro(out.numpy(), np.asarray(ref)) <= F32_TOL


# (batch, tokens, model width, hidden width)
MLP_CASES = [(2, 13, 16, 64), (1, 37, 32, 128)]
# soft and hard (keep / skip) block-gating distributions
BLENDS = [(0.3, 0.7), (0.0, 1.0), (1.0, 0.0)]


def _jax_mlp(j, d=None, fused=True):
    args = (j["g2"], j["b2"], j["wfc1"], j["bfc1"], j["wfc2"], j["bfc2"],
            j["mask"])
    if d is None:
        if fused:
            return jmlp.fused_mlp_ln(j["x"], *args, eps=EPS, interpret=True)
        return jmlp._composed_mlp_ln(j["x"], *args, EPS)
    if fused:
        return jmlp.fused_mlp_ln_blend(j["x"], j["xin"], d, *args, eps=EPS,
                                       interpret=True)
    return jmlp._composed_mlp_ln_blend(j["x"], j["xin"], d, *args, EPS)


def _torch_mlp(t, d=None, plain=True):
    args = (t["g2"], t["b2"], t["wfc1"], t["bfc1"], t["wfc2"], t["bfc2"],
            t["mask"])
    if d is None:
        return (mlp_ln_plain if plain else mlp_ln)(t["x"], *args, eps=EPS)
    fn = mlp_ln_blend_plain if plain else mlp_ln_blend
    return fn(t["x"], t["xin"], d, *args, eps=EPS)


@pytest.mark.parametrize("b,n,dm,f", MLP_CASES)
def test_mlp_plain_matches_pallas_bf16(b, n, dm, f):
    inp = mlp_inputs(2, b, n, dm, f)
    ref = _jax_mlp(cast_all(inp, to_jax, jnp.bfloat16, jnp.float32))
    out = _torch_mlp(cast_all(inp, to_torch, torch.bfloat16, torch.float32))
    assert out.dtype == torch.bfloat16
    assert rel_fro(out.float().numpy(), jax_np(ref)) <= BF16_TOL


@pytest.mark.parametrize("b,n,dm,f", MLP_CASES)
def test_mlp_plain_matches_composition_f32(b, n, dm, f):
    inp = mlp_inputs(3, b, n, dm, f)
    ref = _jax_mlp(cast_all(inp, to_jax, jnp.float32, jnp.float32),
                   fused=False)
    out = _torch_mlp(cast_all(inp, to_torch, torch.float32, torch.float32),
                     plain=False)
    assert rel_fro(out.numpy(), np.asarray(ref)) <= F32_TOL


@pytest.mark.parametrize("d", BLENDS)
def test_mlp_blend_plain_matches_pallas_bf16(d):
    inp = mlp_inputs(4, 2, 13, 16, 64)
    ref = _jax_mlp(cast_all(inp, to_jax, jnp.bfloat16, jnp.float32),
                   d=jnp.asarray(d, jnp.float32))
    out = _torch_mlp(cast_all(inp, to_torch, torch.bfloat16, torch.float32),
                     d=torch.tensor(d, dtype=torch.float32))
    assert rel_fro(out.float().numpy(), jax_np(ref)) <= BF16_TOL


@pytest.mark.parametrize("d", BLENDS)
def test_mlp_blend_plain_matches_composition_f32(d):
    inp = mlp_inputs(5, 1, 37, 32, 128)
    ref = _jax_mlp(cast_all(inp, to_jax, jnp.float32, jnp.float32),
                   d=jnp.asarray(d, jnp.float32), fused=False)
    out = _torch_mlp(cast_all(inp, to_torch, torch.float32, torch.float32),
                     d=torch.tensor(d, dtype=torch.float32), plain=False)
    assert rel_fro(out.numpy(), np.asarray(ref)) <= F32_TOL


def test_hard_blend_passes_skipped_block_input_through():
    inp = mlp_inputs(6, 2, 13, 16, 64)
    t = cast_all(inp, to_torch, torch.bfloat16, torch.float32)
    out = _torch_mlp(t, d=torch.tensor([1.0, 0.0]), plain=False)
    assert torch.equal(out, t["xin"])


def test_cpu_calls_leave_launch_counters_at_zero():
    tops.reset_launch_counts()
    a = cast_all(attention_inputs(7, 2, 13, 16, 16), to_torch,
                 torch.bfloat16, torch.float32)
    layer_attention_ln(a["x"], a["g1"], a["b1"], a["wqkv"], a["bqkv"],
                       a["wproj"], a["bproj"], a["mask"], num_heads=2,
                       scale=0.35, eps=EPS)
    layer_attention(a["x"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"],
                    a["mask"], num_heads=2, scale=0.35)
    m = cast_all(mlp_inputs(8, 2, 13, 16, 64), to_torch, torch.bfloat16,
                 torch.float32)
    _torch_mlp(m, plain=False)
    _torch_mlp(m, d=torch.tensor([0.5, 0.5]), plain=False)
    assert tops.launch_counts() == {"layer_attention_ln": 0, "mlp_ln": 0,
                                    "mlp_ln_blend": 0, "layer_attention": 0,
                                    "performer": 0, "attention": 0}
    assert _cuda._loaded == {}


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 13, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        layer_attention_ln(x, x[0, 0], x[0, 0], w[:, :48], w[0, :48], w[:, :16],
                           x[0, 0], x[0, 0], num_heads=2, scale=0.35, eps=EPS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_ln(x, x[0, 0], x[0, 0], w, w[0], w.T, x[0, 0], w[0], eps=EPS)


def test_kernel_build_is_keyed_on_sources():
    d = _cuda.build_dir()
    assert d.parent.name == "uvc_tpu_torch" and d.parent.parent.name == "build"
    assert len(d.name) == 16 and d == _cuda.build_dir()
    assert set(_cuda._LIBS) == {"attention", "mlp", "performer",
                                "attention_core"}
    for src, _ in _cuda._LIBS.values():
        assert (_cuda._CSRC / src).exists()
