"""K3, the MLP sublayer's forward with the block-gating blend
(uvc_tpu_torch/csrc/mlp.cu::uvc_mlp_ln_blend on the TMA / wgmma GEMM of
csrc/gemm_wg.cuh, fc2's epilogue ``EPI_BLEND``), against the JAX package on
the CPU at ViT-H/14's widths (dm 1280, F 5120) and a few rows.

No card here, so the kernel's function is held through its plain version
``mlp_ln_blend_plain``, which rounds where the kernel's epilogues round:
the LayerNorm output once, the hidden layer once after bias, GELU and
mask, the output once after the residual sum and the blend
``d1 * (x + (acc + b2)) + d0 * xin``.  Against
``_call_mlp_blend_fwd(..., interpret=True)`` in bf16 the two differ by the
f32 summation order and by GELU (the Pallas body's Abramowitz-Stegun erf
against the exact erf): one-ulp bf16 flips -> 1e-2 relative Frobenius;
against the JAX CPU composition in f32, where every rounding is the
identity -> 1e-5.  Then the epilogue's one rounding after the blend, and
the wrapper's route on operands that report a CUDA device.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import mlp as tmlp

BF16_TOL = 1e-2
F32_TOL = 1e-5
EPS = 1e-6
# ViT-H/14's MLP widths (uvc_tpu/configs.py ViT-H_14: dm 1280, F 5120)
DM, F_HIDDEN = 1280, 5120
ORDER = ("x", "xin", "d", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2",
         "mask")
F32_KEYS = ("d", "g2", "b2")
# the gating distribution (skip, keep): a soft draw and the two hard ones
D_SOFT, D_KEEP, D_SKIP = (0.3, 0.7), (0.0, 1.0), (1.0, 0.0)


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def blend_inputs(seed, b, n, d, dm=DM, f=F_HIDDEN):
    """K3's operands as f32 numpy arrays, in ``ORDER``: a keep mask over
    the hidden units (70% kept) and the distribution ``d``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        xin=rng.standard_normal((b, n, dm)).astype(f32),
        d=np.asarray(d, f32),
        g2=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b2=(0.1 * rng.standard_normal(dm)).astype(f32),
        wfc1=(rng.standard_normal((dm, f)) / np.sqrt(dm)).astype(f32),
        bfc1=(0.1 * rng.standard_normal(f)).astype(f32),
        wfc2=(rng.standard_normal((f, dm)) / np.sqrt(f)).astype(f32),
        bfc2=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=(rng.random(f) > 0.3).astype(f32))


def as_torch(inp, dtype):
    return [torch.from_numpy(inp[k]).to(torch.float32 if k in F32_KEYS
                                        else dtype) for k in ORDER]


def as_jax(inp, dtype):
    return [jnp.asarray(inp[k]).astype(jnp.float32 if k in F32_KEYS
                                       else dtype) for k in ORDER]


@pytest.mark.parametrize("b,n,d", [(1, 17, D_SOFT), (2, 9, D_KEEP)])
def test_k3_plain_matches_pallas_at_vit_h_widths_bf16(b, n, d):
    inp = blend_inputs(80 + n, b, n, d)
    got = tmlp.mlp_ln_blend_plain(*as_torch(inp, torch.bfloat16), eps=EPS)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, DM)
    x, xin, *rest = as_jax(inp, jnp.bfloat16)
    rows = -(-n // 16) * 16
    pad = ((0, 0), (0, rows - n), (0, 0))
    ref = jmlp._call_mlp_blend_fwd(jnp.pad(x, pad), jnp.pad(xin, pad), *rest,
                                   EPS, interpret=True)[:, :n]
    err = rel_fro(np_(got), np_(ref))
    assert err <= BF16_TOL, f"relative Frobenius {err:.2e}"


def test_k3_plain_is_the_composition_f32():
    inp = blend_inputs(81, 1, 17, D_SOFT)
    got = tmlp.mlp_ln_blend_plain(*as_torch(inp, torch.float32), eps=EPS)
    ref = jmlp._composed_mlp_ln_blend(*as_jax(inp, jnp.float32), EPS)
    err = rel_fro(np_(got), np_(ref))
    assert err <= F32_TOL, f"relative Frobenius {err:.2e}"


def _blend_rounded(x, xin, d, *mlp_args, before):
    """K3 from K2's plain output: the blend of ``x + mlp`` in f32, rounded
    once after it (before=False, the kernel's epilogue) or with ``x +
    mlp`` rounded to bf16 before the blend as well (before=True)."""
    s = tmlp._residual_sum32(x, *mlp_args, eps=EPS)
    if before:
        s = s.to(x.dtype).float()
    return (d[1] * s + d[0] * xin.float()).to(x.dtype)


def test_k3_epilogue_rounds_once_after_the_blend():
    """With a soft distribution, one bf16 rounding after the blend (the
    epilogue's, and the plain version's order) gives the plain version's
    bits and rounding ``x + mlp`` before the blend gives others; a hard
    (0, 1) returns K2's output ``x + mlp`` and (1, 0) returns xin, both bit
    for bit."""
    ts = as_torch(blend_inputs(82, 1, 17, D_SOFT), torch.bfloat16)
    x, xin, d, *mlp_args = ts
    got = tmlp.mlp_ln_blend_plain(*ts, eps=EPS)
    assert torch.equal(got, _blend_rounded(x, xin, d, *mlp_args,
                                           before=False))
    assert not torch.equal(got, _blend_rounded(x, xin, d, *mlp_args,
                                               before=True))
    keep = tmlp.mlp_ln_blend_plain(x, xin, torch.tensor(D_KEEP), *mlp_args,
                                   eps=EPS)
    assert torch.equal(keep, tmlp.mlp_ln_plain(x, *mlp_args, eps=EPS))
    skip = tmlp.mlp_ln_blend_plain(x, xin, torch.tensor(D_SKIP), *mlp_args,
                                   eps=EPS)
    assert torch.equal(skip, xin)


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: it carries shapes and
    types to the kernel route without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))


def test_k3_wrapper_sends_vit_h_widths_to_its_library(monkeypatch):
    """At dm 1280 and F 5120 ``mlp_ln_blend`` passes its checks and asks
    for the ``mlp`` library (none here: no card, no nvcc); its counter
    stays at 0 because nothing was launched."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError("no CUDA kernels here")

    monkeypatch.setattr(_cuda, "library", no_library)
    f32 = torch.float32
    ops = (_fake(32, 257, DM), _fake(32, 257, DM), _fake(2, dtype=f32),
           _fake(DM, dtype=f32), _fake(DM, dtype=f32), _fake(DM, F_HIDDEN),
           _fake(F_HIDDEN), _fake(F_HIDDEN, DM), _fake(DM), _fake(F_HIDDEN))
    tops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        tmlp.mlp_ln_blend(*ops, eps=EPS)
    assert asked == ["mlp"]
    assert tops.launch_counts()["mlp_ln_blend"] == 0
