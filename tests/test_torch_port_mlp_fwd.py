"""K2, the MLP sublayer's forward (uvc_tpu_torch/csrc/mlp.cu::uvc_mlp_ln on
the TMA / wgmma GEMM of csrc/gemm_wg.cuh), against the JAX package on the
CPU at ViT-H/14's widths (dm 1280, F 5120) and a few rows.

No card here, so the kernel's function is held through its plain version
``mlp_ln_plain``, which rounds where the kernel's epilogues round: the
LayerNorm output once, the hidden layer once after bias, GELU and mask
(``gemm_wg_kernel<EPI_GELU_MASK>``), the output once after the residual
sum (``<EPI_RESID>``).  Against ``_call_mlp_fwd(..., interpret=True)`` in
bf16 the two differ by the f32 summation order and by GELU (the Pallas
body's Abramowitz-Stegun erf, |err| < 1.5e-7, against the exact erf), one-
ulp bf16 flips -> 1e-2 relative Frobenius; against the JAX CPU
composition in f32, where every rounding is the identity -> 1e-5.  Then
the epilogue's rounding order itself, and the wrapper's route and checks
on operands that report a CUDA device.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import mlp as tmlp
from uvc_tpu_torch.ops.attention import _ln_rows

BF16_TOL = 1e-2
F32_TOL = 1e-5
EPS = 1e-6
# ViT-H/14's MLP widths (uvc_tpu/configs.py ViT-H_14: dm 1280, F 5120)
DM, F_HIDDEN = 1280, 5120
ORDER = ("x", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2", "mask")
F32_KEYS = ("g2", "b2")


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def mlp_inputs(seed, b, n, dm=DM, f=F_HIDDEN, mask=None):
    """K2's operands as f32 numpy arrays, in ``ORDER``: a keep mask over
    the hidden units (70% kept) unless ``mask`` is given."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        g2=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b2=(0.1 * rng.standard_normal(dm)).astype(f32),
        wfc1=(rng.standard_normal((dm, f)) / np.sqrt(dm)).astype(f32),
        bfc1=(0.1 * rng.standard_normal(f)).astype(f32),
        wfc2=(rng.standard_normal((f, dm)) / np.sqrt(f)).astype(f32),
        bfc2=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=(rng.random(f) > 0.3).astype(f32) if mask is None else mask)


def as_torch(inp, dtype):
    return [torch.from_numpy(inp[k]).to(torch.float32 if k in F32_KEYS
                                        else dtype) for k in ORDER]


def as_jax(inp, dtype):
    return [jnp.asarray(inp[k]).astype(jnp.float32 if k in F32_KEYS
                                       else dtype) for k in ORDER]


@pytest.mark.parametrize("b,n", [(1, 17), (2, 9)])
def test_k2_plain_matches_pallas_at_vit_h_widths_bf16(b, n):
    inp = mlp_inputs(70 + n, b, n)
    got = tmlp.mlp_ln_plain(*as_torch(inp, torch.bfloat16), eps=EPS)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, DM)
    x, *rest = as_jax(inp, jnp.bfloat16)
    rows = -(-n // 16) * 16
    x = jnp.pad(x, ((0, 0), (0, rows - n), (0, 0)))
    ref = jmlp._call_mlp_fwd(x, *rest, EPS, interpret=True)[:, :n]
    err = rel_fro(np_(got), np_(ref))
    assert err <= BF16_TOL, f"relative Frobenius {err:.2e}"


def test_k2_plain_is_the_composition_f32():
    inp = mlp_inputs(71, 1, 17)
    got = tmlp.mlp_ln_plain(*as_torch(inp, torch.float32), eps=EPS)
    ref = jmlp._composed_mlp_ln(*as_jax(inp, jnp.float32), EPS)
    err = rel_fro(np_(got), np_(ref))
    assert err <= F32_TOL, f"relative Frobenius {err:.2e}"


def _one_rounding(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, hidden_rounds):
    """K2 from its operands with the hidden layer rounded as
    ``hidden_rounds`` says: "once" is the kernel's epilogue, bf16 after
    bias, GELU and mask; "twice" rounds the GELU output before the mask
    as well."""
    dt = x.dtype
    x32 = x.float()
    m_in = _ln_rows(x32, g2, b2, EPS)[0].to(dt).float()
    h = m_in @ wfc1.float() + bfc1.float()
    a = F.gelu(h)
    if hidden_rounds == "twice":
        a = a.to(dt).float()
    hidden = (a * mask.float()).to(dt).float()
    return (x32 + (hidden @ wfc2.float() + bfc2.float())).to(dt)


def test_epilogue_rounds_the_hidden_layer_once_after_bias_gelu_and_mask():
    """With a mask of fractional keeps, one bf16 rounding after bias, GELU
    and mask (the kernel's epilogue, and the plain version's order) gives
    the plain version's bits; rounding the GELU output before the mask
    as well gives other bits, so the order is what is held."""
    rng = np.random.default_rng(72)
    mask = rng.choice(np.array([0.0, 0.3, 0.77, 1.0], np.float32), F_HIDDEN)
    ts = as_torch(mlp_inputs(72, 1, 17, mask=mask), torch.bfloat16)
    got = tmlp.mlp_ln_plain(*ts, eps=EPS)
    assert torch.equal(got, _one_rounding(*ts, hidden_rounds="once"))
    assert not torch.equal(got, _one_rounding(*ts, hidden_rounds="twice"))


def test_a_masked_unit_leaves_the_output_bit_for_bit():
    """A hidden unit whose mask is 0 is an exact zero after the epilogue:
    whatever its row of W2 holds, the output keeps its bits."""
    inp = mlp_inputs(73, 1, 17)
    off = np.flatnonzero(inp["mask"] == 0)[:64]
    assert off.size == 64
    before = tmlp.mlp_ln_plain(*as_torch(inp, torch.bfloat16), eps=EPS)
    inp["wfc2"] = inp["wfc2"].copy()
    inp["wfc2"][off] = 100.0 * np.random.default_rng(74).standard_normal(
        (off.size, DM)).astype(np.float32)
    after = tmlp.mlp_ln_plain(*as_torch(inp, torch.bfloat16), eps=EPS)
    assert torch.equal(before, after)


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: it carries shapes and
    types to the kernel route without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))


def _fake_mlp(b, n, dm, f):
    f32 = torch.float32
    return dict(x=_fake(b, n, dm), g2=_fake(dm, dtype=f32),
                b2=_fake(dm, dtype=f32), wfc1=_fake(dm, f), bfc1=_fake(f),
                wfc2=_fake(f, dm), bfc2=_fake(dm), mask=_fake(f))


def test_k2_wrapper_sends_vit_h_widths_to_its_library(monkeypatch):
    """At dm 1280 and F 5120 ``mlp_ln`` passes its checks and asks for the
    ``mlp`` library (none here: no card, no nvcc); its counter stays at 0
    because nothing was launched."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError("no CUDA kernels here")

    monkeypatch.setattr(_cuda, "library", no_library)
    # fake CUDA operands are meta tensors to the dispatcher: hand them to
    # the operator's CUDA implementation directly
    monkeypatch.setattr(tmlp, "mlp_ln_op", tmlp._mlp_ln_cuda)
    tops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        tmlp.mlp_ln(*_fake_mlp(32, 257, DM, F_HIDDEN).values(), eps=EPS)
    assert asked == ["mlp"]
    assert tops.launch_counts()["mlp_ln"] == 0


@pytest.mark.parametrize("dm,f,ok", [
    (DM, F_HIDDEN, True), (384, 1536, True), (384, 768, True),
    (DM, F_HIDDEN + 4, False), (DM, 1540, False), (DM + 4, F_HIDDEN, False)])
def test_check_mlp_takes_widths_that_are_multiples_of_8(dm, f, ok):
    """The GEMM reads 16-byte rows (TMA boxes of the operands): dm and F
    must be multiples of 8; F = 5124 is refused before any launch."""
    named = _fake_mlp(2, 13, dm, f)
    x = named.pop("x")
    if ok:
        assert tmlp._check_mlp(x, None, None, named) == (2, 13, dm, f)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            tmlp._check_mlp(x, None, None, named)
