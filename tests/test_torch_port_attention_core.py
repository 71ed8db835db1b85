"""The port's attention core (uvc_tpu_torch/ops/attention.py: kernel A9's
plain versions, its wrappers and ``fused_attention``) against the JAX
package on the CPU.

In bf16 the plain versions follow the Pallas bodies' rounding order
(``_fwd_kernel`` / ``_bwd_kernel``: bf16 operands, f32 logits and softmax,
the normalisation after P @ V, probs and ds rounded to bf16), so they are
held to ``fused_attention(..., interpret=True)`` and ``jax.vjp`` of it at
1e-2 relative Frobenius per output: the two differ only in f32 summation
order, which now and then flips a bf16 rounding.  In f32 every rounding is
the identity and the functions are JAX's CPU route,
``reference_attention`` and its ``jax.vjp``, up to where the normalisation
sits: 1e-5 relative.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops.attention import fused_attention as j_fused_attention
from uvc_tpu.ops.attention import reference_attention
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import attention as tatt

BF16_TOL = 1e-2
F32_TOL = 1e-5
# (B, H, N, dh): the kernel tests' shape, an N that is not a multiple of 8,
# odd head dims (the Dense variant's 41 among them), B = H = 1
SHAPES = {"base": (2, 2, 12, 8), "ragged_n": (2, 3, 13, 16),
          "odd_dh": (1, 2, 10, 41), "odd_small": (2, 1, 9, 5),
          "single": (1, 1, 7, 24)}


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def inputs(shape, seed, dtype):
    """q, k, v, do as (torch, jax) pairs holding the same values in
    ``dtype`` (bf16 values are made in torch and carried over exactly)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dtype)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        out.append((t, jnp.asarray(t.float().numpy()).astype(jdt)))
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_pallas_interpret_bf16(name):
    shape = SHAPES[name]
    scale = shape[-1] ** -0.5
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = inputs(shape, 1,
                                                      torch.bfloat16)
    ref, vjp = jax.vjp(
        lambda q, k, v: j_fused_attention(q, k, v, scale, interpret=True),
        jq, jk, jv)
    out = tatt.attention_plain(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16 and out.shape == shape
    assert rel_fro(np_(out), np_(ref)) <= BF16_TOL
    grads = tatt.attention_bwd_plain(tq, tk, tv, tdo, scale)
    for g, r, what in zip(grads, vjp(jdo), ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        assert rel_fro(np_(g), np_(r)) <= BF16_TOL, what


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_reference_f32(name):
    shape = SHAPES[name]
    scale = 0.7 * shape[-1] ** -0.5
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = inputs(shape, 2,
                                                      torch.float32)
    ref, vjp = jax.vjp(lambda q, k, v: reference_attention(q, k, v, scale),
                       jq, jk, jv)
    out = tatt.attention_plain(tq, tk, tv, scale)
    assert out.dtype == torch.float32
    assert rel_fro(np_(out), np_(ref)) <= F32_TOL
    grads = tatt.attention_bwd_plain(tq, tk, tv, tdo, scale)
    for g, r, what in zip(grads, vjp(jdo), ("dq", "dk", "dv")):
        assert rel_fro(np_(g), np_(r)) <= F32_TOL, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["ragged_n", "odd_dh"])
def test_fused_attention_autograd_is_the_backward(name, dtype):
    """Gradients through ``fused_attention`` (strided head views, as the
    models give them) are ``attention_bwd_plain``'s, bit for bit; its
    forward is ``attention_plain``'s, and ``attention_core`` is the same
    function."""
    shape = SHAPES[name]
    scale = shape[-1] ** -0.5
    (tq, _), (tk, _), (tv, _), (tdo, _) = inputs(shape, 3, dtype)
    # the model's layout: heads split out of one [B, N, H * dh] projection
    leaves = [t.transpose(1, 2).contiguous().transpose(1, 2)
              .requires_grad_() for t in (tq, tk, tv)]
    assert not leaves[0].is_contiguous()
    out = tatt.fused_attention(*leaves, scale)
    assert torch.equal(out, tatt.attention_plain(tq, tk, tv, scale))
    grads = torch.autograd.grad(out, leaves, tdo)
    for g, r in zip(grads, tatt.attention_bwd_plain(tq, tk, tv, tdo, scale)):
        assert torch.equal(g, r)
    assert torch.equal(tatt.attention_core(tq, tk, tv, scale), out.detach())
    with torch.no_grad():
        assert torch.equal(tatt.fused_attention(tq, tk, tv, scale),
                           out.detach())


def test_cpu_calls_leave_the_counters_at_zero_and_build_nothing():
    tops.reset_launch_counts()
    (tq, _), (tk, _), (tv, _), _ = inputs(SHAPES["base"], 4, torch.bfloat16)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    tatt.fused_attention(*leaves, 0.3).float().sum().backward()
    assert tops.launch_counts()["attention"] == 0
    assert tops.backward_launch_counts()["attention_bwd"] == 0
    assert "attention_core" not in _cuda._loaded


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: it carries shapes and
    types to the kernel route without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))


@pytest.mark.parametrize("backward", [False, True])
def test_cuda_tensors_go_to_the_kernel_or_raise(monkeypatch, backward):
    """A CUDA tensor never takes the plain version: the wrapper asks for
    the kernel library (here there is none: no card, no nvcc) and
    raises."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError("no CUDA kernels here")

    monkeypatch.setattr(_cuda, "library", no_library)
    ops = [_fake(2, 6, 197, 64) for _ in range(4)]
    tops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        if backward:
            tatt.attention_bwd(*ops, 0.125)
        else:
            tatt.attention(*ops[:3], 0.125)
    assert asked == ["attention_core"]
    assert tops.launch_counts()["attention"] == 0
    assert tops.backward_launch_counts()["attention_bwd"] == 0


def test_kernel_checks_refuse_what_the_kernels_cannot_take():
    """bf16 only, one shape for all operands, head dims 1..80: anything
    else is refused before a launch.  Forward and backward stream tiles,
    so their shared memory does not grow with N: an N past the 624 that
    the staged forward core once held at head dim 80, and past the old
    backward's 560, is taken both ways; the forward's shared memory at
    head dim 80 fits a CTA's."""
    ok = dict(q=_fake(2, 8, 197, 41), k=_fake(2, 8, 197, 41),
              v=_fake(2, 8, 197, 41))
    assert tatt._check_core(ok, backward=False) == (2, 8, 197, 41)
    for dh in (64, 74, 80):
        q = _fake(64, 6, 197, dh)
        assert tatt._check_core(dict(q=q, k=q, v=q, do=q),
                                backward=True) == (64, 6, 197, dh)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        tatt._check_core(dict(ok, v=_fake(2, 8, 197, 41,
                                          dtype=torch.float32)), False)
    with pytest.raises(ValueError, match="as q"):
        tatt._check_core(dict(ok, k=_fake(2, 8, 196, 41)), False)
    with pytest.raises(ValueError, match="head dims 1..80"):
        q = _fake(2, 2, 16, 96)
        tatt._check_core(dict(q=q, k=q, v=q), False)
    assert tatt._core_fwd_smem_bytes(80) <= tatt._SMEM_LIMIT
    for n in (600, 625, 4096):
        q = _fake(1, 1, n, 80)
        assert tatt._check_core(dict(q=q, k=q, v=q), False) == \
            (1, 1, n, 80)
        assert tatt._check_core(dict(q=q, k=q, v=q, do=q), True) == \
            (1, 1, n, 80)


def test_kernels_take_head_views_as_they_lie():
    """Head views of one packed projection reach the kernels at their own
    strides, with no copy; only a non-unit stride along dh is refused.
    Outputs are laid out [B, N, H, dh], so the models' merge of the heads
    is a view."""
    b, n, h, dh = 2, 197, 6, 64
    qkv = _fake(b, n, 3, h, dh)
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    assert not views[0].is_contiguous()
    assert tatt._check_core(dict(q=views[0], k=views[1], v=views[2]),
                            backward=False) == (b, h, n, dh)
    assert list(tatt._strides(*views)) == [n * 3 * h * dh, dh,
                                           3 * h * dh] * 3
    bad = _fake(b, h, dh, n).transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        tatt._check_core(dict(q=views[0], k=views[1], v=bad), False)
    out = tatt._head_major(torch.empty(b, h, n, dh))
    assert out.shape == (b, h, n, dh)
    merged = out.transpose(1, 2).reshape(b, n, h * dh)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()


def test_wrappers_refuse_other_devices():
    q = torch.empty(2, 2, 12, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tatt.attention(q, q, q, 0.5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tatt.attention_bwd(q, q, q, q, 0.5)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            with pytest.raises(ValueError, match="cpu or cuda"):
                tatt.attention_core(q, q, q, 0.5)


def test_entry_points_are_bound_and_registered():
    assert set(_cuda._LIBS["attention_core"][1]) == {
        "uvc_attention", "uvc_attention_bwd", "uvc_attention_bwd_ctx"}
    assert tops.KERNEL_WRAPPERS["attention"] is tatt.attention
    assert tops.BACKWARD_KERNEL_WRAPPERS["attention_bwd"] is \
        tatt.attention_bwd
