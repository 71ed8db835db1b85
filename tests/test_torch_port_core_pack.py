"""The core backward's pack (A9's and A8's backward,
uvc_tpu_torch/csrc/attention_core_bwd.cuh::pack_heads_kernel): operands
that do not allow 16-byte copies (the Dense variant's head dims 41 and 74,
head views on 2- or 4-byte strides) are copied into zero-padded
``[B, H, N, DHP]`` scratch and read from there.

No card here, so the pack is held as a function: the plain backward on
heads zero-padded to DHP and sliced back is the plain backward on the
unpadded heads (f32, 1e-6 relative; the padded columns of every gradient
exactly 0), and both hold against ``_bwd_kernel`` through
``fused_attention(..., interpret=True)`` in bf16 (1e-2 relative
Frobenius, f32 summation order), whose wrapper pads the head dim too.
Then the wrappers' scratch on operands that report a CUDA device, handed
to a library that records the call.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uvc_tpu.ops.attention import fused_attention as j_fused_attention
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import attention as tatt

BF16_TOL = 1e-2
PAD_TOL = 1e-6
# the Dense variant's head dims: odd (1-element copies) and even but not a
# multiple of 8 (4-byte copies), each with its padded width
DENSE_DIMS = {41: 48, 74: 80}


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def heads(shape, seed, dtype):
    """q, k, v, do [B, H, N, dh] in ``dtype``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def padded_bwd(ops, dhp, scale):
    """The plain backward on the operands zero-padded to ``dhp`` columns
    (what the kernel reads after the pack): (gradients sliced back to dh,
    the padded columns)."""
    dh = ops[0].shape[-1]
    grads = tatt.attention_bwd_plain(*(F.pad(t, (0, dhp - dh)) for t in ops),
                                     scale)
    return [g[..., :dh] for g in grads], [g[..., dh:] for g in grads]


@pytest.mark.parametrize("dh", sorted(DENSE_DIMS))
def test_pack_is_an_identity_of_the_backward_f32(dh):
    ops = heads((2, 3, 13, dh), 90 + dh, torch.float32)
    scale = dh ** -0.5
    sliced, pads = padded_bwd(ops, DENSE_DIMS[dh], scale)
    for got, ref, pad, what in zip(sliced,
                                   tatt.attention_bwd_plain(*ops, scale),
                                   pads, ("dq", "dk", "dv")):
        assert rel_fro(np_(got), np_(ref)) <= PAD_TOL, what
        assert not pad.any(), what


@pytest.mark.parametrize("dh", sorted(DENSE_DIMS))
def test_packed_and_unpacked_backward_match_pallas_bf16(dh):
    ops = heads((1, 2, 10, dh), 95 + dh, torch.bfloat16)
    scale = dh ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in ops)
    _, vjp = jax.vjp(
        lambda q, k, v: j_fused_attention(q, k, v, scale, interpret=True),
        jq, jk, jv)
    refs = vjp(jdo)
    sliced, _ = padded_bwd(ops, DENSE_DIMS[dh], scale)
    for grads in (sliced, tatt.attention_bwd_plain(*ops, scale)):
        for g, r, what in zip(grads, refs, ("dq", "dk", "dv")):
            assert g.dtype == torch.bfloat16
            assert rel_fro(np_(g), np_(r)) <= BF16_TOL, what


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: it carries shapes,
    strides and offsets to the kernel route without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))


B, H, N = 2, 8, 197


def _operands(layout, dh):
    """q, k, v, do [B, H, N, dh] as the callers lay them out: contiguous
    heads; the models' head views of one [B, N, 3, H, dh] projection with
    do laid out [B, N, H, dh]; or chip_smoke.py's head views of one buffer
    two elements in (4-byte strides and base at most)."""
    if layout == "contiguous":
        return [_fake(B, H, N, dh) for _ in range(4)]
    if layout == "qkv_views":
        qkv = _fake(B, N, 3, H, dh)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)] + [
            _fake(B, N, H, dh).transpose(1, 2)]
    packed = _fake(B, N, 4 * H * dh + 2)[..., 2:].view(B, N, 4, H, dh)
    return [packed[:, :, i].transpose(1, 2) for i in range(4)]


class _RecordingLibrary:
    """The core library's entry points, recording their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    """The core wrappers on fake CUDA operands: the library records its
    calls, the outputs and scratch are meta tensors whose shapes are
    recorded, and the device and stream are stand-ins."""
    lib, shapes = _RecordingLibrary(), []

    def empty(shape, dtype, device):
        shapes.append(tuple(shape))
        return torch.Tensor._make_subclass(
            _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))

    monkeypatch.setattr(_cuda, "library", lambda name: lib)
    monkeypatch.setattr(tatt, "_empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    yield lib, shapes
    tops.reset_launch_counts()


@pytest.mark.parametrize("ctx", [False, True], ids=["A9", "A8"])
@pytest.mark.parametrize("layout,dh,dhp", [
    ("contiguous", 41, 48), ("qkv_views", 41, 48), ("contiguous", 74, 80),
    ("qkv_views", 74, 80), ("offset_views", 64, 64),
    ("contiguous", 64, None), ("qkv_views", 64, None),
    ("contiguous", 24, None)])
def test_backward_wrappers_size_the_pack_scratch(recorded, layout, dh, dhp,
                                                 ctx):
    """The pack scratch is [4, B, H, N, DHP] exactly where an operand does
    not allow 16-byte copies (an odd head dim, a head dim or strides that
    are not multiples of 8, a base off 16 bytes) and is not allocated
    (a null pointer) where every one does; one launch is counted."""
    lib, shapes = recorded
    ops = _operands(layout, dh)
    if ctx:
        tatt.attention_bwd_ctx(*ops, 0.125)
    else:
        tatt.attention_bwd(*ops, 0.125)
    (name, args), = lib.calls
    assert name == ("uvc_attention_bwd_ctx" if ctx else "uvc_attention_bwd")
    packs = [s for s in shapes if len(s) == 5]
    if dhp is None:
        assert packs == [] and args[5] is None
    else:
        assert packs == [(4, B, H, N, dhp)] and args[5] is not None
    counter = "attention_bwd_ctx" if ctx else "attention_bwd"
    assert tops.backward_launch_counts().get(
        counter, tops.launch_counts().get(counter)) == 1


def test_backward_wrappers_refuse_what_the_kernels_cannot_take(recorded):
    """Past the pack, the wrappers still refuse what no kernel takes, before
    any call: a head dim past 80, another dtype, operands of other
    shapes, a non-unit stride along the head dim."""
    lib, _ = recorded
    ok = _operands("qkv_views", 41)
    bad = {"head dims 1..80": [_fake(B, H, N, 96) for _ in range(4)],
           "must be torch.bfloat16": ok[:3] + [_fake(B, H, N, 41,
                                                     dtype=torch.float32)],
           "as q": ok[:3] + [_fake(B, H, N - 1, 41)],
           "unit stride": ok[:3] + [_fake(B, H, 41, N).transpose(2, 3)]}
    for match, ops in bad.items():
        for fn in (tatt.attention_bwd, tatt.attention_bwd_ctx):
            with pytest.raises(ValueError, match=match):
                fn(*ops, 0.125)
    assert lib.calls == []
