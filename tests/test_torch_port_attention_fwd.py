"""The streamed forward of the port's attention core
(uvc_tpu_torch/csrc/attention_core_fwd.cuh: A9's forward and K1's
attention step) against the JAX package on the CPU.

No card here, so ``tiled_attention_fwd`` replays the kernel's order in
PyTorch: base-2 logits (q . k^T) * (scale * log2 e) in f32, one pass over
64-key tiles with the running max, the running sum of the unrounded p and
the context accumulator rescaled by 2^(old max - new max) when a tile
raises the max, bf16(p) rounded against the running max, the
normalisation after P . V, and K1's mask epilogue bf16(bf16(ctx) * mask).
It is held against ``attention_plain`` (the Pallas order: the final max
first) and ``_call_fwd(..., interpret=True)`` in bf16: the two orders
differ in f32 only, which now and then flips a bf16 rounding of p or of
the output -> 1e-2 relative Frobenius; and against ``attention_plain`` in
f32, where every rounding is the identity -> 1e-5.  K1's and A7's
sublayers with this core in place of ``attention_plain`` are held against
``_call_layer_ln_fwd`` / ``_fused_layer(..., interpret=True)`` at 1e-2.
The wrappers' checks: A9's forward, K1 and A7's forward all run this core
and take any N, K1 with the gradient recorded too (A2, K1's backward,
streams its core as well).
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import attention as jattn
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import attention as tatt

BF16_TOL = 1e-2
F32_TOL = 1e-5
EPS = 1e-6
# (B, H, N, dh): the resnext head dim 12 over three key tiles, the Dense
# variant's odd 41, DeiT's 64 and ViT-H's 80 at their N (a one-row last
# tile at 257), one ragged tile, and N = 700 at dh 80, past the staged
# core's 624
SHAPES = {"dh12": (2, 3, 130, 12), "dh41": (1, 2, 150, 41),
          "dh64": (1, 2, 197, 64), "dh80": (1, 2, 257, 80),
          "ragged": (2, 1, 50, 24), "long": (1, 1, 700, 80)}


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tiled_attention_fwd(q, k, v, scale, mask=None, tile=64):
    """The card kernel's order of the core forward
    (csrc/attention_core_fwd.cuh) in PyTorch, for [B, H, N, dh] operands;
    ``mask`` ([H * dh], K1's) multiplies the rounded context per column.
    Returns ctx in the input's dtype."""
    dt = q.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    n = q.shape[2]
    logits = (q32 @ k32.transpose(-1, -2)) * (scale * math.log2(math.e))
    m = torch.full((*q.shape[:3], 1), -torch.inf)
    s = torch.zeros_like(m)
    acc = torch.zeros_like(q32)
    for j in range(0, n, tile):
        cols = slice(j, min(j + tile, n))
        new = torch.maximum(m, logits[..., cols].amax(-1, keepdim=True))
        alpha = torch.exp2(m - new)
        p = torch.exp2(logits[..., cols] - new)
        s = s * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ v32[..., cols, :]
        m = new
    ctx = acc / s
    if mask is not None:
        b, h, _, dh = q.shape
        ctx = ctx.to(dt).float() * mask.to(dt).float().view(h, 1, dh)
    return ctx.to(dt)


def core_inputs(shape, seed, dtype):
    """q, k, v in ``dtype`` with key norms growing along N (up to 3x), so
    that later key tiles raise the running max and the rescale is taken;
    and the same values as JAX arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    k = k * torch.linspace(1.0, 3.0, shape[2])[:, None]
    ts = [t.to(dtype) for t in (q, k, v)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tiled_order_matches_plain_and_pallas_bf16(shape):
    b, h, n, dh = SHAPES[shape]
    (q, k, v), jin = core_inputs((b, h, n, dh), 1, torch.bfloat16)
    scale = dh ** -0.5
    got = tiled_attention_fwd(q, k, v, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, dh)
    err = rel_fro(np_(got), np_(tatt.attention_plain(q, k, v, scale)))
    assert err <= BF16_TOL, f"vs attention_plain: {err:.2e}"
    np_rows = -(-n // 16) * 16
    pad = ((0, 0), (0, 0), (0, np_rows - n), (0, 0))
    ref = jattn._call_fwd(*(jnp.pad(t, pad) for t in jin), scale, n,
                          interpret=True)
    err = rel_fro(np_(got), np_(ref[:, :, :n]))
    assert err <= BF16_TOL, f"vs _call_fwd: {err:.2e}"


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tiled_order_is_the_plain_function_f32(shape):
    b, h, n, dh = SHAPES[shape]
    (q, k, v), _ = core_inputs((b, h, n, dh), 2, torch.float32)
    scale = 0.7 * dh ** -0.5
    err = rel_fro(np_(tiled_attention_fwd(q, k, v, scale)),
                  np_(tatt.attention_plain(q, k, v, scale)))
    assert err <= F32_TOL


def test_tiled_order_rescales_and_masks():
    """The inputs take the rescale (a later tile raises the running max
    of most rows), and the mask epilogue zeroes the masked columns and
    rounds the rest twice, as the kernel does."""
    (q, k, v), _ = core_inputs((1, 2, 200, 16), 3, torch.float32)
    logits = q @ k.transpose(-1, -2)
    first = logits[..., :64].amax(-1)
    assert (logits[..., 64:].amax(-1) > first).float().mean() > 0.5
    mask = torch.ones(32)
    mask[::3] = 0.0
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = tiled_attention_fwd(qb, kb, vb, 0.25, mask=mask)
    plain = tiled_attention_fwd(qb, kb, vb, 0.25)
    want = (plain.float() * mask.view(2, 1, 16)).to(torch.bfloat16)
    assert torch.equal(got, want)


# (kernel, B, N, dm, heads, dh): K1 and A7's forward at the resnext head
# dim 12 and at ViT-H's 80, N over two and three key tiles; A7 also at
# N = 700 (past the 624 keys that its staged core once held at head dim
# 80) and at a compacted width, da = 32 < dm = 64
SUBLAYER_CASES = [
    pytest.param("k1", 2, 70, 48, 4, 12, id="2-70-48-4-12"),
    pytest.param("k1", 1, 130, 160, 2, 80, id="1-130-160-2-80"),
    pytest.param("a7", 2, 70, 48, 4, 12, id="a7-dh12"),
    pytest.param("a7", 1, 130, 160, 2, 80, id="a7-dh80"),
    pytest.param("a7", 1, 700, 160, 2, 80, id="a7-n700"),
    pytest.param("a7", 2, 45, 64, 2, 16, id="a7-compact")]
LN_ORDER = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "mask")


def sublayer_args(seed, b, n, dm, da):
    """(torch bf16 tensors, JAX bf16 arrays) of K1's operands, the
    LayerNorm parameters in f32 (A7 takes them without g1 and b1); x grows
    along N so that the keys do."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    inp = dict(
        x=rng.standard_normal((b, n, dm)).astype(f32)
        * np.linspace(1.0, 2.0, n, dtype=f32)[:, None],
        g1=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b1=(0.1 * rng.standard_normal(dm)).astype(f32),
        wqkv=(2 * rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32), mask=mask)
    f32_keys = ("g1", "b1")
    ts = [torch.from_numpy(inp[k]).to(torch.float32 if k in f32_keys
                                      else torch.bfloat16) for k in LN_ORDER]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.float32 if k in f32_keys else jnp.bfloat16)
        for k, t in zip(LN_ORDER, ts)]
    return ts, js


@pytest.mark.parametrize("kind,b,n,dm,heads,dh", SUBLAYER_CASES)
def test_sublayer_with_the_tiled_core_matches_pallas_bf16(
        monkeypatch, kind, b, n, dm, heads, dh):
    """K1 (``layer_attention_ln_plain``) and A7's forward
    (``layer_attention_plain``) in ``_sublayer_plain``'s order with the
    tiled core in place of ``attention_plain`` (the kernels' order end to
    end but for the GEMMs' summation order) against
    ``_call_layer_ln_fwd`` / ``_fused_layer(..., interpret=True)`` on rows
    padded to 16."""
    calls = []

    def tiled(q, k, v, scale):
        calls.append(q.shape)
        return tiled_attention_fwd(q, k, v, scale)

    monkeypatch.setattr(tatt, "attention_plain", tiled)
    ts, js = sublayer_args(60 + dh, b, n, dm, heads * dh)
    scale = dh ** -0.5
    np_rows = -(-n // 16) * 16
    x = jnp.pad(js[0], ((0, 0), (0, np_rows - n), (0, 0)))
    if kind == "k1":
        got = tatt.layer_attention_ln_plain(*ts, num_heads=heads,
                                            scale=scale, eps=EPS)
        ref = jattn._call_layer_ln_fwd(x, *js[1:], scale, n, heads, EPS,
                                       interpret=True)[:, :n]
    else:
        got = tatt.layer_attention_plain(ts[0], *ts[3:], num_heads=heads,
                                         scale=scale)
        ref = jattn._fused_layer(x, *js[3:], scale, n, heads,
                                 True)[:, :n]
    assert calls == [(b, heads, n, dh)]
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, dm)
    err = rel_fro(np_(got), np_(ref))
    assert err <= BF16_TOL, f"relative Frobenius {err:.2e}"


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device: it carries shapes and
    types to the kernel route without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.empty(shape, dtype=dtype, device="meta"))


def _sublayer_named(b, n, dm, heads, dh):
    da = heads * dh
    return dict(x=_fake(b, n, dm), g1=_fake(dm, dtype=torch.float32),
                b1=_fake(dm, dtype=torch.float32), wqkv=_fake(dm, 3 * da),
                bqkv=_fake(3 * da), wproj=_fake(da, dm), bproj=_fake(dm),
                mask=_fake(da))


def test_streamed_forward_shared_memory_does_not_depend_on_n():
    """The streamed forward, the one forward core of A9, K1 and A7, holds
    a query tile and two stages of K and V tiles: 52248 bytes at head dim
    80 whatever N is, so four CTAs fit an SM's 228 KB (1 KB reserved per
    CTA)."""
    assert tatt._core_fwd_smem_bytes(80) == 52248
    assert 4 * (tatt._core_fwd_smem_bytes(80) + 1024) <= 228 * 1024
    assert all(tatt._core_fwd_smem_bytes(dh) <= 52248 for dh in range(1, 81))


@pytest.mark.parametrize("n", [625, 700, 4096])
def test_checks_take_n_past_the_staged_limit_for_a9_and_k1(n):
    """A9's forward, K1 and A7's forward take N past the 624 that the
    staged core once held at head dim 80."""
    q = _fake(1, 2, n, 80)
    assert tatt._check_core(dict(q=q, k=q, v=q), backward=False) == \
        (1, 2, n, 80)
    named = _sublayer_named(1, n, 160, 2, 80)
    assert tatt._check_attention(named["x"], named, 2) == (1, n, 160, 160)
    bare = {k: t for k, t in named.items() if k not in ("g1", "b1")}
    assert tatt._check_attention(bare["x"], bare, 2) == (1, n, 160, 160)


def test_wrappers_send_long_sequences_to_the_kernels(monkeypatch):
    """At N = 700 and head dim 80, ``attention``, ``layer_attention_ln``
    and ``layer_attention`` pass their checks and ask for their libraries
    (none here: no card, no nvcc)."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError("no CUDA kernels here")

    monkeypatch.setattr(_cuda, "library", no_library)
    # fake CUDA operands are meta tensors to the dispatcher: hand them to
    # the operator's CUDA implementation directly
    monkeypatch.setattr(tatt, "layer_attention_ln_op",
                        tatt._layer_attention_ln_cuda)
    tops.reset_launch_counts()
    q = _fake(1, 2, 700, 80)
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        tatt.attention(q, q, q, 0.1)
    named = _sublayer_named(1, 700, 160, 2, 80)
    kw = dict(num_heads=2, scale=0.1)
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        tatt.layer_attention_ln(*named.values(), eps=EPS, **kw)
    bare = [t for k, t in named.items() if k not in ("g1", "b1")]
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        tatt.layer_attention(*bare, **kw)
    assert asked == ["attention_core", "attention", "attention"]
    assert tops.launch_counts()["attention"] == 0
    assert tops.launch_counts()["layer_attention_ln"] == 0
    assert tops.launch_counts()["layer_attention"] == 0


@pytest.mark.parametrize("n", [561, 700, 4096])
def test_k1_with_its_gradient_checks_the_backward_limit(monkeypatch, n):
    """K1 takes any N and, its backward (A2, at dm <= 1280) streaming its
    core as well, so does ``fused_layer_attention_ln`` with the gradient
    recorded: N past the 560 that A2's old staged core held at head dim 80
    reaches the forward's library (none here) and is refused nowhere
    before it."""
    monkeypatch.setattr(_cuda, "library", lambda name: (_ for _ in ()).throw(
        RuntimeError("no CUDA kernels here")))
    monkeypatch.setattr(tatt, "layer_attention_ln_op",
                        tatt._layer_attention_ln_cuda)
    named = _sublayer_named(1, n, 160, 2, 80)
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="no CUDA kernels"):
        tatt.fused_layer_attention_ln(*named.values(), num_heads=2,
                                      scale=0.1, eps=EPS)
