"""The sublayer backward kernels A2 (``layer_attention_ln_bwd``) and A7's
backward (``layer_attention_bwd``) in the card kernels' order, against the
JAX package on the CPU.

On the card both run the five products on the TMA / wgmma GEMM
(``csrc/gemm_wg.cuh``, the weight gradients split over the B*N rows, their
f32 partials added in split order) and the attention step on the streamed
core backward (``csrc/attention_core_bwd.cuh``: base-2 online softmax over
64-key tiles, tile-by-tile sums, and from its second pass
ctxm = bf16(ctx * mask) and dmask's partial sums of t * ctx with ctx in
f32).  ``replay_sublayer_bwd``
below is that order in PyTorch:

* in bf16 against ``_call_layer_ln_bwd`` and ``_call_layer_bwd`` (the
  Pallas kernels) in interpret mode: both round at the same places and sum
  in another order, which now and then flips a bf16 rounding of an
  intermediate (dctx, probs, ds, dqkv) carried into the sums after it ->
  2e-2 relative Frobenius per gradient, the tolerance
  ``tests/test_torch_port_grads.py`` holds these kernels' plain versions to;
* in f32 against the plain versions (``layer_attention_ln_bwd_plain``,
  ``layer_attention_bwd_plain``, the Pallas rounding order): every rounding
  is the identity, so the two are one function summed in another order ->
  1e-5.

N = 130 takes two full key tiles and a 2-row tail; head dims 12
(t2t_vit_14_resnext), 24, 64 and 80 (ViT-H/14's), and one case with an
attention width below the model width (compacted layers).  Besides: the
backward wrappers' scratch (the streamed core's statistics, every row of
every 64-row tile; the split-K partials) and their split counts.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import attention as jattn
from uvc_tpu_torch.ops import attention as tatt

BF16_TOL = 2e-2
F32_TOL = 1e-5
EPS = 1e-6
TILE = 64
SMS = 132            # the H100 SXM's SMs, for the split counts
# (B, N, dm, heads, head dim): da = heads * head dim
CASES = {"dh12": (1, 130, 48, 4, 12), "dh24": (1, 130, 48, 2, 24),
         "dh64": (1, 130, 64, 1, 64), "dh80": (1, 130, 160, 2, 80),
         "da_lt_dm": (2, 130, 64, 2, 24)}
LN_ORDER = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "mask")
BARE_ORDER = ("x", "wqkv", "bqkv", "wproj", "bproj", "mask")
F32_KEYS = ("g1", "b1")


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def inputs(case, seed):
    """numpy f32 inputs; x's rows grow along N (up to 3x), so that in the
    bare sublayer later key tiles raise the running max."""
    b, n, dm, heads, dh = CASES[case]
    da = heads * dh
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    x = rng.standard_normal((b, n, dm)) * np.linspace(1.0, 3.0, n)[:, None]
    return dict(
        x=x.astype(f32),
        g1=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b1=(0.1 * rng.standard_normal(dm)).astype(f32),
        wqkv=(rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask,
        do=(0.5 * rng.standard_normal((b, n, dm))).astype(f32))


def as_torch(inp, order, dtype):
    return [torch.from_numpy(inp[k]).to(torch.float32 if k in F32_KEYS
                                        else dtype) for k in order]


def as_jax(inp, order, dtype):
    return [jnp.asarray(inp[k]).astype(jnp.float32 if k in F32_KEYS
                                       else dtype) for k in order]


def assert_close(got, ref, order, tol):
    for name, g, r in zip(order, got, ref):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        assert tuple(g.shape) == r.shape, name
        err = rel_fro(g.float().numpy(), r)
        assert err <= tol, f"d{name}: relative Frobenius {err:.2e} > {tol}"


# ---------------------------------------------------------------------------
# the card kernels' order
# ---------------------------------------------------------------------------


def streamed_core(q, k, v, do, scale):
    """The streamed core backward's order (``core_bwd_q_wg_kernel`` /
    ``core_bwd_kv_wg_kernel``) on [B, H, N, dh]: base-2 logits, (max, s)
    online over 64-key tiles with the running sum rescaled when a tile
    raises the max, probs = 2^(logit - max) * (1 / s); then tile by tile
    row = sum(dp * probs) and ctx = round(probs) . v (kept in f32, the
    sublayer's ctx), ds = round(probs * (dp - row)), dq = ds . k; dk and dv
    over 64-query tiles.  Returns (ctx in f32, dq, dk, dv in q's dtype)."""
    dt = q.dtype
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    n = q.shape[2]
    tiles = [slice(j, min(j + TILE, n)) for j in range(0, n, TILE)]
    logits = (q32 @ k32.transpose(-1, -2)) * (scale * math.log2(math.e))
    m = torch.full((*q.shape[:3], 1), -torch.inf)
    s = torch.zeros_like(m)
    for j in tiles:
        new = torch.maximum(m, logits[..., j].amax(-1, keepdim=True))
        s = s * torch.exp2(m - new) + torch.exp2(logits[..., j] - new).sum(
            -1, keepdim=True)
        m = new
    probs = torch.exp2(logits - m) * (1.0 / s)
    pb = probs.to(dt).float()
    dp = do32 @ v32.transpose(-1, -2)
    row, ctx = torch.zeros_like(m), torch.zeros_like(q32)
    for j in tiles:
        row = row + (dp[..., j] * probs[..., j]).sum(-1, keepdim=True)
        ctx = ctx + pb[..., j] @ v32[..., j, :]
    ds = (probs * (dp - row)).to(dt).float()
    dq, dk, dv = (torch.zeros_like(q32) for _ in range(3))
    for j in tiles:
        dq = dq + ds[..., j] @ k32[..., j, :]
        dk = dk + ds[..., j, :].transpose(-1, -2) @ q32[..., j, :]
        dv = dv + pb[..., j, :].transpose(-1, -2) @ do32[..., j, :]
    return ctx, (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


def split_product(a, b, splits):
    """a^T . b over the rows, as ``weight_grad_wg`` takes it: ``splits``
    chunks of whole 64-row k-tiles, each an f32 partial, added in order."""
    rows = a.shape[0]
    ktiles = -(-rows // TILE)
    per = -(-ktiles // splits) * TILE
    out = torch.zeros(a.shape[1], b.shape[1])
    for r in range(0, rows, per):
        out = out + a[r:r + per].T @ b[r:r + per]
    return out


def replay_sublayer_bwd(a, wqkv, bqkv, wproj, mask, do, heads, scale):
    """``_sublayer_bwd_plain`` in the card's order: the products as the
    Pallas body rounds them, the core in the streamed order, dWqkv and
    dWproj summed over the splits the wrappers choose, ctx kept in f32 for
    dmask and ctxm = round(ctx * mask) for dWproj.  Returns the f32
    ``d a`` and the f32 gradients of (wqkv, bqkv, wproj, bproj, mask)."""
    dt = a.dtype
    b, n, dm = a.shape
    da = wqkv.shape[1] // 3
    dh = da // heads
    rows = b * n
    a32 = a.float().reshape(rows, dm)
    qkv = (a32 @ wqkv.float() + bqkv.float()).to(dt)
    dob = do.to(dt).float().reshape(rows, dm)
    maskv = mask.float()
    t = dob @ wproj.float().T                               # f32
    dctx = (t * maskv).to(dt)
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    ctx, dq, dk, dv = streamed_core(
        q, k, v, dctx.view(b, n, heads, dh).transpose(1, 2), scale)
    ctx = ctx.transpose(1, 2).reshape(rows, da)
    dqkv = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4) \
        .reshape(rows, 3 * da).float()
    ctxm = (ctx * maskv).to(dt).float()
    splits = tatt._weight_grad_splits(dm, 3 * da, rows, SMS), \
        tatt._weight_grad_splits(da, dm, rows, SMS)
    d_in = (dqkv @ wqkv.float().T).reshape(b, n, dm)
    return d_in, (split_product(a32, dqkv, splits[0]), dqkv.sum(0),
                  split_product(ctxm, dob, splits[1]), dob.sum(0),
                  (t * ctx).sum(0))


def replay_ln_bwd(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, do, *,
                  num_heads, scale, eps):
    """A2 in the card's order: ``layer_attention_ln_bwd_plain`` around
    ``replay_sublayer_bwd``."""
    a32, xhat, inv = tatt._ln_rows(x.float(), g1.float(), b1.float(), eps)
    d_in, wgrads = replay_sublayer_bwd(a32.to(x.dtype), wqkv, bqkv, wproj,
                                       mask, do, num_heads, scale)
    dg = d_in * g1.float()
    m1 = dg.mean(dim=-1, keepdim=True)
    m2 = (dg * xhat).mean(dim=-1, keepdim=True)
    dx = ((dg - m1 - xhat * m2) * inv + do.float()).to(x.dtype)
    rows = (0, 1)
    grads = (dx, (d_in * xhat).sum(rows), d_in.sum(rows), *wgrads)
    return tuple(gr.to(ref.dtype) for gr, ref in zip(
        grads, (x, g1, b1, wqkv, bqkv, wproj, bproj, mask)))


def replay_bare_bwd(x, wqkv, bqkv, wproj, bproj, mask, do, *, num_heads,
                    scale):
    """A7's backward in the card's order: ``dx = round(dqkv . Wqkv^T)``."""
    d_in, wgrads = replay_sublayer_bwd(x, wqkv, bqkv, wproj, mask, do,
                                       num_heads, scale)
    return tuple(gr.to(ref.dtype) for gr, ref in zip(
        (d_in, *wgrads), (x, wqkv, bqkv, wproj, bproj, mask)))


def _kw(case, ln):
    _, _, _, heads, dh = CASES[case]
    kw = dict(num_heads=heads, scale=dh ** -0.5)
    return dict(kw, eps=EPS) if ln else kw


def pallas_bwd(case, inp, ln):
    """The Pallas kernel in interpret mode on rows padded to 16 (as its
    custom VJP pads them), one image a grid step; the padded rows sliced
    off, the (1, width) sums taken to vectors."""
    b, n = CASES[case][:2]
    kw = _kw(case, ln)
    pad = ((0, 0), (0, jattn._pad_rows(n) - n), (0, 0))
    order = LN_ORDER if ln else BARE_ORDER
    args = dict(zip(order, as_jax(inp, order, jnp.bfloat16)))
    x = jnp.pad(args["x"], pad)
    do = jnp.pad(jnp.asarray(inp["do"]).astype(jnp.bfloat16), pad)
    if ln:
        out = jattn._call_layer_ln_bwd(
            x, args["g1"], args["b1"], args["wqkv"], args["bqkv"],
            args["wproj"], args["mask"], do, kw["scale"], n, kw["num_heads"],
            EPS, 1, interpret=True)
    else:
        out = jattn._call_layer_bwd(
            x, args["wqkv"], args["bqkv"], args["wproj"], args["mask"], do,
            kw["scale"], n, kw["num_heads"], 1, interpret=True)
    return [out[0][:, :n]] + [o[0] if o.shape[0] == 1 else o
                              for o in out[1:]]


@pytest.mark.parametrize("ln", [True, False], ids=["a2", "a7"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_matches_pallas_interpret_bf16(case, ln):
    inp = inputs(case, 20)
    order = LN_ORDER if ln else BARE_ORDER
    t = as_torch(inp, order + ("do",), torch.bfloat16)
    replay = replay_ln_bwd if ln else replay_bare_bwd
    got = replay(*t, **_kw(case, ln))
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_close(got, pallas_bwd(case, inp, ln), order, BF16_TOL)


@pytest.mark.parametrize("ln", [True, False], ids=["a2", "a7"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_is_the_plain_function_f32(case, ln):
    inp = inputs(case, 21)
    order = LN_ORDER if ln else BARE_ORDER
    t = as_torch(inp, order + ("do",), torch.float32)
    kw = _kw(case, ln)
    if ln:
        got = replay_ln_bwd(*t, **kw)
        ref = tatt.layer_attention_ln_bwd_plain(*t, **kw)
    else:
        got = replay_bare_bwd(*t, **kw)
        ref = tatt.layer_attention_bwd_plain(*t, **kw)
    assert_close(got, [r.numpy() for r in ref], order, F32_TOL)


# ---------------------------------------------------------------------------
# the wrappers' scratch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ln", [True, False], ids=["a2", "a7"])
@pytest.mark.parametrize("b, n, dm, heads, dh", [(64, 197, 384, 6, 64),
                                                 (3, 197, 384, 6, 64),
                                                 (64, 197, 384, 32, 12),
                                                 (8, 257, 640, 8, 80),
                                                 (1, 705, 64, 1, 64)])
def test_backward_wrappers_size_stats_as_the_streamed_core(b, n, dm, heads,
                                                           dh, ln):
    """The scratch of A2 and A7's backward, in their entry points' order:
    the per-query statistics as ``_core_bwd_stats`` sizes them (every row
    of every 64-row tile of every head, not B H N), and a partial buffer
    that holds dmask's partials (one a 64-row query tile of an image), the
    split-K partials of either weight gradient and the per-128-row
    column-sum partials."""
    da = heads * dh
    rows = b * n
    scratch, (sq, sp) = tatt._sublayer_bwd_scratch(b, n, dm, da, heads,
                                                   "meta", SMS, ln)
    names = ["qkv", "t", "dctx", "ctxm", "stats", "dqkv", "part"]
    if ln:
        names = ["a_in"] + names[:-1] + ["d_in", "part"]
    assert list(scratch) == names
    want = tatt._core_bwd_stats(b, heads, n, "meta")
    assert scratch["stats"].shape == want.shape
    assert scratch["stats"].shape[0] == b * heads * -(-n // 64) * 64
    assert scratch["stats"].dtype == torch.float32
    assert scratch["part"].numel() >= max(
        b * -(-n // 64) * da, sq * dm * 3 * da, sp * da * dm,
        -(-rows // 128) * 3 * da)
    if ln:
        assert scratch["part"].numel() >= -(-rows // 128) * 2 * dm


def test_weight_grad_splits_cover_the_card():
    """dWqkv and dWproj at DeiT-Small's train shape split 5 and 15 ways
    (27 and 9 output tiles of 128 x 128: 135 CTAs for 132 SMs); each split
    at least 8 of the 64-row k-tiles (591 rows: one split; 2056 rows: at
    most 4), never fewer than one."""
    rows = 64 * 197
    assert tatt._weight_grad_splits(384, 1152, rows, SMS) == 5
    assert tatt._weight_grad_splits(384, 384, rows, SMS) == 15
    assert tatt._weight_grad_splits(384, 1152, 591, SMS) == 1
    assert tatt._weight_grad_splits(384, 384, 591, SMS) == 1
    assert tatt._weight_grad_splits(640, 640, 8 * 257, SMS) == 4
    assert tatt._weight_grad_splits(1280, 3840, 32 * 257, SMS) == 1
    assert tatt._weight_grad_splits(16, 16, 13, SMS) == 1
