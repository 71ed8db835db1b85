"""The attention sublayer, forward and backward (counterpart of
``uvc_tpu/ops/attention.py``), in three forms.

``layer_attention_ln`` computes ``x + proj(mask * MHA(LN1(x)))`` for a
``[B, N, dm]`` residual stream and ``layer_attention_ln_bwd`` its
gradients; ``fused_layer_attention_ln`` is the two as one
``torch.autograd.Function`` (ports of ``_layer_ln_fwd_kernel`` and
``_layer_ln_bwd_kernel``).  ``layer_attention`` / ``layer_attention_bwd``
/ ``fused_layer_attention`` are the bare sublayer ``proj(mask * MHA(x))``
without LayerNorm and residual, for blocks that scale the sublayer output
before the residual add (ports of ``_layer_fwd_kernel`` and
``_layer_bwd_kernel``).  ``attention`` / ``attention_bwd`` /
``fused_attention`` are the attention core ``softmax(q k^T * scale) v`` on
``[B, H, N, dh]`` alone, with ``attention_core`` its JAX name (ports of
``_fwd_kernel`` and ``_bwd_kernel``); ``attention_bwd_ctx`` is that
backward with the context it recomputes (the port of ``_bwd_ctx_kernel``),
the attention part of ``layer_attention_ln_bwd_composed``, the backward
that models wider than the LayerNorm backward kernel take.  A CUDA tensor
goes to the hand-written kernels (``csrc/attention.cu``,
``csrc/attention_core.cu``); a CPU tensor goes to the ``*_plain``
functions, the same functions in plain PyTorch with the kernels' rounding
order.  There is no other route.
"""

from __future__ import annotations

import functools

import torch

from uvc_tpu_torch.ops import _cuda, _library
from uvc_tpu_torch.utils.profiler import spanned

# the LayerNorm backward keeps a row in registers (LNB_MAX_DM in
# csrc/ln_bwd.cuh: ViT-H/14's 1280); wider models take the composed
# backward, as the JAX package does beyond its VMEM budget
_MAX_DM_BWD = 1280

# the attention cores' head dims (instantiated for the padded head dims 16,
# 32, 48, 64 and 80) and the shared memory a CTA may take
_CORE_MAX_HEAD_DIM = 80
_SMEM_LIMIT = 232448


# the streamed cores of A9's, K1's and A7's forward
# (csrc/attention_core_fwd.cuh) and of A8's, A9's, A2's and A7's backward
# (csrc/attention_core_bwd.cuh) stream 64-row tiles through a ring of two
# stages, so their shared memory does not depend on N: the forward holds
# its query tile and two stages of K and V; the backward's query side two
# own tiles and two stages of K and V, its key side two own tiles and two
# stages of Q, dO and a tile's 64 float4 statistics; 1024 bytes of
# alignment and the mbarriers besides
_TILE_ROWS = 64
_BWD_STAGES = 2
_FWD_STAGES = 2


def _head_tile_bytes(dh: int) -> int:
    return _TILE_ROWS * -(-dh // 16) * 16 * 2


def _core_fwd_smem_bytes(dh: int) -> int:
    return (1024 + (1 + 2 * _FWD_STAGES) * _head_tile_bytes(dh)
            + (1 + _FWD_STAGES) * 8)


def _core_bwd_smem_bytes(dh: int) -> int:
    tile = _head_tile_bytes(dh)
    bars = (1 + _BWD_STAGES) * 8
    query_side = 1024 + (2 + 2 * _BWD_STAGES) * tile + bars
    key_side = (1024 + 2 * tile
                + _BWD_STAGES * (2 * tile + 16 * _TILE_ROWS) + bars)
    return max(query_side, key_side)


def _empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialised tensor: the core wrappers' outputs and scratch."""
    return torch.empty(shape, dtype=dtype, device=device)


def _core_bwd_stats(b: int, h: int, n: int, device) -> torch.Tensor:
    """The backward's per-query scratch (max * log2 e, 1 / s, row, 0):
    every row of every 64-row tile of every head."""
    rows = -(-n // _TILE_ROWS) * _TILE_ROWS
    return _empty((b * h * rows, 4), torch.float32, device)


def _copies_16_bytes(*ts) -> bool:
    """Whether every ``[B, H, N, dh]`` operand in ``ts`` allows the core
    kernels' 16-byte copies (``heads_vec`` in csrc/attention_core.cuh):
    dh, the (batch, head, row) strides and the base multiples of 8
    elements."""
    return ts[0].shape[-1] % 8 == 0 and all(
        all(st % 8 == 0 for st in t.stride()[:3])
        and t.data_ptr() % 16 == 0 for t in ts)


def _core_bwd_pack(q, k, v, do):
    """The core backward's pack scratch, ``[4, B, H, N, DHP]`` in q's dtype
    with DHP the head dim padded to 16, where the operands do not allow
    16-byte copies (an odd head dim, 4-byte strides): the kernel copies q,
    k, v and do into it zero-padded and loads them from there by TMA, as
    the reference's wrapper pads with ``jnp.pad``.  None where they do
    (the kernel reads them as they lie)."""
    if _copies_16_bytes(q, k, v, do):
        return None
    b, h, n, dh = q.shape
    return _empty((4, b, h, n, -(-dh // 16) * 16), q.dtype, q.device)


def _ln_rows(x32, gamma, beta, eps):
    """Row layernorm in f32 (twin of the JAX ``_ln_rows``).  Returns
    (a_in, xhat, inv)."""
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    return xhat * gamma + beta, xhat, inv


def _sublayer_plain(a, wqkv, bqkv, wproj, bproj, mask, num_heads, scale):
    """qkv, attention, the ctx mask and the output projection from ``a``,
    the qkv projection's input, rounded where the Pallas bodies round
    (qkv, ctx and ctx * mask to ``a.dtype``; logits and softmax in f32,
    normalised after P @ V).  Returns the f32 projection, bias added."""
    dt = a.dtype
    b, n, _ = a.shape
    da = wqkv.shape[1] // 3            # attention width (!= dm when compact)
    dh = da // num_heads
    qkv = (a.float() @ wqkv.float() + bqkv.float()).to(dt)
    q, k, v = qkv.view(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    ctx = attention_plain(q, k, v, scale).transpose(1, 2).reshape(b, n, da)
    ctx = (ctx.float() * mask.to(dt).float()).to(dt)
    return ctx.float() @ wproj.float() + bproj.float()


def layer_attention_ln_plain(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                             num_heads: int, scale: float, eps: float):
    """Plain PyTorch version of the kernel, rounded where the Pallas body
    rounds: LN output, qkv, ctx and ctx * mask to ``x.dtype``; logits,
    softmax and the residual sum in f32, with the softmax normalisation
    applied after P @ V.  In f32 every rounding is the identity and this is
    the JAX CPU composition."""
    x32 = x.float()
    a_in = _ln_rows(x32, g1.float(), b1.float(), eps)[0].to(x.dtype)
    out = _sublayer_plain(a_in, wqkv, bqkv, wproj, bproj, mask, num_heads,
                          scale)
    return (x32 + out).to(x.dtype)


def layer_attention_plain(x, wqkv, bqkv, wproj, bproj, mask, *,
                          num_heads: int, scale: float):
    """Plain PyTorch version of the bare-sublayer kernel
    (``_layer_fwd_kernel``): qkv, ctx and ctx * mask rounded to
    ``x.dtype``, logits and softmax in f32 normalised after P @ V, and the
    output ``x.dtype(f32 projection + bias)`` with no residual.  In f32
    this is the JAX CPU composition."""
    return _sublayer_plain(x, wqkv, bqkv, wproj, bproj, mask, num_heads,
                           scale).to(x.dtype)


def _check_cuda(x, named, dtypes):
    """Device, dtype and layout checks shared by the kernel wrappers.
    Matrices and activations are read 16 bytes at a time and must start on
    a 16-byte boundary; vectors (LN parameters, biases, masks, the gating
    distribution) are read element by element."""
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() >= 2 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_attention(x, named, num_heads, max_dm=None):
    """The kernels' checks of the attention sublayer's operands; returns
    (B, N, dm, da).  The head dim is ``wqkv``'s width over 3 heads: even,
    at most 80.  Every sublayer kernel (K1, A2, A7 forward and backward)
    streams its attention core's tiles, so N is not bounded."""
    bf16, f32 = torch.bfloat16, torch.float32
    _check_cuda(x, named, {k: f32 if k in ("g1", "b1") else bf16
                           for k in named})
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, dm], got {tuple(x.shape)}")
    b, n, dm = x.shape
    da = named["wqkv"].shape[-1] // 3
    dh = da // num_heads
    if (da % 8 or dh * num_heads != da or dh % 2
            or not 0 < dh <= _CORE_MAX_HEAD_DIM):
        raise ValueError(f"unsupported attention width {da} over "
                         f"{num_heads} heads: the kernels take even head "
                         f"dims up to {_CORE_MAX_HEAD_DIM} and widths that "
                         f"are multiples of 8")
    want = dict(g1=(dm,), b1=(dm,), wqkv=(dm, 3 * da), bqkv=(3 * da,),
                wproj=(da, dm), bproj=(dm,), mask=(da,), do=tuple(x.shape))
    for name, t in named.items():
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for {num_heads} "
                             f"heads of {dh}, got {tuple(t.shape)}")
    if dm % 8 or n == 0 or b == 0 or (max_dm and dm > max_dm):
        limit = "" if max_dm is None else f" and <= {max_dm}"
        raise ValueError(f"unsupported x shape {tuple(x.shape)}: dm must be "
                         f"a multiple of 8{limit} and N > 0")
    return b, n, dm, da


def _layer_attention_ln_cuda(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                             num_heads, scale, eps):
    bf16 = torch.bfloat16
    named = dict(x=x, g1=g1, b1=b1, wqkv=wqkv, bqkv=bqkv, wproj=wproj,
                 bproj=bproj, mask=mask)
    b, n, dm, da = _check_attention(x, named, num_heads)
    lib = _cuda.library("attention")
    rows = b * n
    a_in = torch.empty((rows, dm), dtype=bf16, device=x.device)
    qkv = torch.empty((rows, 3 * da), dtype=bf16, device=x.device)
    ctx = torch.empty((rows, da), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_layer_attention_ln(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            mask.data_ptr(), a_in.data_ptr(), qkv.data_ptr(),
            ctx.data_ptr(), out.data_ptr(), b, n, dm, da, num_heads,
            float(scale), float(eps), stream)
    _cuda.check(err, "layer_attention_ln")
    layer_attention_ln.launches += 1
    return out


@spanned("uvc.op.layer_attention_ln")
def layer_attention_ln(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                       num_heads: int, scale: float, eps: float):
    """``x + (mask * MHA(LN1(x) @ wqkv + bqkv)) @ wproj + bproj``.

    x: ``[B, N, dm]``; g1/b1: ``[dm]`` f32; wqkv ``[dm, 3*da]`` and wproj
    ``[da, dm]`` stored (in, out); mask: ``[da]`` structural keep mask over
    the ctx columns.  On CUDA: bf16 activations and weights, even head
    dims up to 80, any N (its backward too).
    ``layer_attention_ln.launches`` counts kernel launches.  Both
    devices go through the operator ``uvc_tpu_torch.layer_attention_ln``
    (the kernel on CUDA, the plain version on the CPU)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_attention_ln runs on cpu or cuda, "
                         f"not {x.device}")
    return layer_attention_ln_op(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                                 int(num_heads), float(scale), float(eps))


layer_attention_ln.launches = 0


def _layer_attention_ln_cpu(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                            num_heads, scale, eps):
    return layer_attention_ln_plain(
        x, g1, b1, wqkv, bqkv, wproj, bproj, mask, num_heads=num_heads,
        scale=scale, eps=eps)


def _layer_attention_ln_fake(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                             num_heads, scale, eps):
    return torch.empty_like(x)


layer_attention_ln_op = _library.define(
    "layer_attention_ln(Tensor x, Tensor g1, Tensor b1, Tensor wqkv, "
    "Tensor bqkv, Tensor wproj, Tensor bproj, Tensor mask, int num_heads, "
    "float scale, float eps) -> Tensor",
    cpu=_layer_attention_ln_cpu, cuda=_layer_attention_ln_cuda,
    fake=_layer_attention_ln_fake)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _sublayer_bwd_plain(a, wqkv, bqkv, wproj, mask, do, num_heads, scale):
    """The backward of ``_sublayer_plain`` below its input ``a``, in the
    Pallas bodies' rounding order: qkv recomputed as the forward rounds
    it; ``t = do . Wproj^T`` in f32 and ``dctx = bf16(t * mask)``;
    ``probs = p / s`` in f32 and ``pb = bf16(probs)``; the recomputed
    ``ctx = pb . v`` (not the forward's ``(p . v) / s``);
    ``ds = bf16(probs * (dp - rowsum(dp * probs)))`` and ``dqkv`` in
    bf16; ``dmask = sum(t * ctx)`` with the f32 ``t`` ("bf16" standing for
    ``a.dtype``).  Returns the f32 ``d a = dqkv . Wqkv^T`` and the f32
    gradients of (wqkv, bqkv, wproj, bproj, mask)."""
    dt = a.dtype
    b, n, dm = a.shape
    da = wqkv.shape[1] // 3
    dh = da // num_heads
    a32 = a.float()
    qkv = (a32 @ wqkv.float() + bqkv.float()).to(dt).float()
    dob = do.to(dt).float()
    maskv = mask.float()
    t = dob @ wproj.float().T                             # [B, N, da] f32
    dctx = (t * maskv).to(dt).float()
    q, k, v = qkv.view(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    doh = dctx.view(b, n, num_heads, dh).transpose(1, 2)  # [B, H, N, dh]
    logits = (q @ k.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    pb = probs.to(dt).float()
    ctx = pb @ v
    dv = pb.transpose(-1, -2) @ doh
    dp = doh @ v.transpose(-1, -2)
    row = (dp * probs).sum(dim=-1, keepdim=True)
    ds = (probs * (dp - row)).to(dt).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    ctx = ctx.transpose(1, 2).reshape(b, n, da)
    dqkv = torch.stack([dq, dk, dv], dim=2)               # [B, H, 3, N, dh]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(b, n, 3 * da).to(dt).float()
    d_in = dqkv @ wqkv.float().T                          # [B, N, dm] f32
    rows = (0, 1)
    dwqkv = a32.reshape(-1, dm).T @ dqkv.reshape(-1, 3 * da)
    dwproj = ((ctx * maskv).to(dt).float().reshape(-1, da).T
              @ dob.reshape(-1, dm))
    return d_in, (dwqkv, dqkv.sum(rows), dwproj, dob.sum(rows),
                  (t * ctx).sum(rows))


def layer_attention_ln_bwd_plain(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                                 do, *, num_heads: int, scale: float,
                                 eps: float):
    """Plain PyTorch version of the backward kernel, in the Pallas body's
    rounding order (``_layer_ln_bwd_kernel``): LN1 recomputed and rounded
    as the forward rounds it, ``_sublayer_bwd_plain`` below it, then the
    LN VJP in f32 plus the residual ``do``.

    Returns the gradients of (x, g1, b1, wqkv, bqkv, wproj, bproj, mask),
    each in its input's dtype, as ``_fused_layer_ln_bwd`` returns them.  In
    f32 every rounding is the identity and this is the autodiff of the JAX
    CPU composition."""
    a32, xhat, inv = _ln_rows(x.float(), g1.float(), b1.float(), eps)
    d_in, wgrads = _sublayer_bwd_plain(a32.to(x.dtype), wqkv, bqkv, wproj,
                                       mask, do, num_heads, scale)
    dg = d_in * g1.float()
    m1 = dg.mean(dim=-1, keepdim=True)
    m2 = (dg * xhat).mean(dim=-1, keepdim=True)
    dz = (dg - m1 - xhat * m2) * inv
    dx = (dz + do.float()).to(x.dtype)
    rows = (0, 1)
    grads = (dx, (d_in * xhat).sum(rows), d_in.sum(rows), *wgrads)
    return tuple(gr.to(ref.dtype) for gr, ref in zip(
        grads, (x, g1, b1, wqkv, bqkv, wproj, bproj, mask)))


def layer_attention_bwd_plain(x, wqkv, bqkv, wproj, bproj, mask, do, *,
                              num_heads: int, scale: float):
    """Plain PyTorch version of the bare-sublayer backward kernel
    (``_layer_bwd_kernel``): ``_sublayer_bwd_plain`` with ``x`` itself as
    the qkv input (``dWqkv = x^T . dqkv``), and ``dx = x.dtype(dqkv .
    Wqkv^T)`` with no residual.

    Returns the gradients of (x, wqkv, bqkv, wproj, bproj, mask), each in
    its input's dtype, as ``_fused_layer_bwd`` returns them.  In f32 this
    is the autodiff of the JAX CPU composition."""
    d_in, wgrads = _sublayer_bwd_plain(x, wqkv, bqkv, wproj, mask, do,
                                       num_heads, scale)
    return tuple(gr.to(ref.dtype) for gr, ref in zip(
        (d_in, *wgrads), (x, wqkv, bqkv, wproj, bproj, mask)))


# the weight-gradient products of the sublayer backwards (csrc/gemm_wg.cuh)
# run 128 x 128 output tiles over 64-row k-tiles of the B*N rows; a split
# sums at least 8 k-tiles, as a shorter one costs its in-order sum more
# than it saves
_WG_TILE, _WG_KTILE, _WG_MIN_KTILES = 128, 64, 8


def _weight_grad_splits(m: int, n: int, k: int, sms: int) -> int:
    """CTAs along K of an ``[m, n]`` weight gradient over ``k`` rows: enough
    that its output tiles, each split that many ways, cover the card's
    ``sms`` SMs once, each split at least ``_WG_MIN_KTILES`` k-tiles long
    (one split where K is shorter than two of those)."""
    tiles = -(-m // _WG_TILE) * -(-n // _WG_TILE)
    return max(1, min(k // _WG_KTILE // _WG_MIN_KTILES, -(-sms // tiles)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the row and column sums of the backwards (csrc/ln_bwd.cuh) aim for twice
# the H100's 132 SMs in CTAs
_SUMS_TARGET_CTAS = 264
_LNB_MIN_ROWS, _LNB_MAX_ROWS, _LNB_MAX_WARPS = 4, 32, 8
_CS_WARPS, _CS_COLS = 8, 256


def _ln_bwd_split(rows: int, dm: int):
    """The LayerNorm backward's partition of the B*N rows (``ln_bwd_split``
    in csrc/ln_bwd.cuh): (rows a CTA, warps a CTA, CTAs).  A warp takes a
    row at a time, every warps-th row of its CTA's block; each CTA writes
    one partial row of ``3 dm + 2`` floats."""
    per = max(_LNB_MIN_ROWS, min(_LNB_MAX_ROWS, rows // _SUMS_TARGET_CTAS))
    warps = max(1, min(per, _LNB_MAX_WARPS, 16 // -(-dm // 256)))
    return per, warps, -(-rows // per)


def _ln_bwd_floats(rows: int, dm: int) -> int:
    """f32 scratch of the LayerNorm backward: its partial rows, then their
    sums ``[dgamma | dbeta | colsum(do) | do . x, do . xin]``."""
    return (_ln_bwd_split(rows, dm)[2] + 1) * (3 * dm + 2)


def _colsum_split(rows: int, cols: int):
    """The column sums' partition (``colsum_rows`` in csrc/ln_bwd.cuh):
    (rows a block, blocks).  A CTA sums 256 columns of a block, so that
    the grid covers about ``_SUMS_TARGET_CTAS`` CTAs."""
    per = max(_CS_WARPS, rows * -(-cols // _CS_COLS) // _SUMS_TARGET_CTAS
              // _CS_WARPS * _CS_WARPS)
    return per, -(-rows // per)


def _sublayer_bwd_scratch(b, n, dm, da, num_heads, device, sms, ln):
    """The scratch of the sublayer backward kernels (A2 with ``ln``, else
    A7), in the order their entry points take it, and the split counts of
    dWqkv and dWproj.  ``part`` holds, one after the other, dmask's partial
    sums (one row per 64-row query tile of an image), the split-K partials
    ``[splits, M, N]`` of either weight gradient, dbqkv's column-sum
    partials and A7's dbproj's (``_colsum_split``), or A2's LayerNorm
    backward's partials and sums (``_ln_bwd_floats``)."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = b * n
    splits = (_weight_grad_splits(dm, 3 * da, rows, sms),
              _weight_grad_splits(da, dm, rows, sms))

    def new(*shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device=device)

    part = max(b * -(-n // _TILE_ROWS) * da,
               splits[0] * dm * 3 * da, splits[1] * da * dm,
               _colsum_split(rows, 3 * da)[1] * 3 * da,
               _ln_bwd_floats(rows, dm) if ln
               else _colsum_split(rows, dm)[1] * dm)
    scratch = dict(
        qkv=new(rows, 3 * da), t=new(rows, da, dtype=f32), dctx=new(rows, da),
        ctxm=new(rows, da), stats=_core_bwd_stats(b, num_heads, n, device),
        dqkv=new(rows, 3 * da))
    if ln:
        scratch = dict(a_in=new(rows, dm), **scratch,
                       d_in=new(rows, dm, dtype=f32))
    scratch["part"] = new(part, dtype=f32)
    return scratch, splits


def _layer_attention_ln_bwd_cuda(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                                 do, *, num_heads, scale, eps):
    f32 = torch.float32
    named = dict(x=x, g1=g1, b1=b1, wqkv=wqkv, bqkv=bqkv, wproj=wproj,
                 bproj=bproj, mask=mask, do=do)
    b, n, dm, da = _check_attention(x, named, num_heads, max_dm=_MAX_DM_BWD)
    lib = _cuda.library("attention")
    scratch, splits = _sublayer_bwd_scratch(
        b, n, dm, da, num_heads, x.device, _sm_count(x.device.index or 0),
        ln=True)
    grads = (torch.empty_like(x), x.new_empty(dm, dtype=f32),
             x.new_empty(dm, dtype=f32), torch.empty_like(wqkv),
             torch.empty_like(bqkv), torch.empty_like(wproj),
             torch.empty_like(bproj), torch.empty_like(mask))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_layer_attention_ln_bwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), mask.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in scratch.values()),
            *(t.data_ptr() for t in grads), b, n, dm, da, num_heads,
            *splits, float(scale), float(eps), stream)
    _cuda.check(err, "layer_attention_ln_bwd")
    layer_attention_ln_bwd.launches += 1
    return grads


@spanned("uvc.op.layer_attention_ln_bwd")
def layer_attention_ln_bwd(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, do, *,
                           num_heads: int, scale: float, eps: float):
    """Gradients of ``layer_attention_ln`` with respect to its eight tensor
    inputs, given the output cotangent ``do`` (same shape and dtype as
    ``x``).  On CUDA: the forward's operand types, ``dm <= 1280`` (wider
    models take ``layer_attention_ln_bwd_composed``).
    ``layer_attention_ln_bwd.launches`` counts kernel launches."""
    kw = dict(num_heads=num_heads, scale=scale, eps=eps)
    if x.device.type == "cpu":
        return layer_attention_ln_bwd_plain(
            x, g1, b1, wqkv, bqkv, wproj, bproj, mask, do, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"layer_attention_ln_bwd runs on cpu or cuda, "
                         f"not {x.device}")
    return _layer_attention_ln_bwd_cuda(
        x, g1, b1, wqkv, bqkv, wproj, bproj, mask, do, **kw)


layer_attention_ln_bwd.launches = 0


class _FusedLayerAttentionLN(torch.autograd.Function):
    """``layer_attention_ln`` forward, ``layer_attention_ln_bwd`` backward,
    or ``layer_attention_ln_bwd_composed`` at ``dm > 1280`` (the port of
    the JAX custom VJP ``_fused_layer_ln``, which peels the LayerNorm off
    and composes the backward where its kernel's VMEM budget refuses the
    width)."""

    @staticmethod
    def forward(ctx, x, g1, b1, wqkv, bqkv, wproj, bproj, mask, num_heads,
                scale, eps):
        ctx.kw = dict(num_heads=num_heads, scale=scale, eps=eps)
        ctx.save_for_backward(x, g1, b1, wqkv, bqkv, wproj, bproj, mask)
        return layer_attention_ln(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                                  **ctx.kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        x = ctx.saved_tensors[0]
        bwd = (layer_attention_ln_bwd_composed if x.shape[-1] > _MAX_DM_BWD
               else layer_attention_ln_bwd)
        grads = bwd(*ctx.saved_tensors, do.contiguous(), **ctx.kw)
        return (*grads, None, None, None)


def fused_layer_attention_ln(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                             num_heads: int, scale: float, eps: float):
    """``layer_attention_ln`` with its gradient: the forward kernel, and
    the backward kernel when autograd asks for the gradients.  Under
    ``torch.no_grad`` it is ``layer_attention_ln`` itself (no autograd
    node, no saved inputs)."""
    if not torch.is_grad_enabled():
        return layer_attention_ln(x, g1, b1, wqkv, bqkv, wproj, bproj, mask,
                                  num_heads=num_heads, scale=scale, eps=eps)
    return _FusedLayerAttentionLN.apply(x, g1, b1, wqkv, bqkv, wproj, bproj,
                                        mask, num_heads, scale, eps)


# ---------------------------------------------------------------------------
# the bare sublayer (kernel A7): no LayerNorm, no residual
# ---------------------------------------------------------------------------


def _layer_attention_cuda(x, wqkv, bqkv, wproj, bproj, mask, *, num_heads,
                          scale):
    named = dict(x=x, wqkv=wqkv, bqkv=bqkv, wproj=wproj, bproj=bproj,
                 mask=mask)
    b, n, dm, da = _check_attention(x, named, num_heads)
    lib = _cuda.library("attention")
    rows = b * n
    qkv = torch.empty((rows, 3 * da), dtype=x.dtype, device=x.device)
    ctx = torch.empty((rows, da), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_layer_attention(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), mask.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), b, n, dm, da, num_heads, float(scale), stream)
    _cuda.check(err, "layer_attention")
    layer_attention.launches += 1
    return out


@spanned("uvc.op.layer_attention")
def layer_attention(x, wqkv, bqkv, wproj, bproj, mask, *, num_heads: int,
                    scale: float):
    """``(mask * MHA(x @ wqkv + bqkv)) @ wproj + bproj``: the attention
    sublayer without LayerNorm and residual (the port of
    ``fused_layer_attention``).  Shapes as ``layer_attention_ln``; on
    CUDA bf16 operands, even head dims up to 80, any N.
    ``layer_attention.launches`` counts kernel launches."""
    kw = dict(num_heads=num_heads, scale=scale)
    if x.device.type == "cpu":
        return layer_attention_plain(x, wqkv, bqkv, wproj, bproj, mask, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"layer_attention runs on cpu or cuda, not "
                         f"{x.device}")
    return _layer_attention_cuda(x, wqkv, bqkv, wproj, bproj, mask, **kw)


layer_attention.launches = 0


def _layer_attention_bwd_cuda(x, wqkv, bqkv, wproj, bproj, mask, do, *,
                              num_heads, scale):
    named = dict(x=x, wqkv=wqkv, bqkv=bqkv, wproj=wproj, bproj=bproj,
                 mask=mask, do=do)
    b, n, dm, da = _check_attention(x, named, num_heads)
    lib = _cuda.library("attention")
    scratch, splits = _sublayer_bwd_scratch(
        b, n, dm, da, num_heads, x.device, _sm_count(x.device.index or 0),
        ln=False)
    grads = tuple(torch.empty_like(t)
                  for t in (x, wqkv, bqkv, wproj, bproj, mask))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_layer_attention_bwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            mask.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in scratch.values()),
            *(t.data_ptr() for t in grads), b, n, dm, da, num_heads,
            *splits, float(scale), stream)
    _cuda.check(err, "layer_attention_bwd")
    layer_attention_bwd.launches += 1
    return grads


@spanned("uvc.op.layer_attention_bwd")
def layer_attention_bwd(x, wqkv, bqkv, wproj, bproj, mask, do, *,
                        num_heads: int, scale: float):
    """Gradients of ``layer_attention`` with respect to its six tensor
    inputs, given the output cotangent ``do``.  On CUDA: the forward's
    operand types.  ``layer_attention_bwd.launches`` counts kernel
    launches."""
    kw = dict(num_heads=num_heads, scale=scale)
    if x.device.type == "cpu":
        return layer_attention_bwd_plain(x, wqkv, bqkv, wproj, bproj, mask,
                                         do, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"layer_attention_bwd runs on cpu or cuda, not "
                         f"{x.device}")
    return _layer_attention_bwd_cuda(x, wqkv, bqkv, wproj, bproj, mask, do,
                                     **kw)


layer_attention_bwd.launches = 0


class _FusedLayerAttention(torch.autograd.Function):
    """``layer_attention`` forward, ``layer_attention_bwd`` backward (the
    port of the JAX custom VJP ``_fused_layer``)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, mask, num_heads, scale):
        ctx.kw = dict(num_heads=num_heads, scale=scale)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, mask)
        return layer_attention(x, wqkv, bqkv, wproj, bproj, mask, **ctx.kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        grads = layer_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                    **ctx.kw)
        return (*grads, None, None)


def fused_layer_attention(x, wqkv, bqkv, wproj, bproj, mask, *,
                          num_heads: int, scale: float):
    """``layer_attention`` with its gradient: the forward kernel, and the
    backward kernel when autograd asks for the gradients.  Under
    ``torch.no_grad`` it is ``layer_attention`` itself (no autograd node,
    no saved inputs)."""
    if not torch.is_grad_enabled():
        return layer_attention(x, wqkv, bqkv, wproj, bproj, mask,
                               num_heads=num_heads, scale=scale)
    return _FusedLayerAttention.apply(x, wqkv, bqkv, wproj, bproj, mask,
                                      num_heads, scale)


# ---------------------------------------------------------------------------
# the bare attention core (kernel A9): softmax(q k^T * scale) v on
# [B, H, N, dh], no projections; its backward with the context (kernel A8)
# ---------------------------------------------------------------------------


def attention_plain(q, k, v, scale: float):
    """Plain PyTorch version of the core kernel, in the Pallas body's
    rounding order (``_fwd_kernel``): f32 logits times ``scale``, then the
    max, ``exp`` and sum; ``ctx = (round(p) . v) / s``, the unnormalised
    probabilities ``p`` rounded to the input's dtype and the normalisation
    after P @ V; the output in the input's dtype.  In f32 every rounding
    is the identity."""
    dt = q.dtype
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    ctx = (p.to(dt).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return ctx.to(dt)


def attention_bwd_ctx_plain(q, k, v, do, scale: float):
    """Plain PyTorch version of the core backward kernels, in the Pallas
    bodies' rounding order (``_bwd_ctx_kernel``, whose dq, dk and dv are
    ``_bwd_kernel``'s): the softmax recomputed in f32, ``probs = p / s``
    and ``pb = round(probs)``; ``ctx = pb . v``, normalised before the
    product, unlike the forward; ``dv = pb^T . do``, ``dp = do . v^T``,
    ``row = sum(dp * probs)``, ``ds = round(probs * (dp - row))``,
    ``dq = ds . k * scale``, ``dk = ds^T . q * scale`` ("round" to the
    input's dtype).  Returns (ctx, dq, dk, dv) in the input's dtype."""
    dt = q.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    do32 = do.to(dt).float()
    logits = (q32 @ k32.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    pb = probs.to(dt).float()
    ctx = pb @ v32
    dv = pb.transpose(-1, -2) @ do32
    dp = do32 @ v32.transpose(-1, -2)
    row = (dp * probs).sum(dim=-1, keepdim=True)
    ds = (probs * (dp - row)).to(dt).float()
    dq = (ds @ k32) * scale
    dk = (ds.transpose(-1, -2) @ q32) * scale
    return ctx.to(dt), dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd_plain(q, k, v, do, scale: float):
    """Plain PyTorch version of the core backward kernel (``_bwd_kernel``):
    (dq, dk, dv) of ``attention_bwd_ctx_plain``, in the input's dtype."""
    return attention_bwd_ctx_plain(q, k, v, do, scale)[1:]


def _check_core(named, backward):
    """The core kernels' checks; returns (B, H, N, dh).  The kernels read
    each operand at its own strides (a head view of a projection as it
    lies), with unit stride along the head dim.  Forward and backward
    stream 64-row tiles, so their shared memory depends on the head dim
    only and they take any N."""
    q = named["q"]
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, dh], got {tuple(q.shape)}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} must be {tuple(q.shape)} as q, got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along the head "
                             f"dim, got strides {t.stride()}")
    b, h, n, dh = q.shape
    if not (b and h and n) or not 0 < dh <= _CORE_MAX_HEAD_DIM:
        raise ValueError(f"unsupported shape {tuple(q.shape)}: the kernels "
                         f"take head dims 1..{_CORE_MAX_HEAD_DIM} and N > 0")
    smem = (_core_bwd_smem_bytes(dh) if backward
            else _core_fwd_smem_bytes(dh))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"head dim {dh} does not fit the kernel's shared "
                         f"memory")
    return b, h, n, dh


def _head_major(q):
    """An empty ``[B, H, N, dh]`` tensor like ``q`` laid out as
    ``[B, N, H, dh]``: its ``transpose(1, 2).reshape(B, N, H * dh)``, the
    models' next step, is a view."""
    b, h, n, dh = q.shape
    return _empty((b, n, h, dh), q.dtype, q.device).transpose(1, 2)


def _strides(*ts):
    """The (batch, head, row) element strides of each operand, in order."""
    return _cuda.longs(s for t in ts for s in t.stride()[:3])


@spanned("uvc.op.attention")
def attention(q, k, v, scale: float):
    """``softmax(q k^T * scale) v`` over ``[B, H, N, dh]`` tensors (kernel
    A9's forward).  On CUDA: bf16 tensors at any strides with unit stride
    along dh, head dims 1..80, any N; the output is laid out
    ``[B, N, H, dh]``.
    ``attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    b, h, n, dh = _check_core(dict(q=q, k=k, v=v), backward=False)
    lib = _cuda.library("attention_core")
    out = _head_major(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.uvc_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), _strides(q, k, v, out), b, h,
                                n, dh, float(scale), stream)
    _cuda.check(err, "attention")
    attention.launches += 1
    return out


attention.launches = 0


@spanned("uvc.op.attention_bwd")
def attention_bwd(q, k, v, do, scale: float):
    """(dq, dk, dv) of ``attention`` given the output cotangent ``do``
    (kernel A9's backward).  On CUDA: the forward's operand types, the
    gradients laid out ``[B, N, H, dh]``; operands that do not allow
    16-byte copies are packed first (``_core_bwd_pack``).
    ``attention_bwd.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    b, h, n, dh = _check_core(dict(q=q, k=k, v=v, do=do), backward=True)
    lib = _cuda.library("attention_core")
    stats = _core_bwd_stats(b, h, n, q.device)
    pack = _core_bwd_pack(q, k, v, do)
    grads = tuple(_head_major(q) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.uvc_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            stats.data_ptr(), None if pack is None else pack.data_ptr(),
            *(g.data_ptr() for g in grads), _strides(q, k, v, do, *grads),
            b, h, n, dh, float(scale), stream)
    _cuda.check(err, "attention_bwd")
    attention_bwd.launches += 1
    return grads


attention_bwd.launches = 0


@spanned("uvc.op.attention_bwd_ctx")
def _attention_bwd_ctx_into(q, k, v, do, scale, outs):
    """``attention_bwd_ctx`` written into ``outs`` = (ctx, dq, dk, dv),
    ``[B, H, N, dh]`` tensors at any strides with unit stride along dh
    (head views of the rows the caller goes on with).  Returns ``outs``."""
    if q.device.type == "cpu":
        for out, res in zip(outs, attention_bwd_ctx_plain(q, k, v, do,
                                                          scale)):
            out.copy_(res)
        return outs
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_ctx runs on cpu or cuda, not "
                         f"{q.device}")
    b, h, n, dh = _check_core(dict(q=q, k=k, v=v, do=do, ctx=outs[0],
                                   dq=outs[1], dk=outs[2], dv=outs[3]),
                              backward=True)
    lib = _cuda.library("attention_core")
    stats = _core_bwd_stats(b, h, n, q.device)
    pack = _core_bwd_pack(q, k, v, do)
    ctx, dq, dk, dv = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.uvc_attention_bwd_ctx(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            stats.data_ptr(), None if pack is None else pack.data_ptr(),
            ctx.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dq, dk, dv, ctx), b, h, n, dh,
            float(scale), stream)
    _cuda.check(err, "attention_bwd_ctx")
    attention_bwd_ctx.launches += 1
    return outs


def attention_bwd_ctx(q, k, v, do, scale: float):
    """(ctx, dq, dk, dv): ``attention_bwd``'s gradients and the context
    ``round(probs) . v`` that the backward recomputes (kernel A8, the
    port of ``_bwd_ctx_kernel``).  On CUDA: the operand types and limits of
    ``attention_bwd``, the outputs laid out ``[B, N, H, dh]``.
    ``attention_bwd_ctx.launches`` counts kernel launches."""
    return _attention_bwd_ctx_into(q, k, v, do, scale,
                                   tuple(_head_major(q) for _ in range(4)))


attention_bwd_ctx.launches = 0


# ---------------------------------------------------------------------------
# the composed backward of the LN-fused sublayer, for models wider than the
# LayerNorm backward kernel (dm > _MAX_DM_BWD)
# ---------------------------------------------------------------------------


def _rows_as_heads(rows, parts, num_heads):
    """``[B, N, parts * H * dh]`` rows as ``parts`` head views
    ``[B, H, N, dh]``."""
    b, n, w = rows.shape
    return rows.view(b, n, parts, num_heads, w // parts // num_heads) \
        .permute(2, 0, 3, 1, 4)


def layer_attention_ln_bwd_composed(x, g1, b1, wqkv, bqkv, wproj, bproj,
                                    mask, do, *, num_heads: int,
                                    scale: float, eps: float):
    """The gradients of ``layer_attention_ln`` as the JAX package composes
    them for a width whose fused backward does not fit
    (``_fused_layer_ln_bwd``'s LN peel, ``uvc_tpu/ops/attention.py``
    :1012-1027, around the composed fallback of ``_fused_layer_bwd``,
    :672-701), with the same roundings: LN1 recomputed in f32 and rounded,
    ``qkv = a_in @ Wqkv + bqkv`` and ``dctx = (do @ Wproj^T) * mask`` in the
    operands' dtype, ``attention_bwd_ctx`` (kernel A8) for ctx, dq, dk,
    dv; ``dWproj = (ctx * mask)^T . do``, ``dWqkv = a_in^T . dqkv`` and the
    bias sums in f32; ``dmask = sum((do . Wproj^T) * ctx)`` in f32; then
    ``d a_in = dqkv @ Wqkv^T``, the LN VJP in f32, plus ``do``.

    The matrix products are XLA's in the reference, so they are
    ``torch.matmul`` here: in the operands' dtype (on the card a bf16 GEMM
    with f32 accumulation, rounded once), except ``do . Wproj^T`` for
    ``dmask``, which the reference keeps in f32 before the product with
    ctx (an f32 matmul, on the card without TF32 unless the caller enabled
    it).  dq, dk, dv land in one ``[B, N, 3 da]`` dqkv and ctx in
    ``[B, N, da]``, the layouts the products take.  Returns the gradients
    of (x, g1, b1, wqkv, bqkv, wproj, bproj, mask), each in its input's
    dtype.  ``layer_attention_ln_bwd_composed.calls`` counts its calls."""
    dt = x.dtype
    b, n, dm = x.shape
    da = wqkv.shape[1] // 3
    rows = (0, 1)
    a32, xhat, inv = _ln_rows(x.float(), g1.float(), b1.float(), eps)
    a_in = a32.to(dt)
    qkv = a_in @ wqkv + bqkv
    dctx = (do @ wproj.T) * mask
    ctx = x.new_empty((b, n, da))
    dqkv = x.new_empty((b, n, 3 * da))
    _attention_bwd_ctx_into(*_rows_as_heads(qkv, 3, num_heads),
                            *_rows_as_heads(dctx, 1, num_heads), scale,
                            (*_rows_as_heads(ctx, 1, num_heads),
                             *_rows_as_heads(dqkv, 3, num_heads)))
    do32 = do.float()
    dwproj = (ctx * mask).reshape(-1, da).T @ do.reshape(-1, dm)
    dmask = ((do32 @ wproj.float().T) * ctx.float()).sum(rows)
    d_in = (dqkv @ wqkv.T).float()
    dwqkv = a_in.reshape(-1, dm).T @ dqkv.reshape(-1, 3 * da)
    dg = d_in * g1.float()
    m1 = dg.mean(dim=-1, keepdim=True)
    m2 = (dg * xhat).mean(dim=-1, keepdim=True)
    dx = ((dg - m1 - xhat * m2) * inv).to(dt) + do
    layer_attention_ln_bwd_composed.calls += 1
    grads = (dx, (d_in * xhat).sum(rows), d_in.sum(rows), dwqkv,
             dqkv.float().sum(rows), dwproj, do32.sum(rows), dmask)
    return tuple(gr.to(ref.dtype) for gr, ref in zip(
        grads, (x, g1, b1, wqkv, bqkv, wproj, bproj, mask)))


layer_attention_ln_bwd_composed.calls = 0


class _FusedAttention(torch.autograd.Function):
    """``attention`` forward, ``attention_bwd`` backward (the port of the
    JAX custom VJP ``_attention_padded``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return attention(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        if do.stride(-1) != 1:   # e.g. the expanded gradient of a sum
            do = do.contiguous()
        return (*attention_bwd(*ctx.saved_tensors, do, ctx.scale), None)


def fused_attention(q, k, v, scale: float):
    """``softmax(q k^T * scale) v`` with ``[B, H, N, dh]`` inputs, any N,
    with its gradient: the forward kernel, and the backward kernel when
    autograd asks for the gradients (under ``torch.no_grad``,
    ``attention`` alone).  The route follows the tensors' device: the
    kernels on the card, their plain versions on the CPU.  Head views of a
    projection go to the kernels as they lie, and the kernels mask N
    themselves; only the backward copies operands that do not allow
    16-byte copies into zero-padded scratch (``_core_bwd_pack``)."""
    if not torch.is_grad_enabled():
        return attention(q, k, v, scale)
    return _FusedAttention.apply(q, k, v, scale)


# the JAX package's name of the same function
attention_core = fused_attention
