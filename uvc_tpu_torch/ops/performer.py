"""The token-performer stage of the T2T stem, forward and backward
(counterpart of ``uvc_tpu/ops/performer.py``).

One stage is LN1 (masked over the live feature slots) -> kqv -> positive
random features of k and q -> linear attention ``y = qp kptv^T / (qp .
kpsum + 1e-8)`` with the global sums ``kptv = sum_t v_t (x) kp_t`` and
``kpsum = sum_t kp_t`` over each image's tokens -> proj with the v
residual -> LN2 -> GELU MLP with the residual.  ``performer`` computes the
stage and returns the two global sums beside it (the residuals of the
backward), ``performer_bwd`` its gradients, and ``fused_performer`` the
two as one ``torch.autograd.Function`` behind the JAX package's
interface: it scatters the kqv rows and the LN1 affine to an expanded
feature layout (``feat_idx``) and casts the weights.

A CUDA tensor goes to the hand-written kernels (``csrc/performer.cu``, the
port of both Pallas forms, the merged ``_fwd_merged_kernel`` /
``_bwd_merged_kernel`` and the split ``_sums_kernel`` + ``_apply_kernel``
/ ``_bwd1_kernel`` + ``_bwd2_kernel``, which compute one function:
per-tile kernels over 64-token tiles, each CTA walking a run of an
image's tiles, ``_tile_split``); a CPU tensor goes to the ``*_plain``
functions, the same function in plain PyTorch in the Pallas bodies'
rounding order: bf16 matmul inputs with f32 accumulation, LayerNorms,
random features and the global sums in f32.  There is no other route.
GELU is the exact erf form (the Pallas bodies use the Abramowitz-Stegun
erf, |err| < 1.5e-7).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from uvc_tpu_torch.ops import _cuda, _library
from uvc_tpu_torch.ops.attention import (_check_cuda, _ln_rows, _sm_count,
                                         _weight_grad_splits)
from uvc_tpu_torch.utils.profiler import spanned

# nn.LayerNorm's default eps in the reference Token_performer
_LN_EPS = 1e-5
# the normaliser's guard: y = qp kptv^T / (qp . kpsum + 1e-8)
_D_EPS = 1e-8
# the kernels' widths: every T2T config has token_dim 64, kernel ratio 0.5
_EMB, _M = 64, 32
# the widths the kernels take (the T2T stems': 192 and 576)
_MAX_DIM = 1024
# csrc/performer.cu: 64-token tiles; the CTAs a kernel aims for, per SM
# (what its shared memory and registers let one SM hold): the forward's
# first and second kernels, the backward's q and k|v kernels
_TILE = 64
_CTAS_PER_SM = dict(fwd_sums=2, fwd_apply=4, bwd_q=2, bwd_kv=2)
# the per-CTA partials (floats): kptv | kpsum (and dkptv | dkpsum); the q
# kernel's six column sums, the k|v kernel's two; dLN1's [2, dim] a tile
# (the k|v kernel's)
_PART = _EMB * _M + _M
_Q_SUMS = 6 * _EMB
_KV_SUMS = 2 * _EMB
# the weight-gradient products' operands: [dk | dv | dq | dattn] and
# [y | h2 | a | dhh] a row
_DKQV = 4 * _EMB

OPERANDS = ("x", "g1", "b1", "wkqv", "bkqv", "w", "fmask", "wproj", "bproj",
            "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")
GRADS = ("dx", "dg1", "db1", "dwkqv", "dbkqv", "dwproj", "dbproj", "dg2",
         "db2", "dwfc1", "dbfc1", "dwfc2", "dbfc2")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _masked_ln(x32, g, b, fmask, fcount):
    """LN1 in f32 with statistics over the live slots (``fmask``, ``fcount``
    of them; all ones and the width for a dense layout).  Returns (xn, xhat,
    rstd)."""
    mu = (x32 * fmask).sum(-1, keepdim=True) / fcount
    xc = x32 - mu
    var = (xc * xc * fmask).sum(-1, keepdim=True) / fcount
    rstd = torch.rsqrt(var + _LN_EPS)
    xhat = xc * rstd
    return xhat * g + b, xhat, rstd


def _masked_ln_vjp(dy32, xhat, rstd, g, fmask, fcount):
    """d/dx of ``_masked_ln`` given the f32 cotangent of its output."""
    gd = dy32 * g * fmask
    m1 = gd.sum(-1, keepdim=True) / fcount
    m2 = (gd * xhat).sum(-1, keepdim=True) / fcount
    return (gd - m1 - xhat * m2) * rstd * fmask


def _prm(t32, w32):
    """Positive random features in f32:
    ``exp(t w^T - |t|^2 / 2) / sqrt(m)``."""
    xd = (t32 * t32).sum(-1, keepdim=True) / 2.0
    return torch.exp(t32 @ w32.T - xd) / math.sqrt(w32.shape[0])


def _front(x, g1, b1, wkqv, bkqv, fmask, fcount):
    """LN1 and the kqv projection: (xn32, xhat, rstd, kqv32)."""
    xn32, xhat, rstd = _masked_ln(x.float(), g1.float(), b1.float(),
                                  fmask.float(), fcount)
    kqv = xn32.to(x.dtype).float() @ wkqv.float() + bkqv.float()
    return xn32, xhat, rstd, kqv


class _Sums:
    """The sums over the B*N tokens of the plain versions, each named by the
    kernel that takes it on the card (``kernel``: "fwd_sums", "bwd_q",
    "bwd_kv", or the products "dwkqv" and "dw64"); a replay of the kernels'
    order stands in for them in the tests."""

    @staticmethod
    def tokens(a, b, kernel):
        """Each image's sum over its tokens of a_t (x) b_t: [B, A, B']."""
        return a.transpose(-1, -2) @ b

    @staticmethod
    def token_sum(t, kernel):
        """Each image's sum over its tokens: [B, 1, C]."""
        return t.sum(dim=1, keepdim=True)

    @staticmethod
    def wgrad(a, b, kernel):
        """The sum over all tokens of a_t (x) b_t."""
        return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])

    @staticmethod
    def colsum(t, kernel):
        return t.sum((0, 1))

    @staticmethod
    def ln1(dxn1, dxn2, xhat1):
        """dLN1's (dgamma, dbeta) from the two halves of dxn."""
        d = dxn1 + dxn2
        return (d * xhat1).sum((0, 1)), d.sum((0, 1))


def performer_plain(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                    wfc1, bfc1, wfc2, bfc2, *, fcount: float, sums=_Sums):
    """Plain version of the stage forward in the rounding order of
    ``_fwd_merged_kernel``: kp, v, qp, y, attn, the LN2 output and the GELU
    output rounded to ``x.dtype`` where the Pallas body rounds them.
    Returns (out ``[B, N, emb]``, kptv ``[B, emb, m]`` f32, kpsum ``[B, 1,
    m]`` f32).  In f32 every rounding is the identity and this is the JAX
    CPU composition (``apply_performer``) up to summation order."""
    dt = x.dtype
    emb = wkqv.shape[1] // 3
    w32 = w.float()
    kqv = _front(x, g1, b1, wkqv, bkqv, fmask, fcount)[3]
    k, q = kqv[..., :emb], kqv[..., emb:2 * emb]
    v = kqv[..., 2 * emb:].to(dt).float()
    kp = _prm(k, w32).to(dt).float()
    qp32 = _prm(q, w32)
    kptv = sums.tokens(v, kp, "fwd_sums")                # [B, emb, m]
    kpsum = sums.token_sum(kp, "fwd_sums")               # [B, 1, m]
    d = (qp32 * kpsum).sum(-1, keepdim=True)             # [B, N, 1]
    y = (qp32.to(dt).float() @ kptv.to(dt).float().transpose(-1, -2)
         / (d + _D_EPS))
    attn = v + (y.to(dt).float() @ wproj.float() + bproj.float())
    h2 = _ln_rows(attn.to(dt).float(), g2.float(), b2.float(), _LN_EPS)[0]
    hh = h2.to(dt).float() @ wfc1.float() + bfc1.float()
    mlp = F.gelu(hh).to(dt).float() @ wfc2.float() + bfc2.float()
    return (attn + mlp).to(dt), kptv, kpsum


def performer_bwd_plain(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2,
                        b2, wfc1, bfc1, wfc2, bfc2, kptv, kpsum, do, *,
                        fcount: float, dx: bool = True, sums=_Sums):
    """Plain version of the stage backward in the rounding order of
    ``_bwd_merged_kernel``: phase 1 recomputes the forward and runs the
    local gradients (MLP, LN2, proj, the q path) while summing the global
    cotangents dkptv / dkpsum; phase 2 takes them through the k / v path.
    The two halves of dx are rounded to ``x.dtype`` before their sum, and
    dWkqv / dbkqv are assembled from the q|v and k|v halves as at
    performer.py:1004-1008.  Returns the gradients named in ``GRADS``, each
    in its operand's dtype; ``w`` and ``fmask`` get none.  With ``dx``
    False the input gradient is None and left uncomputed; every other
    gradient is the same."""
    dt = x.dtype
    emb = wkqv.shape[1] // 3

    def r(t):
        return t.to(dt).float()

    w32, wb = w.float(), r(w)
    g1f, fm = g1.float(), fmask.float()
    xn32, xhat1, rstd1, kqv = _front(x, g1, b1, wkqv, bkqv, fmask, fcount)
    k32, q32 = kqv[..., :emb], kqv[..., emb:2 * emb]
    v = r(kqv[..., 2 * emb:])
    kp32, qp32 = _prm(k32, w32), _prm(q32, w32)
    qp = r(qp32)
    kptv_b = r(kptv)
    d = (qp32 * kpsum).sum(-1, keepdim=True)
    dd_inv = 1.0 / (d + _D_EPS)
    y = (qp @ kptv_b.transpose(-1, -2)) * dd_inv
    attn = v + (r(y) @ wproj.float() + bproj.float())
    h2_32, xhat2, rstd2 = _ln_rows(r(attn), g2.float(), b2.float(), _LN_EPS)
    h2 = r(h2_32)
    hh = h2 @ wfc1.float() + bfc1.float()
    phi = 0.5 * (1.0 + torch.erf(hh / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * hh * hh) / math.sqrt(2.0 * math.pi)
    a = r(hh * phi)

    do32 = do.float()
    dob = r(do32)
    # MLP, LN2 and proj
    dhh = (dob @ wfc2.float().T) * (phi + hh * pdf)
    dhh_b = r(dhh)
    dh2 = dhh_b @ wfc1.float().T
    gd = dh2 * g2.float()
    dattn = do32 + (gd - gd.mean(-1, keepdim=True)
                    - xhat2 * (gd * xhat2).mean(-1, keepdim=True)) * rstd2
    dattn_b = r(dattn)
    dy = dattn_b @ wproj.float().T
    # the normaliser and the q path; the global cotangents
    dy_pre_b = r(dy * dd_inv)
    dd = -(dy * y).sum(-1, keepdim=True) * dd_inv
    dqp = dy_pre_b @ kptv_b + dd * kpsum
    dkptv = sums.tokens(dy_pre_b, qp, "bwd_q")           # [B, emb, m]
    dkpsum = sums.token_sum(dd * qp32, "bwd_q")          # [B, 1, m]
    dwtx = qp32 * dqp
    dq = r(dwtx) @ wb - q32 * dwtx.sum(-1, keepdim=True)
    dqv = torch.cat([dq, dattn], dim=-1)
    dxn1 = r(dqv) @ wkqv[:, emb:].float().T
    # phase 2: the k / v path from the complete global cotangents
    dkptv_b = r(dkptv)
    dv = r(kp32) @ dkptv_b.transpose(-1, -2)
    dwtx = kp32 * (v @ dkptv_b + dkpsum)
    dk = r(dwtx) @ wb - k32 * dwtx.sum(-1, keepdim=True)
    dkv = torch.cat([dk, dv], dim=-1)
    wkv = torch.cat([wkqv[:, :emb], wkqv[:, 2 * emb:]], dim=1).float()
    dxn2 = r(dkv) @ wkv.T
    dx_out = None
    if dx:
        dx1 = _masked_ln_vjp(dxn1, xhat1, rstd1, g1f, fm, fcount).to(dt)
        dx2 = _masked_ln_vjp(dxn2, xhat1, rstd1, g1f, fm, fcount).to(dt)
        dx_out = (dx1.float() + dx2.float()).to(dt)

    xnb = r(xn32)
    dwqv = sums.wgrad(xnb, r(dqv), "dwkqv")
    dwkv = sums.wgrad(xnb, r(dkv), "dwkqv")
    dbqv, dbkv = sums.colsum(dqv, "bwd_q"), sums.colsum(dkv, "bwd_kv")
    dg1, db1 = sums.ln1(dxn1, dxn2, xhat1)
    grads = dict(
        dx=dx_out, dg1=dg1, db1=db1,
        dwkqv=torch.cat([dwkv[:, :emb], dwqv[:, :emb],
                         dwqv[:, emb:] + dwkv[:, emb:]], dim=1),
        dbkqv=torch.cat([dbkv[:emb], dbqv[:emb], dbqv[emb:] + dbkv[emb:]]),
        dwproj=sums.wgrad(r(y), dattn_b, "dw64"),
        dbproj=sums.colsum(dattn, "bwd_q"),
        dg2=sums.colsum(dh2 * xhat2, "bwd_q"),
        db2=sums.colsum(dh2, "bwd_q"),
        dwfc1=sums.wgrad(h2, dhh_b, "dw64"),
        dbfc1=sums.colsum(dhh, "bwd_q"),
        dwfc2=sums.wgrad(a, dob, "dw64"),
        dbfc2=sums.colsum(do32, "bwd_q"))
    dtypes = dict(dx=x, dg1=g1, db1=b1, dwkqv=wkqv, dbkqv=bkqv, dwproj=wproj,
                  dbproj=bproj, dg2=g2, db2=b2, dwfc1=wfc1, dbfc1=bfc1,
                  dwfc2=wfc2, dbfc2=bfc2)
    return tuple(None if grads[k] is None else grads[k].to(dtypes[k].dtype)
                 for k in GRADS)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_performer(x, named):
    """The kernels' checks of the stage's operands; returns (B, N, dim)."""
    f32 = torch.float32
    f32_names = ("g1", "b1", "w", "fmask", "g2", "b2", "kptv", "kpsum")
    _check_cuda(x, dict(named, x=x), {k: f32 if k in f32_names
                                      else torch.bfloat16
                                      for k in (*named, "x")})
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, dim], got {tuple(x.shape)}")
    b, n, dim = x.shape
    e, m = _EMB, _M
    want = dict(g1=(dim,), b1=(dim,), wkqv=(dim, 3 * e), bkqv=(3 * e,),
                w=(m, e), fmask=(dim,), wproj=(e, e), bproj=(e,), g2=(e,),
                b2=(e,), wfc1=(e, e), bfc1=(e,), wfc2=(e, e), bfc2=(e,),
                kptv=(b, e, m), kpsum=(b, 1, m), do=(b, n, e))
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} (token dim {e}, "
                             f"{m} random features), got {tuple(t.shape)}")
    if dim % 8 or dim > _MAX_DIM or b * n == 0:
        raise ValueError(f"unsupported x shape {tuple(x.shape)}: dim must be "
                         f"a multiple of 8 and <= {_MAX_DIM}, B * N > 0")
    return b, n, dim


def _tile_split(b: int, n: int, ctas: int):
    """A kernel's partition of each image's ``ceil(n / 64)`` token tiles:
    (tiles a CTA walks, CTAs an image), contiguous runs in tile order,
    about ``ctas`` CTAs in all.  The grid is (CTAs an image, b); a
    partial per CTA, image-major."""
    ntiles = -(-n // _TILE)
    per = -(-ntiles // max(1, min(ntiles, ctas // b)))
    return per, -(-ntiles // per)


def _splits(b: int, n: int, sms: int) -> dict:
    """Each kernel's ``_tile_split`` on a card of ``sms`` SMs."""
    return {k: _tile_split(b, n, c * sms) for k, c in _CTAS_PER_SM.items()}


def _fwd_scratch(b, n, device, sms):
    """qp [B N, m] f32 and v [B N, emb] bf16 of the first kernel for the
    second, and the first kernel's partials; the tiles a CTA walks."""
    sp = _splits(b, n, sms)
    rows, f32 = b * n, torch.float32
    scratch = dict(
        qp=torch.empty(rows, _M, dtype=f32, device=device),
        v=torch.empty(rows, _EMB, dtype=torch.bfloat16, device=device),
        part=torch.empty(b * sp["fwd_sums"][1], _PART, dtype=f32,
                         device=device))
    return scratch, (sp["fwd_sums"][0], sp["fwd_apply"][0])


def _bwd_scratch(b, n, dim, device, sms):
    """The backward's scratch in the order the entry point takes it: the
    weight-gradient products' operands xn [B N, dim], [dk | dv | dq |
    dattn] and [y | h2 | a | dhh] [B N, 256] (bf16); the q kernel's dkptv /
    dkpsum and column-sum partials a CTA, the k|v kernel's, dLN1's a tile
    (of the k|v kernel), the dWkqv product's and the three 64 x 64
    products' split partials, and a row's LN1 (mean, rstd) from the q
    kernel for the k|v kernel (f32); with
    (tiles a CTA of the q and k|v kernels, the dWkqv and 64 x 64 products'
    splits)."""
    sp = _splits(b, n, sms)
    rows, bf16, f32 = b * n, torch.bfloat16, torch.float32
    splits = (_weight_grad_splits(dim, _DKQV, rows, sms),
              _weight_grad_splits(_EMB, _EMB, rows, sms))
    c1, c2 = b * sp["bwd_q"][1], b * sp["bwd_kv"][1]
    tiles = b * -(-n // _TILE)

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=device)

    scratch = dict(
        xn=new(rows, dim, dtype=bf16), dkqv=new(rows, _DKQV, dtype=bf16),
        g=new(rows, _DKQV, dtype=bf16), kpart=new(c1, _PART),
        part1=new(c1, _Q_SUMS), part2=new(c2, _KV_SUMS),
        lnpart=new(tiles, 2 * dim), dpart=new(splits[0], dim, _DKQV),
        wpart=new(3, splits[1], _EMB * _EMB), rstat=new(rows, 2))
    return scratch, (sp["bwd_q"][0], sp["bwd_kv"][0], *splits)


def _fcount(fcount, fmask):
    if not 0 < fcount <= fmask.shape[0]:
        raise ValueError(f"fcount {fcount} is not in (0, {fmask.shape[0]}]")
    return float(fcount)


@spanned("uvc.op.performer")
def performer(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2, wfc1,
              bfc1, wfc2, bfc2, *, fcount: float):
    """One performer stage: returns (out ``[B, N, emb]``, kptv ``[B, emb,
    m]`` f32, kpsum ``[B, 1, m]`` f32).

    x: ``[B, N, dim]`` in an expanded feature layout whose live slots are
    ``fmask`` (``fcount`` of them); g1 / b1 / fmask ``[dim]`` f32; wkqv
    ``[dim, 3 emb]`` stored (in, out); w ``[m, emb]`` f32 random features;
    g2 / b2 ``[emb]`` f32.  On CUDA: bf16 activations and weights, emb 64,
    m 32, dim a multiple of 8 up to 1024.  ``performer.launches`` counts
    kernel launches.  Both devices go through the operator
    ``uvc_tpu_torch.performer`` (the kernel on CUDA, the plain version on
    the CPU)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"performer runs on cpu or cuda, not {x.device}")
    return performer_op(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2,
                        b2, wfc1, bfc1, wfc2, bfc2, float(fcount))


def _performer_cuda(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                    wfc1, bfc1, wfc2, bfc2, fcount):
    ops = (x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2, wfc1, bfc1,
           wfc2, bfc2)
    b, n, dim = _check_performer(x, dict(zip(OPERANDS[1:], ops[1:])))
    fc = _fcount(fcount, fmask)
    lib = _cuda.library("performer")
    out = torch.empty((b, n, _EMB), dtype=x.dtype, device=x.device)
    kptv = torch.empty((b, _EMB, _M), dtype=torch.float32, device=x.device)
    kpsum = torch.empty((b, 1, _M), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        scratch, (per1, per2) = _fwd_scratch(
            b, n, x.device, _sm_count(x.device.index or 0))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_performer(
            *(t.data_ptr() for t in ops), out.data_ptr(), kptv.data_ptr(),
            kpsum.data_ptr(), *(t.data_ptr() for t in scratch.values()), b,
            n, dim, per1, per2, fc, stream)
    _cuda.check(err, "performer")
    performer.launches += 1
    return out, kptv, kpsum


def _performer_cpu(*operands):
    out, kptv, kpsum = performer_plain(*operands[:-1], fcount=operands[-1])
    # the operator's outputs are fresh, contiguous tensors on either device
    return out.contiguous(), kptv.contiguous(), kpsum.contiguous()


def _performer_fake(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                    wfc1, bfc1, wfc2, bfc2, fcount):
    b, n, _ = x.shape
    emb, m = wkqv.shape[1] // 3, w.shape[0]
    f32 = torch.float32
    return (x.new_empty((b, n, emb)), x.new_empty((b, emb, m), dtype=f32),
            x.new_empty((b, 1, m), dtype=f32))


performer_op = _library.define(
    "performer(Tensor x, Tensor g1, Tensor b1, Tensor wkqv, Tensor bkqv, "
    "Tensor w, Tensor fmask, Tensor wproj, Tensor bproj, Tensor g2, "
    "Tensor b2, Tensor wfc1, Tensor bfc1, Tensor wfc2, Tensor bfc2, "
    "float fcount) -> (Tensor, Tensor, Tensor)",
    cpu=_performer_cpu, cuda=_performer_cuda, fake=_performer_fake)


@spanned("uvc.op.performer_bwd")
def performer_bwd(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2, wfc1,
                  bfc1, wfc2, bfc2, kptv, kpsum, do, *, fcount: float,
                  dx: bool = True):
    """Gradients of ``performer``'s output with respect to its operands
    (named in ``GRADS``, each in its operand's dtype; ``w`` and ``fmask``
    get none), given the forward's ``kptv`` / ``kpsum`` and the output
    cotangent ``do``; with ``dx`` False no input gradient (None), the
    others unchanged.  ``performer_bwd.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return performer_bwd_plain(x, g1, b1, wkqv, bkqv, w, fmask, wproj,
                                   bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                                   kptv, kpsum, do, fcount=fcount, dx=dx)
    if x.device.type != "cuda":
        raise ValueError(f"performer_bwd runs on cpu or cuda, not {x.device}")
    ops = (x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2, wfc1, bfc1,
           wfc2, bfc2)
    b, n, dim = _check_performer(x, dict(
        zip(OPERANDS[1:], ops[1:]), kptv=kptv, kpsum=kpsum, do=do))
    fc = _fcount(fcount, fmask)
    lib = _cuda.library("performer")
    grads = [torch.empty_like(t) if t is not x or dx else None for t in
             (x, g1, b1, wkqv, bkqv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2,
              bfc2)]
    with torch.cuda.device(x.device):
        scratch, (per1, per2, splits, wsplits) = _bwd_scratch(
            b, n, dim, x.device, _sm_count(x.device.index or 0))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uvc_performer_bwd(
            *(t.data_ptr() for t in ops), kptv.data_ptr(), kpsum.data_ptr(),
            do.data_ptr(), *(0 if g is None else g.data_ptr() for g in grads),
            *(t.data_ptr() for t in scratch.values()), b, n, dim, per1, per2,
            splits, wsplits, fc, stream)
    _cuda.check(err, "performer_bwd")
    performer_bwd.launches += 1
    return tuple(grads)


performer.launches = 0
performer_bwd.launches = 0


class _FusedPerformer(torch.autograd.Function):
    """``performer`` forward, ``performer_bwd`` backward (the port of the
    JAX custom VJPs ``_fused_performer`` and ``_fused_performer_merged``);
    kptv / kpsum ride along as residuals, as at performer.py:1072-1076."""

    @staticmethod
    def forward(ctx, x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                wfc1, bfc1, wfc2, bfc2, fcount):
        out, kptv, kpsum = performer(x, g1, b1, wkqv, bkqv, w, fmask, wproj,
                                     bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                                     fcount=fcount)
        ctx.fcount = fcount
        ctx.save_for_backward(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj,
                              g2, b2, wfc1, bfc1, wfc2, bfc2, kptv, kpsum)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        # no dx where x needs none (the stem's first stage reads the image)
        (dx, dg1, db1, dwkqv, dbkqv, dwproj, dbproj, dg2, db2, dwfc1, dbfc1,
         dwfc2, dbfc2) = performer_bwd(*ctx.saved_tensors, do.contiguous(),
                                       fcount=ctx.fcount,
                                       dx=ctx.needs_input_grad[0])
        # the random features are frozen and the slot mask is a constant
        return (dx, dg1, db1, dwkqv, dbkqv, None, None, dwproj, dbproj, dg2,
                db2, dwfc1, dbfc1, dwfc2, dbfc2, None)


def fused_performer(p: dict, x: torch.Tensor, *, dtype,
                    feat_idx: Optional[np.ndarray] = None) -> torch.Tensor:
    """The whole stage with its gradient, for the performer parameter dict
    of ``models/t2t_vit.py`` (kqv / proj / mlp_fc1 / mlp_fc2 / norm1 /
    norm2 / prm_w), as at performer.py:1126-1189.

    ``feat_idx`` (int array, -1 for a dead slot) declares that ``x`` holds
    the stage input in an expanded feature layout (the space-to-depth form
    of ``s2d_stage1_inputs``, or a permutation such as ``_klast_perm``):
    the kqv rows and the LN1 affine are gathered to that layout (their
    gradients scatter back through autograd), dead slots are zeroed, and
    the LN1 statistics cover the live slots only.  The weights are cast to
    ``dtype``; LayerNorm parameters and ``prm_w`` (no gradient) stay f32.
    Under ``torch.no_grad`` it is ``performer`` itself."""
    dim = x.shape[-1]
    dev = x.device
    f32 = torch.float32
    wkqv = p["kqv"]["kernel"]
    g1, b1 = p["norm1"]["scale"].to(f32), p["norm1"]["bias"].to(f32)
    fmask = torch.ones(dim, dtype=f32, device=dev)
    fcount = float(dim)
    if feat_idx is not None:
        idx = np.asarray(feat_idx)
        valid = idx >= 0
        safe = torch.as_tensor(np.where(valid, idx, 0), device=dev)
        wkqv, g1, b1 = wkqv[safe], g1[safe], b1[safe]
        if not valid.all():
            fmask = torch.as_tensor(valid, dtype=f32, device=dev)
            wkqv = wkqv * fmask[:, None]
            g1, b1 = g1 * fmask, b1 * fmask
            fcount = float(valid.sum())
    tensors = (
        x.to(dtype), g1, b1, wkqv.to(dtype), p["kqv"]["bias"].to(dtype),
        p["prm_w"].detach().to(f32), fmask,
        p["proj"]["kernel"].to(dtype), p["proj"]["bias"].to(dtype),
        p["norm2"]["scale"].to(f32), p["norm2"]["bias"].to(f32),
        p["mlp_fc1"]["kernel"].to(dtype), p["mlp_fc1"]["bias"].to(dtype),
        p["mlp_fc2"]["kernel"].to(dtype), p["mlp_fc2"]["bias"].to(dtype))
    tensors = tuple(t.contiguous() for t in tensors)
    if not torch.is_grad_enabled():
        return performer(*tensors, fcount=fcount)[0]
    return _FusedPerformer.apply(*tensors, fcount)


def s2d_stage1_inputs(x: torch.Tensor):
    """Space-to-depth form of the stage-1 soft split (k=7, s=4, p=2), a copy
    of the JAX ``s2d_stage1_inputs``: pad to the 4-aligned grid, 4x4
    space-to-depth, and concatenate each output token's 2x2 block
    neighbourhood, which holds its 7x7 window.  Returns ([B, N, 64 C]
    tokens, feat_idx) with feat_idx mapping each expanded slot to its
    nn.Unfold (c, kh, kw) feature row (-1: dead), or (None, None) where
    the geometry does not apply."""
    b, hgt, wdt, c = x.shape
    if hgt != wdt or hgt % 4:
        return None, None
    oh = hgt // 4
    gsz = (hgt + 8) // 4
    xp = F.pad(x, (0, 0, 2, 6, 2, 6))
    s2d = xp.reshape(b, gsz, 4, gsz, 4, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, gsz, gsz, 16 * c)
    pieces = [s2d[:, bi:bi + oh, bj:bj + oh] for bi in range(2)
              for bj in range(2)]
    nb = torch.cat(pieces, dim=-1).reshape(b, oh * oh, 64 * c)
    idx = np.full((64 * c,), -1, np.int32)
    for bi in range(2):
        for bj in range(2):
            for r4 in range(4):
                for c4 in range(4):
                    ki, kj = bi * 4 + r4, bj * 4 + c4
                    if ki < 7 and kj < 7:
                        for ch in range(c):
                            src = ((bi * 2 + bj) * 16 + r4 * 4 + c4) * c + ch
                            idx[src] = ch * 49 + ki * 7 + kj
    return nb, idx
