"""LN-fused MLP sublayer, plain and with the block-gating blend, forward
and backward (counterpart of ``uvc_tpu/ops/mlp.py``).

``mlp_ln`` computes ``x + (mask * gelu(LN2(x) @ fc1 + b1)) @ fc2 + b2``;
``mlp_ln_blend`` computes ``d1 * mlp_ln(x) + d0 * xin`` for the gated
block; ``mlp_ln_bwd`` / ``mlp_ln_blend_bwd`` are their gradients and
``fused_mlp_ln`` / ``fused_mlp_ln_blend`` each pair as one
``torch.autograd.Function``.  A CUDA tensor goes to the hand-written
kernels (``csrc/mlp.cu``, the ports of ``_mlp_ln_fwd_kernel``,
``_mlp_ln_blend_fwd_kernel``, ``_mlp_ln_bwd_kernel`` and
``_mlp_ln_blend_bwd_kernel``); a CPU tensor goes to the plain PyTorch
versions, which keep the kernels' rounding order.  There is no other
route.  Models wider than the backward kernels (dm > 1280) take
``mlp_ln_bwd_composed`` / ``mlp_ln_blend_bwd_composed``, the autograd of
the JAX package's composition, as the JAX package does where its kernels'
VMEM budget refuses the width.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from uvc_tpu_torch.ops import _cuda, _library
from uvc_tpu_torch.ops.attention import (_MAX_DM_BWD, _check_cuda,
                                         _ln_bwd_floats, _ln_rows,
                                         _sm_count, _weight_grad_splits)


def _residual_sum32(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    """f32 ``x + mlp(LN2(x))`` with the LN output and the masked GELU output
    rounded to ``x.dtype``, as the Pallas bodies round them.  GELU is the
    exact erf form."""
    dt = x.dtype
    x32 = x.float()
    m_in = _ln_rows(x32, g2.float(), b2.float(), eps)[0].to(dt)
    h = m_in.float() @ wfc1.float() + bfc1.float()
    a = F.gelu(h) * mask.float()
    return x32 + (a.to(dt).float() @ wfc2.float() + bfc2.float())


def mlp_ln_plain(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *, eps: float):
    """Plain version of ``_mlp_ln_fwd_kernel`` (the counterpart of the JAX
    ``_composed_mlp_ln``).  In f32 every rounding is the identity and this
    is the JAX CPU composition."""
    return _residual_sum32(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                           eps).to(x.dtype)


def mlp_ln_blend_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *,
                       eps: float):
    """Plain version of ``_mlp_ln_blend_fwd_kernel`` (the counterpart of
    the JAX ``_composed_mlp_ln_blend``): ``d1 * (x + mlp) + d0 * xin`` in
    f32, rounded once to ``x.dtype``."""
    s = _residual_sum32(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps)
    d = d.float()
    return (d[1] * s + d[0] * xin.float()).to(x.dtype)


def _check_mlp(x, xin, d, named, max_dm=None):
    """The kernels' checks of the MLP sublayer's operands (``named``
    without x, xin and d); returns (B, N, dm, F)."""
    bf16, f32 = torch.bfloat16, torch.float32
    named = dict(named, x=x)
    if xin is not None:
        named.update(xin=xin, d=d)
    _check_cuda(x, named, {k: f32 if k in ("g2", "b2", "d") else bf16
                           for k in named})
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, dm], got {tuple(x.shape)}")
    b, n, dm = x.shape
    f = named["wfc1"].shape[-1]
    want = dict(g2=(dm,), b2=(dm,), wfc1=(dm, f), bfc1=(f,), wfc2=(f, dm),
                bfc2=(dm,), mask=(f,), xin=tuple(x.shape), d=(2,),
                do=tuple(x.shape))
    for name, t in named.items():
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
    if dm % 8 or f % 8 or b * n == 0 or (max_dm and dm > max_dm):
        limit = "" if max_dm is None else f", dm <= {max_dm}"
        raise ValueError(f"unsupported widths dm={dm}, F={f} or empty x: "
                         f"dm and F must be multiples of 8{limit}")
    return b, n, dm, f


def _mlp_cuda(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    bf16 = torch.bfloat16
    b, n, dm, f = _check_mlp(x, xin, d, dict(
        g2=g2, b2=b2, wfc1=wfc1, bfc1=bfc1, wfc2=wfc2, bfc2=bfc2, mask=mask))
    lib = _cuda.library("mlp")
    rows = b * n
    a_in = torch.empty((rows, dm), dtype=bf16, device=x.device)
    hidden = torch.empty((rows, f), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common = (g2.data_ptr(), b2.data_ptr(), wfc1.data_ptr(),
                  bfc1.data_ptr(), wfc2.data_ptr(), bfc2.data_ptr(),
                  mask.data_ptr(), a_in.data_ptr(), hidden.data_ptr(),
                  out.data_ptr(), rows, dm, f, float(eps), stream)
        if xin is None:
            err = lib.uvc_mlp_ln(x.data_ptr(), *common)
        else:
            err = lib.uvc_mlp_ln_blend(x.data_ptr(), xin.data_ptr(),
                                       d.data_ptr(), *common)
    return out, err


def mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *, eps: float):
    """``x + (mask * gelu(LN2(x) @ wfc1 + bfc1)) @ wfc2 + bfc2``.

    x: ``[B, N, dm]``; g2/b2 ``[dm]`` f32; wfc1 ``[dm, F]``, wfc2 ``[F, dm]``
    stored (in, out); mask ``[F]``.  On CUDA: bf16 activations and weights.
    ``mlp_ln.launches`` counts kernel launches.  Both devices go through
    the operator ``uvc_tpu_torch.mlp_ln`` (the kernel on CUDA, the plain
    version on the CPU)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp_ln runs on cpu or cuda, not {x.device}")
    return mlp_ln_op(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, float(eps))


def _mlp_ln_cuda(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    out, err = _mlp_cuda(x, None, None, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                         eps)
    _cuda.check(err, "mlp_ln")
    mlp_ln.launches += 1
    return out


def _mlp_ln_cpu(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    return mlp_ln_plain(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps=eps)


def _mlp_ln_fake(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    return torch.empty_like(x)


mlp_ln_op = _library.define(
    "mlp_ln(Tensor x, Tensor g2, Tensor b2, Tensor wfc1, Tensor bfc1, "
    "Tensor wfc2, Tensor bfc2, Tensor mask, float eps) -> Tensor",
    cpu=_mlp_ln_cpu, cuda=_mlp_ln_cuda, fake=_mlp_ln_fake)


def mlp_ln_blend(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *,
                 eps: float):
    """``d[1] * (x + mlp_sublayer(LN2(x))) + d[0] * xin``: the gated
    block's MLP half and the block-gating blend.  ``d`` is the ``[2]`` f32
    (skip, keep) distribution.  ``mlp_ln_blend.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return mlp_ln_blend_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2,
                                  mask, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_ln_blend runs on cpu or cuda, not {x.device}")
    out, err = _mlp_cuda(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps)
    _cuda.check(err, "mlp_ln_blend")
    mlp_ln_blend.launches += 1
    return out


mlp_ln.launches = 0
mlp_ln_blend.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _mlp_bwd_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do,
                   eps):
    """The backward of both Pallas bodies in their rounding order
    (``_mlp_ln_bwd_kernel``, and ``_mlp_ln_blend_bwd_kernel`` when ``xin``
    is given): LN2 and ``h = m_in . W1 + b1`` recomputed; ``a = gelu(h)``,
    ``am32 = a * mask`` and ``am = bf16(am32)``; ``dam0 = do . W2^T`` and
    ``dam = d1 * dam0``; ``dh = dam * mask * gelu'(h)`` rounded to bf16
    before ``dW1`` and ``dmi = dh . W1^T``; the LN VJP in f32 plus
    ``d1 * do``.  The blend's gating gradients are the identities of
    mlp.py:185-188, so the pre-blend output is never formed:
    ``dd1 = sum(dam0 * am32) + sum(do * x) + colsum(do) . b2``,
    ``dd0 = sum(do * xin)``, ``dxin = d0 * do``.  One pass over all hidden
    units: the Pallas hidden-group split is a VMEM work-around whose parts
    sum to the same gradients."""
    dt = x.dtype
    dm = x.shape[-1]
    f = wfc1.shape[-1]
    x32 = x.float()
    m32, xhat, inv = _ln_rows(x32, g2.float(), b2.float(), eps)
    m_in = m32.to(dt).float()
    h = m_in @ wfc1.float() + bfc1.float()
    phi = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    a = h * phi
    maskv = mask.float()
    am32 = a * maskv
    am = am32.to(dt).float()
    dob = do.to(dt).float()
    do32 = do.float()
    d1 = d.float()[1] if d is not None else 1.0
    dam0 = dob @ wfc2.float().T                        # [B, N, F]
    dam = dam0 * d1
    dh = dam * maskv * (phi + h * pdf)
    dh_b = dh.to(dt).float()
    dmi = dh_b @ wfc1.float().T                         # [B, N, dm]
    dg = dmi * g2.float()
    m1 = dg.mean(dim=-1, keepdim=True)
    m2 = (dg * xhat).mean(dim=-1, keepdim=True)
    dz = (dg - m1 - xhat * m2) * inv
    rows = (0, 1)
    colsum_do = do32.sum(rows)
    grads = dict(
        dx=(dz + d1 * do32).to(dt),
        dg2=(dmi * xhat).sum(rows).to(g2.dtype),
        db2=dmi.sum(rows).to(b2.dtype),
        dwfc1=(m_in.reshape(-1, dm).T @ dh_b.reshape(-1, f)).to(wfc1.dtype),
        dbfc1=dh.sum(rows).to(bfc1.dtype),
        dwfc2=(d1 * (am.reshape(-1, f).T @ dob.reshape(-1, dm))).to(
            wfc2.dtype),
        dbfc2=(d1 * colsum_do).to(bfc2.dtype),
        dmask=(dam * a).sum(rows).to(mask.dtype))
    if xin is not None:
        dd1 = ((dam0 * am32).sum() + (do32 * x32).sum()
               + (colsum_do * bfc2.float()).sum())
        dd0 = (do32 * xin.float()).sum()
        grads.update(dxin=(d.float()[0] * do32).to(xin.dtype),
                     dd=torch.stack([dd0, dd1]).to(d.dtype))
    return grads


_MLP_GRADS = ("dx", "dg2", "db2", "dwfc1", "dbfc1", "dwfc2", "dbfc2",
              "dmask")
_BLEND_GRADS = ("dx", "dxin", "dd", "dg2", "db2", "dwfc1", "dbfc1", "dwfc2",
                "dbfc2", "dmask")


def mlp_ln_bwd_plain(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do, *,
                     eps: float):
    """Plain version of ``_mlp_ln_bwd_kernel``: the gradients of
    (x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask), each in its input's dtype.
    In f32 this is the autodiff of the JAX CPU composition."""
    g = _mlp_bwd_plain(x, None, None, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                       do, eps)
    return tuple(g[k] for k in _MLP_GRADS)


def mlp_ln_blend_bwd_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                           do, *, eps: float):
    """Plain version of ``_mlp_ln_blend_bwd_kernel``: the gradients of
    (x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask), each in its input's
    dtype."""
    g = _mlp_bwd_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do,
                       eps)
    return tuple(g[k] for k in _BLEND_GRADS)


# the backward's h and dam0 products (csrc/gemm_wg.cuh::gemm_act_bwd_kernel)
# run 128 x 128 tiles
_ACT_TILE = 128


def _mlp_bwd_scratch(rows, dm, f, device, sms):
    """The scratch of the MLP backward kernels (A6, A4) in their entry
    points' order and the split counts of dW2 and dW1 over the B*N rows.
    ``part`` holds, one after the other, the h product's per-tile partials
    (dmask and db1 a 128-row tile), the split-K partials of either weight
    gradient and the LayerNorm backward's partials and sums
    (``_ln_bwd_floats``); ``sums`` the LayerNorm backward's sums, then the
    h product's partials of dd1's term ``sum(dam0 * am)``, one a tile."""
    bf16, f32 = torch.bfloat16, torch.float32
    splits = (_weight_grad_splits(f, dm, rows, sms),
              _weight_grad_splits(dm, f, rows, sms))
    tm, tn = -(-rows // _ACT_TILE), -(-f // _ACT_TILE)
    part = max(2 * tm * f, splits[0] * f * dm, splits[1] * dm * f,
               _ln_bwd_floats(rows, dm))

    def new(*shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device=device)

    scratch = dict(m_in=new(rows, dm), am=new(rows, f), dh=new(rows, f),
                   dmi=new(rows, dm, dtype=f32), part=new(part, dtype=f32),
                   sums=new(3 * dm + 2 + tm * tn, dtype=f32))
    return scratch, splits


def _mlp_bwd_cuda(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do, eps):
    f32 = torch.float32
    b, n, dm, f = _check_mlp(x, xin, d, dict(
        g2=g2, b2=b2, wfc1=wfc1, bfc1=bfc1, wfc2=wfc2, bfc2=bfc2, mask=mask,
        do=do), max_dm=_MAX_DM_BWD)
    lib = _cuda.library("mlp")
    rows = b * n
    scratch, splits = _mlp_bwd_scratch(rows, dm, f, x.device,
                                       _sm_count(x.device.index or 0))
    grads = dict(dx=torch.empty_like(x), dg2=x.new_empty(dm, dtype=f32),
                 db2=x.new_empty(dm, dtype=f32), dwfc1=torch.empty_like(wfc1),
                 dbfc1=torch.empty_like(bfc1), dwfc2=torch.empty_like(wfc2),
                 dbfc2=torch.empty_like(bfc2), dmask=torch.empty_like(mask))
    tail = (*(grads[k].data_ptr() for k in _MLP_GRADS[1:]), rows, dm, f,
            *splits, float(eps))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [t.data_ptr() for t in scratch.values()]
        if xin is None:
            err = lib.uvc_mlp_ln_bwd(
                x.data_ptr(), g2.data_ptr(), b2.data_ptr(), wfc1.data_ptr(),
                bfc1.data_ptr(), wfc2.data_ptr(), mask.data_ptr(),
                do.data_ptr(), *ptrs, grads["dx"].data_ptr(), *tail, stream)
        else:
            grads.update(dxin=torch.empty_like(xin),
                         dd=torch.empty_like(d))
            err = lib.uvc_mlp_ln_blend_bwd(
                x.data_ptr(), xin.data_ptr(), d.data_ptr(), g2.data_ptr(),
                b2.data_ptr(), wfc1.data_ptr(), bfc1.data_ptr(),
                wfc2.data_ptr(), bfc2.data_ptr(), mask.data_ptr(),
                do.data_ptr(), *ptrs, grads["dx"].data_ptr(),
                grads["dxin"].data_ptr(), grads["dd"].data_ptr(), *tail,
                stream)
    return grads, err


def mlp_ln_bwd(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do, *, eps: float):
    """Gradients of ``mlp_ln`` with respect to its eight tensor inputs,
    given the output cotangent ``do``.  ``mlp_ln_bwd.launches`` counts
    kernel launches."""
    if x.device.type == "cpu":
        return mlp_ln_bwd_plain(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do,
                                eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_ln_bwd runs on cpu or cuda, not {x.device}")
    grads, err = _mlp_bwd_cuda(x, None, None, g2, b2, wfc1, bfc1, wfc2, bfc2,
                               mask, do, eps)
    _cuda.check(err, "mlp_ln_bwd")
    mlp_ln_bwd.launches += 1
    return tuple(grads[k] for k in _MLP_GRADS)


def mlp_ln_blend_bwd(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do, *,
                     eps: float):
    """Gradients of ``mlp_ln_blend`` with respect to its ten tensor inputs
    (``dd`` in ``d``'s f32), given the output cotangent ``do``.
    ``mlp_ln_blend_bwd.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return mlp_ln_blend_bwd_plain(x, xin, d, g2, b2, wfc1, bfc1, wfc2,
                                      bfc2, mask, do, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_ln_blend_bwd runs on cpu or cuda, "
                         f"not {x.device}")
    grads, err = _mlp_bwd_cuda(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2,
                               mask, do, eps)
    _cuda.check(err, "mlp_ln_blend_bwd")
    mlp_ln_blend_bwd.launches += 1
    return tuple(grads[k] for k in _BLEND_GRADS)


mlp_ln_bwd.launches = 0
mlp_ln_blend_bwd.launches = 0


def _composed_mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    """The JAX package's ``_composed_mlp_ln``: LN2 in f32 rounded to
    ``x.dtype``, then every product and elementwise step in ``x.dtype``,
    GELU the exact erf form."""
    m_in = _ln_rows(x.float(), g2.float(), b2.float(), eps)[0].to(x.dtype)
    h = F.gelu(m_in @ wfc1 + bfc1) * mask
    return x + (h @ wfc2 + bfc2)


def _composed_mlp_ln_blend(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                           eps):
    """The JAX package's ``_composed_mlp_ln_blend``:
    ``d1 * (x + mlp(LN2(x))) + d0 * xin`` in ``x.dtype``."""
    out = _composed_mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps)
    dt = d.to(x.dtype)
    return dt[1] * out + dt[0] * xin


def _composed_grads(fn, args, do, eps):
    """torch.autograd of ``fn`` (recomputed) at ``args``, cotangent ``do``:
    what ``jax.vjp`` of the composition gives the reference."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*leaves, eps), leaves, do)


def mlp_ln_bwd_composed(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, do, *,
                        eps: float):
    """The gradients of ``mlp_ln`` as the JAX package takes them where its
    backward kernel does not fit (``_fused_mlp_ln_bwd``'s last resort,
    ``uvc_tpu/ops/mlp.py``:415-420): the autograd of the composition,
    whose matrix products are ``torch.matmul`` in the operands' dtype, as
    XLA's are in the reference.  ``mlp_ln_bwd_composed.calls`` counts its
    calls."""
    mlp_ln_bwd_composed.calls += 1
    return _composed_grads(_composed_mlp_ln, (x, g2, b2, wfc1, bfc1, wfc2,
                                              bfc2, mask), do, eps)


def mlp_ln_blend_bwd_composed(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2,
                              mask, do, *, eps: float):
    """The gradients of ``mlp_ln_blend`` as the JAX package takes them where
    its backward kernel does not fit (``_fused_mlp_ln_blend_bwd``,
    ``uvc_tpu/ops/mlp.py``:643-646): the autograd of the composition.
    ``mlp_ln_blend_bwd_composed.calls`` counts its calls."""
    mlp_ln_blend_bwd_composed.calls += 1
    return _composed_grads(_composed_mlp_ln_blend, (
        x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask), do, eps)


mlp_ln_bwd_composed.calls = 0
mlp_ln_blend_bwd_composed.calls = 0


class _FusedMlpLN(torch.autograd.Function):
    """``mlp_ln`` forward, ``mlp_ln_bwd`` backward, or
    ``mlp_ln_bwd_composed`` at ``dm > 1280`` (the port of the JAX custom
    VJP ``_fused_mlp_ln``)."""

    @staticmethod
    def forward(ctx, x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask)
        return mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps=eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        wide = ctx.saved_tensors[0].shape[-1] > _MAX_DM_BWD
        bwd = mlp_ln_bwd_composed if wide else mlp_ln_bwd
        grads = bwd(*ctx.saved_tensors, do.contiguous(), eps=ctx.eps)
        return (*grads, None)


class _FusedMlpLNBlend(torch.autograd.Function):
    """``mlp_ln_blend`` forward, ``mlp_ln_blend_bwd`` backward, or
    ``mlp_ln_blend_bwd_composed`` at ``dm > 1280`` (the port of the JAX
    custom VJP ``_fused_mlp_ln_blend``)."""

    @staticmethod
    def forward(ctx, x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2,
                              mask)
        return mlp_ln_blend(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                            eps=eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        wide = ctx.saved_tensors[0].shape[-1] > _MAX_DM_BWD
        bwd = mlp_ln_blend_bwd_composed if wide else mlp_ln_blend_bwd
        grads = bwd(*ctx.saved_tensors, do.contiguous(), eps=ctx.eps)
        return (*grads, None)


def fused_mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *, eps: float):
    """``mlp_ln`` with its gradient (forward and backward kernels); under
    ``torch.no_grad`` it is ``mlp_ln`` itself."""
    if not torch.is_grad_enabled():
        return mlp_ln(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps=eps)
    return _FusedMlpLN.apply(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps)


def fused_mlp_ln_blend(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, *,
                       eps: float):
    """``mlp_ln_blend`` with its gradient (forward and backward kernels);
    under ``torch.no_grad`` it is ``mlp_ln_blend`` itself."""
    if not torch.is_grad_enabled():
        return mlp_ln_blend(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                            eps=eps)
    return _FusedMlpLNBlend.apply(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2,
                                  mask, eps)
