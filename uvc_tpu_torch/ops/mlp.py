"""LN-fused MLP sublayer, forward, plain and with the block-gating blend
(counterpart of ``uvc_tpu/ops/mlp.py``).

``mlp_ln`` computes ``x + (mask * gelu(LN2(x) @ fc1 + b1)) @ fc2 + b2``;
``mlp_ln_blend`` computes ``d1 * mlp_ln(x) + d0 * xin`` for the gated
block.  A CUDA tensor goes to the hand-written kernels (``csrc/mlp.cu``,
the ports of ``_mlp_ln_fwd_kernel`` and ``_mlp_ln_blend_fwd_kernel``); a
CPU tensor goes to the plain PyTorch versions, which keep the kernels'
rounding order.  There is no other route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops.attention import _check_cuda, _ln_rows


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


def _mlp_cuda(x, xin, d, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps):
    bf16, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, g2=g2, b2=b2, wfc1=wfc1, bfc1=bfc1, wfc2=wfc2,
                 bfc2=bfc2, mask=mask)
    dtypes = dict(x=bf16, g2=f32, b2=f32, wfc1=bf16, bfc1=bf16, wfc2=bf16,
                  bfc2=bf16, mask=bf16)
    if xin is not None:
        named.update(xin=xin, d=d)
        dtypes.update(xin=bf16, d=f32)
    _check_cuda(x, named, dtypes)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, dm], got {tuple(x.shape)}")
    b, n, dm = x.shape
    f = wfc1.shape[-1]
    want = dict(g2=(dm,), b2=(dm,), wfc1=(dm, f), bfc1=(f,), wfc2=(f, dm),
                bfc2=(dm,), mask=(f,), xin=tuple(x.shape), d=(2,))
    for name, t in named.items():
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
    if dm % 8 or f % 8 or b * n == 0:
        raise ValueError(f"unsupported widths dm={dm}, F={f} or empty x: "
                         "dm and F must be multiples of 8")
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
    ``mlp_ln.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return mlp_ln_plain(x, g2, b2, wfc1, bfc1, wfc2, bfc2, mask, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_ln runs on cpu or cuda, not {x.device}")
    out, err = _mlp_cuda(x, None, None, g2, b2, wfc1, bfc1, wfc2, bfc2, mask,
                         eps)
    _cuda.check(err, "mlp_ln")
    mlp_ln.launches += 1
    return out


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
