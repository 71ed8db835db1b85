"""LN-fused attention sublayer, forward (counterpart of
``uvc_tpu/ops/attention.py``).

``layer_attention_ln`` computes ``x + proj(mask * MHA(LN1(x)))`` for a
``[B, N, dm]`` residual stream.  A CUDA tensor goes to the hand-written
kernel (``csrc/attention.cu``, the port of ``_layer_ln_fwd_kernel``); a CPU
tensor goes to ``layer_attention_ln_plain``, the same function in plain
PyTorch with the kernel's rounding order.  There is no other route.
"""

from __future__ import annotations

import torch

from uvc_tpu_torch.ops import _cuda

# the kernel's limits: head dim, and keys held in shared memory at once
_HEAD_DIM = 64
_MAX_TOKENS = 768


def _ln_rows(x32, gamma, beta, eps):
    """Row layernorm in f32 (twin of the JAX ``_ln_rows``).  Returns
    (a_in, xhat, inv)."""
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    return xhat * gamma + beta, xhat, inv


def layer_attention_ln_plain(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                             num_heads: int, scale: float, eps: float):
    """Plain PyTorch version of the kernel, rounded where the Pallas body
    rounds: LN output, qkv, ctx and ctx * mask to ``x.dtype``; logits,
    softmax and the residual sum in f32, with the softmax normalisation
    applied after P @ V.  In f32 every rounding is the identity and this is
    the JAX CPU composition."""
    dt = x.dtype
    b, n, _ = x.shape
    da = wqkv.shape[1] // 3            # attention width (!= dm when compact)
    dh = da // num_heads
    x32 = x.float()
    a_in = _ln_rows(x32, g1.float(), b1.float(), eps)[0].to(dt)
    qkv = (a_in.float() @ wqkv.float() + bqkv.float()).to(dt)
    q, k, v = qkv.view(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    ctx = ((p.to(dt).float() @ v.float()) / p.sum(dim=-1, keepdim=True))
    ctx = ctx.to(dt).transpose(1, 2).reshape(b, n, da)
    ctx = (ctx.float() * mask.to(dt).float()).to(dt)
    out = ctx.float() @ wproj.float() + bproj.float()
    return (x32 + out).to(dt)


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


def _layer_attention_ln_cuda(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                             num_heads, scale, eps):
    bf16, f32 = torch.bfloat16, torch.float32
    named = dict(x=x, g1=g1, b1=b1, wqkv=wqkv, bqkv=bqkv, wproj=wproj,
                 bproj=bproj, mask=mask)
    _check_cuda(x, named, dict(x=bf16, g1=f32, b1=f32, wqkv=bf16, bqkv=bf16,
                               wproj=bf16, bproj=bf16, mask=bf16))
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, dm], got {tuple(x.shape)}")
    b, n, dm = x.shape
    da = num_heads * _HEAD_DIM
    want = dict(g1=(dm,), b1=(dm,), wqkv=(dm, 3 * da), bqkv=(3 * da,),
                wproj=(da, dm), bproj=(dm,), mask=(da,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for {num_heads} heads "
                             f"of {_HEAD_DIM}, got {tuple(named[name].shape)}")
    if dm % 8 or not 0 < n <= _MAX_TOKENS or b == 0:
        raise ValueError(f"unsupported x shape {tuple(x.shape)}: dm must be "
                         f"a multiple of 8 and 0 < N <= {_MAX_TOKENS}")
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


def layer_attention_ln(x, g1, b1, wqkv, bqkv, wproj, bproj, mask, *,
                       num_heads: int, scale: float, eps: float):
    """``x + (mask * MHA(LN1(x) @ wqkv + bqkv)) @ wproj + bproj``.

    x: ``[B, N, dm]``; g1/b1: ``[dm]`` f32; wqkv ``[dm, 3*da]`` and wproj
    ``[da, dm]`` stored (in, out); mask: ``[da]`` structural keep mask over
    the ctx columns.  On CUDA: bf16 activations and weights, head dim 64.
    ``layer_attention_ln.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return layer_attention_ln_plain(
            x, g1, b1, wqkv, bqkv, wproj, bproj, mask, num_heads=num_heads,
            scale=scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_attention_ln runs on cpu or cuda, "
                         f"not {x.device}")
    return _layer_attention_ln_cuda(
        x, g1, b1, wqkv, bqkv, wproj, bproj, mask, num_heads=num_heads,
        scale=scale, eps=eps)


layer_attention_ln.launches = 0
