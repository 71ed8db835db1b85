"""CaiT, the class-attention baseline backbone (counterpart of
``uvc_tpu/models/cait.py``).

``depth`` LayerScale blocks of talking-heads self-attention over the
patch tokens only, then ``cls_attn_layers`` LayerScale class-attention
blocks that update the class token against the frozen patch tokens, and
the classifier on the class token.  The talking heads mix the attention
logits across heads on both sides of the softmax (``proj_l`` / ``proj_w``,
``[H, H]``), which rules out the fused per-head attention kernels: as in
the JAX package, which composes this model in XLA, the forward is a
PyTorch composition and launches no kernel of the port.

Rounding follows the JAX package: the q . k logits, both head mixes and
the softmax in f32, the attention weights cast to the compute dtype
before their product with v (accumulated in f32, rounded once), the
linear layers and the exact GELU in the compute dtype, the LayerNorms in
f32.  The position embedding covers the patch tokens only; the class
token joins after the self-attention stack.

``apply`` takes the UVC gating, mask, token and drop-path arguments of
``vit.apply`` and ignores them, as the JAX function does: CaiT is a
baseline comparison model, not on the compression path, and a CaiT
baseline run has no stochastic depth even with a drop-path rate.
"""

from __future__ import annotations

import torch

from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.models import vit
from uvc_tpu_torch.models.vit import (ForwardOutput, _layer_norm, _linear,
                                      _stack, _to_device, _trunc_normal)
from uvc_tpu_torch.utils.tree import tree_map


def _ln(n, d):
    return {"scale": torch.ones(n, d), "bias": torch.zeros(n, d)}


def init_params(generator: torch.Generator, cfg: ViTConfig, *,
                device="cuda", **_ignored) -> dict:
    """A CaiT parameter tree in the JAX package's layout (per-block leaves
    stacked on a leading axis: ``blocks`` L, ``blocks_ca``
    ``cls_attn_layers``): truncated normal kernels and tokens, zero
    biases, LayerScale ``gamma1`` / ``gamma2`` at ``cfg.layer_scale_init``,
    a zero head.  ``generator`` is a CPU ``torch.Generator``; the draws
    are the port's own.  Extra keywords (``patch_gating``) are ignored."""
    dev = resolve_device(device)
    d, l, f, h = cfg.embed_dim, cfg.depth, cfg.mlp_hidden, cfg.num_heads
    ca = cfg.cls_attn_layers
    gen = generator

    def stack(n, fi, fo):
        return _stack([_linear(gen, fi, fo) for _ in range(n)])

    def scales(n):
        return torch.full((n, d), cfg.layer_scale_init)

    params = {
        "patch_embed": {
            "kernel": _trunc_normal(
                gen, (cfg.patch_size, cfg.patch_size, cfg.in_chans, d)),
            "bias": torch.zeros(d)},
        "cls_token": _trunc_normal(gen, (1, 1, d)),
        "pos_embed": _trunc_normal(gen, (1, cfg.num_patches, d)),
        "blocks": {
            "ln1": _ln(l, d), "qkv": stack(l, d, 3 * d),
            "proj": stack(l, d, d), "proj_l": stack(l, h, h),
            "proj_w": stack(l, h, h), "ln2": _ln(l, d),
            "fc1": stack(l, d, f), "fc2": stack(l, f, d),
            "gamma1": scales(l), "gamma2": scales(l),
        },
        "blocks_ca": {
            "ln1": _ln(ca, d), "q": stack(ca, d, d), "k": stack(ca, d, d),
            "v": stack(ca, d, d), "proj": stack(ca, d, d),
            "ln2": _ln(ca, d), "fc1": stack(ca, d, f),
            "fc2": stack(ca, f, d), "gamma1": scales(ca),
            "gamma2": scales(ca),
        },
        "norm": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "head": {"kernel": torch.zeros(d, cfg.num_classes),
                 "bias": torch.zeros(cfg.num_classes)},
    }
    return _to_device(params, dev)


def _dense(x, lin, dtype):
    return x @ lin["kernel"].to(dtype) + lin["bias"].to(dtype)


def _talking_head_attention(x, blk, num_heads, scale, dtype):
    """Talking-heads self-attention: the ``[H, H]`` logit mixes straddle
    the softmax, all three in f32."""
    b, n, d = x.shape
    hs = d // num_heads
    qkv = _dense(x, blk["qkv"], dtype).reshape(b, n, 3, num_heads, hs)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)      # [B, H, N, hs]
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    logits = (torch.einsum("bhqk,hg->bgqk", logits,
                           blk["proj_l"]["kernel"].float())
              + blk["proj_l"]["bias"].float()[:, None, None])
    attn = torch.softmax(logits, dim=-1)
    attn = (torch.einsum("bhqk,hg->bgqk", attn,
                         blk["proj_w"]["kernel"].float())
            + blk["proj_w"]["bias"].float()[:, None, None])
    ctx = (attn.to(dtype).float() @ v.float()).to(dtype)
    ctx = ctx.transpose(1, 2).reshape(b, n, d)
    return _dense(ctx, blk["proj"], dtype)


def _class_attention(x_cls, x_all, blk, num_heads, scale, dtype):
    """Class attention: the query from the class token only."""
    b, n, d = x_all.shape
    hs = d // num_heads
    q = _dense(x_cls, blk["q"], dtype).reshape(b, 1, num_heads, hs)
    k = _dense(x_all, blk["k"], dtype).reshape(b, n, num_heads, hs)
    v = _dense(x_all, blk["v"], dtype).reshape(b, n, num_heads, hs)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, *, hs]
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    ctx = (attn.float() @ v.float()).to(dtype)          # [B, H, 1, hs]
    return _dense(ctx.transpose(1, 2).reshape(b, 1, d), blk["proj"], dtype)


def _mlp(x, blk, dtype):
    h = torch.nn.functional.gelu(_dense(x, blk["fc1"], dtype))
    return _dense(h, blk["fc2"], dtype)


def _unbind(tree, n):
    """A block stack (leaves ``[n, ...]``) as its n blocks: one unbind a
    leaf, whose backward stacks the blocks' gradients once."""
    parts = tree_map(lambda v: v.unbind(0), tree)
    return [tree_map(lambda _, u: u[i], tree, parts) for i in range(n)]


def apply(params: dict, x: torch.Tensor, cfg: ViTConfig, *,
          dtype=torch.float32, **_ignored) -> ForwardOutput:
    """The forward (patch embedding, self-attention stack, class-attention
    stack, final LayerNorm, head) in ``dtype``; differentiable.  Every
    other keyword of ``vit.apply`` is accepted and ignored."""
    eps = cfg.layer_norm_eps
    scale = cfg.head_size ** -0.5
    b = x.shape[0]
    t = vit.patch_embed(params, x, cfg, dtype)              # [B, N, D]
    t = t + params["pos_embed"].to(dtype)
    for blk in _unbind(params["blocks"], cfg.depth):
        a = _talking_head_attention(
            _layer_norm(t, blk["ln1"]["scale"], blk["ln1"]["bias"], eps),
            blk, cfg.num_heads, scale, dtype)
        t = t + blk["gamma1"].to(dtype) * a
        m = _mlp(_layer_norm(t, blk["ln2"]["scale"], blk["ln2"]["bias"],
                             eps), blk, dtype)
        t = t + blk["gamma2"].to(dtype) * m

    cls = params["cls_token"].expand(b, 1, cfg.embed_dim).to(dtype)
    for blk in _unbind(params["blocks_ca"], cfg.cls_attn_layers):
        u = _layer_norm(torch.cat([cls, t], dim=1), blk["ln1"]["scale"],
                        blk["ln1"]["bias"], eps)
        a = _class_attention(u[:, :1], u, blk, cfg.num_heads, scale, dtype)
        cls = cls + blk["gamma1"].to(dtype) * a
        m = _mlp(_layer_norm(cls, blk["ln2"]["scale"], blk["ln2"]["bias"],
                             eps), blk, dtype)
        cls = cls + blk["gamma2"].to(dtype) * m

    u = _layer_norm(torch.cat([cls, t], dim=1), params["norm"]["scale"],
                    params["norm"]["bias"], eps)
    logits = u[:, 0].float() @ params["head"]["kernel"] + \
        params["head"]["bias"]
    return ForwardOutput(logits=logits, logits_kd=logits, token_mask=None)


eval_logits = vit.eval_logits
