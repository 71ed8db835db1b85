"""T2T-ViT architecture-ablation zoo: the SE, Ghost and Dense variants
(counterpart of ``uvc_tpu/models/t2t_ablations.py``).

All three run the tokens-to-token stem and the fixed sinusoid position
embedding of ``models/t2t_vit.py`` (the performer kernels), then an
unrolled per-block forward whose attention core is ``attention_core``
(kernel A9 on the card).  The LayerNorms, linears, GELU, the SE gate and
the Ghost cheap ops are plain PyTorch, as the JAX package leaves them to
XLA outside any Pallas kernel:

* SE (t2t_vit_se.py:22-87): squeeze-excitation after the attention
  projection: token mean, C -> C/16 -> C bottleneck, sigmoid channel gate;
* Ghost (t2t_vit_ghost.py:24-110): half-width q / k / v completed by
  "cheap" depthwise 1x1 convolutions (per-channel scalars), and a ghost
  MLP ``fc2([x1, cheap2(x1), cheap3(x1)])``;
* Dense (t2t_vit_dense.py:23-110): each block appends a
  ``growth_rate``-wide projection of its output to its input, with
  width-halving transitions between stages.

The parameters are the T2T tree with ``ablation_blocks``, a list of
per-block dicts, in place of the stacked ``blocks``; linears built without
a bias hold ``None`` there, as in the JAX package.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.models import t2t_vit, vit
from uvc_tpu_torch.models.vit import (ForwardOutput, _layer_norm, _to_device,
                                      _trunc_normal)
from uvc_tpu_torch.ops.attention import attention_core

VARIANTS = ("se", "ghost", "dense")


def _lin(gen, fi, fo, bias=True):
    return {"kernel": _trunc_normal(gen, (fi, fo)),
            "bias": torch.zeros(fo) if bias else None}


def _apply_lin(p, x, dtype):
    y = x @ p["kernel"].to(dtype)
    if p.get("bias") is not None:
        y = y + p["bias"].to(dtype)
    return y


def _ln(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _mlp_init(gen, d, f):
    return {"fc1": _lin(gen, d, f), "fc2": _lin(gen, f, d)}


def _mlp_apply(p, x, dtype):
    h = F.gelu(_apply_lin(p["fc1"], x, dtype))
    return _apply_lin(p["fc2"], h, dtype)


def _heads(t, b, n, num_heads):
    """``[B, N, D] -> [B, H, N, D / H]``."""
    return t.reshape(b, n, num_heads, -1).transpose(1, 2)


def _attn_apply(p, x, num_heads, scale, dtype):
    b, n, d = x.shape
    qkv = _apply_lin(p["qkv"], x, dtype).reshape(b, n, 3, num_heads,
                                                 d // num_heads)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    ctx = attention_core(q, k, v, scale).to(dtype)
    return _apply_lin(p["proj"], ctx.transpose(1, 2).reshape(b, n, d), dtype)


# ---------------------------------------------------------------------------
# SE variant
# ---------------------------------------------------------------------------


def _se_init(gen, d, reduction=16):
    r = max(d // reduction, 1)
    return {"fc1": _lin(gen, d, r, bias=False),
            "fc2": _lin(gen, r, d, bias=False)}


def _se_apply(p, x, dtype):
    """SELayer (t2t_vit_se.py:22-41): token mean, bottleneck and sigmoid
    channel gate in f32, the gate cast to the working dtype."""
    y = x.float().mean(dim=1)                            # [B, C]
    y = torch.relu(y @ p["fc1"]["kernel"].float())
    y = torch.sigmoid(y @ p["fc2"]["kernel"].float())
    return x * y[:, None, :].to(dtype)


# ---------------------------------------------------------------------------
# Ghost variant
# ---------------------------------------------------------------------------


def _ghost_attn_init(gen, d, qkv_bias=False):
    half = d // 2
    return {
        "q": _lin(gen, d, half, bias=qkv_bias),
        "k": _lin(gen, d, half, bias=qkv_bias),
        "v": _lin(gen, d, half, bias=qkv_bias),
        # Conv1d(k=1, groups=C) == per-channel scalar weight
        "cheap_q": torch.ones(half),
        "cheap_k": torch.ones(half),
        "cheap_v": torch.ones(half),
        "proj": _lin(gen, d, d),
    }


def _ghost_attn_apply(p, x, num_heads, scale, dtype):
    """Attention_ghost (t2t_vit_ghost.py:56-98): half-width projections
    completed by cheap per-channel ops, concatenated to full width."""
    b, n, d = x.shape

    def full(name):
        t = _apply_lin(p[name], x, dtype)
        t = torch.cat([t, t * p[f"cheap_{name}"].to(dtype)], dim=-1)
        return _heads(t, b, n, num_heads)

    ctx = attention_core(full("q"), full("k"), full("v"), scale).to(dtype)
    return _apply_lin(p["proj"], ctx.transpose(1, 2).reshape(b, n, d), dtype)


def _ghost_mlp_init(gen, d, f):
    return {"fc1": _lin(gen, d, d), "cheap2": torch.ones(d),
            "cheap3": torch.ones(d), "fc2": _lin(gen, 3 * d, d)}


def _ghost_mlp_apply(p, x, dtype):
    """Mlp_ghost (t2t_vit_ghost.py:24-55)."""
    x1 = F.gelu(_apply_lin(p["fc1"], x, dtype))
    x2 = F.gelu(x1 * p["cheap2"].to(dtype))
    x3 = F.gelu(x1 * p["cheap3"].to(dtype))
    return _apply_lin(p["fc2"], torch.cat([x1, x2, x3], dim=-1), dtype)


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------


def dense_plan(cfg: ViTConfig):
    """The Dense variant's (kind, width) sequence and its final width, kept
    out of the parameter tree as in the JAX package."""
    plan = []
    dim = cfg.embed_dim
    for si, n_layers in enumerate(cfg.dense_block_config):
        for _ in range(n_layers):
            plan.append(("block", dim))
            dim += cfg.growth_rate
        if si != len(cfg.dense_block_config) - 1:
            plan.append(("transition", dim))
            dim //= 2
    return plan, dim


def init_params(generator: torch.Generator, cfg: ViTConfig, *,
                device="cuda", **_ignored) -> dict:
    """An ablation's parameter tree in the JAX package's layout: the T2T
    tree of ``t2t_vit.init_tree`` with ``ablation_blocks`` in place of
    ``blocks`` (and, for Dense, ``norm`` and a zero ``head`` at the final
    width).  Extra keywords are accepted and ignored, as in the JAX
    package.  ``generator`` is a CPU ``torch.Generator``; the draws differ
    from ``jax.random``'s."""
    dev = resolve_device(device)
    if cfg.tokens_type not in ("performer", "transformer") \
            or cfg.t2t_variant not in VARIANTS:
        raise ValueError(f"{cfg.name} is not a T2T architecture ablation")
    gen = generator
    d, f = cfg.embed_dim, cfg.mlp_hidden
    base = t2t_vit.init_tree(gen, cfg)
    del base["blocks"]
    blocks: List[dict] = []
    if cfg.t2t_variant in ("se", "ghost"):
        for _ in range(cfg.depth):
            blk = {"ln1": _ln(d), "ln2": _ln(d)}
            if cfg.t2t_variant == "se":
                blk["qkv"] = _lin(gen, d, 3 * d, bias=cfg.qkv_bias)
                blk["proj"] = _lin(gen, d, d)
                blk["se"] = _se_init(gen, d)
                blk["mlp"] = _mlp_init(gen, d, f)
            else:
                blk.update(_ghost_attn_init(gen, d, cfg.qkv_bias))
                blk["mlp"] = _ghost_mlp_init(gen, d, f)
            blocks.append(blk)
    else:
        plan, final_dim = dense_plan(cfg)
        for kind, dim in plan:
            if kind == "transition":
                blocks.append({"lin": _lin(gen, dim, dim // 2)})
                continue
            blocks.append({
                "ln1": _ln(dim),
                "qkv": _lin(gen, dim, 3 * dim, bias=cfg.qkv_bias),
                "proj": _lin(gen, dim, dim),
                "ln2": _ln(dim),
                "mlp": _mlp_init(gen, dim, int(dim * cfg.mlp_ratio)),
                "dense_linear": _lin(gen, dim, cfg.growth_rate),
            })
        base["norm"] = _ln(final_dim)
        base["head"] = {"kernel": torch.zeros(final_dim, cfg.num_classes),
                        "bias": torch.zeros(cfg.num_classes)}
    base["ablation_blocks"] = blocks
    return _to_device(base, dev)


def apply(params: dict, x: torch.Tensor, cfg: ViTConfig, *, rng=None,
          train: bool = False, dtype=torch.float32,
          **_ignored) -> ForwardOutput:
    """The ablation forward (t2t_vit_se.py / _ghost.py / _dense.py).  It has
    no dropout, drop-path, gating or token selection: those arguments, and
    the others ``vit.apply`` takes, are accepted and ignored, as in the JAX
    package."""
    eps = cfg.layer_norm_eps
    variant = cfg.t2t_variant
    plan = dense_plan(cfg)[0] if variant == "dense" else None
    t = t2t_vit.embed(params, x, cfg, dtype)
    for li, blk in enumerate(params["ablation_blocks"]):
        if plan is not None and plan[li][0] == "transition":
            t = F.gelu(_apply_lin(blk["lin"], t, dtype))
            continue
        dim = t.shape[-1]
        scale = (cfg.qk_scale if cfg.qk_scale is not None
                 else (dim // cfg.num_heads) ** -0.5)
        z = _layer_norm(t, blk["ln1"]["scale"], blk["ln1"]["bias"], eps)
        if variant == "ghost":
            a = _ghost_attn_apply(blk, z, cfg.num_heads, scale, dtype)
        else:
            a = _attn_apply(blk, z, cfg.num_heads, scale, dtype)
            if variant == "se":
                a = _se_apply(blk["se"], a, dtype)
        t2 = t + a
        z = _layer_norm(t2, blk["ln2"]["scale"], blk["ln2"]["bias"], eps)
        mlp = _ghost_mlp_apply if variant == "ghost" else _mlp_apply
        new_t = t2 + mlp(blk["mlp"], z, dtype)
        if variant == "dense":
            # the block's input grows by a projection of its output
            t = torch.cat([t, _apply_lin(blk["dense_linear"], new_t, dtype)],
                          dim=-1)
        else:
            t = new_t
    t = _layer_norm(t, params["norm"]["scale"], params["norm"]["bias"], eps)
    logits = t[:, 0].float() @ params["head"]["kernel"] \
        + params["head"]["bias"]
    return ForwardOutput(logits=logits, logits_kd=logits, token_mask=None)


eval_logits = vit.eval_logits
