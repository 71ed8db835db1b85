"""DeiT / ViT forward for training, eval and serving (counterpart of
``uvc_tpu/models/vit.py``).

Parameters are plain nested dicts of tensors in the JAX package's layout:
per-block tensors stacked on a leading layer axis, linear kernels stored
(in, out), ``patch_embed.kernel`` ``[P, P, C, D]``; images are NHWC.  The
block stack is a Python loop over layers whose two sublayers are the
LN-fused kernels of ``uvc_tpu_torch.ops`` behind their autograd wrappers
(the block-gating blend fused into the MLP sublayer when a gating
distribution is given), so the same forward trains and serves.

A block whose sublayer output is scaled before the residual add (part
gating, drop-path) runs the separate-LN branch instead: the LayerNorm in
PyTorch, then the bare attention sublayer kernel (``fused_layer_attention``,
the port of ``_layer_fwd_kernel``) and the composed MLP (library matmuls,
as in the JAX package).

Random numbers come in as tensors: the Gumbel token draw's ``[B, N]``
noise as ``rng``, the drop-path keep decisions as ``drop_path`` ``[L, 2,
B]`` (``sample_drop_path`` draws them).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.models import resnet
from uvc_tpu_torch.ops.attention import (fused_layer_attention,
                                         fused_layer_attention_ln)
from uvc_tpu_torch.ops.gumbel import (gather_tokens_with_pos,
                                      gumbel_topk_mask,
                                      physical_topk_indices, token_scores,
                                      topk_token_mask)
from uvc_tpu_torch.ops.mlp import fused_mlp_ln, fused_mlp_ln_blend
from uvc_tpu_torch.utils.tree import tree_map

_NOT_PORTED = "{} is not ported yet; see ROADMAP.md"


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _trunc_normal(gen, shape, std=0.02):
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return std * t


def _linear(gen, fan_in, fan_out):
    return {"kernel": _trunc_normal(gen, (fan_in, fan_out)),
            "bias": torch.zeros(fan_out)}


def _stack(items):
    return {k: torch.stack([it[k] for it in items]) for k in items[0]}


def init_params(generator: torch.Generator, cfg: ViTConfig, *,
                patch_gating: bool = False, device="cuda") -> dict:
    """A DeiT/ViT parameter tree in the JAX package's layout and init rules
    (``uvc_tpu/models/vit.py::init_params``): truncated normal (std 0.02,
    cut at 2 std) for kernels and tokens, zero biases, unit LayerNorm
    scales, zero-initialised classifier heads, gating logits ``[-1, 1]``
    per layer.  ``generator`` is a CPU ``torch.Generator``; the tensors are
    made on the CPU and moved to ``device``.  The draws differ from
    ``jax.random``'s: tests carry JAX weights across with
    ``interop.params_from_numpy`` instead."""
    dev = resolve_device(device)
    if cfg.tokens_type != "none" or cfg.cls_attn_layers:
        raise ValueError(f"{cfg.name} is not of the DeiT / ViT family; "
                         "its module is get_model(cfg)")
    return _to_device(init_tree(generator, cfg, patch_gating=patch_gating),
                      dev)


def init_tree(generator: torch.Generator, cfg: ViTConfig, *,
              patch_gating: bool = False) -> dict:
    """The parameter tree of ``init_params`` on the CPU, for any backbone
    that shares the DeiT block stack (the T2T models replace its patch
    embedding).  The R50 hybrid's patch embedding is a 1 x 1 kernel
    ``[1, 1, 1024 * width, D]`` behind the ResNetV2 stem (``resnet``)."""
    d, l, f, p = cfg.embed_dim, cfg.depth, cfg.mlp_hidden, cfg.patch_size
    gen = generator
    pe_shape = ((1, 1, 64 * cfg.resnet_width * 16, d) if cfg.hybrid
                else (p, p, cfg.in_chans, d))
    params = {
        "patch_embed": {"kernel": _trunc_normal(gen, pe_shape),
                        "bias": torch.zeros(d)},
        "cls_token": _trunc_normal(gen, (1, 1, d)),
        "pos_embed": _trunc_normal(gen, (1, cfg.seq_len, d)),
        "blocks": {
            "ln1": {"scale": torch.ones(l, d), "bias": torch.zeros(l, d)},
            "qkv": _stack([_linear(gen, d, 3 * d) for _ in range(l)]),
            "proj": _stack([_linear(gen, d, d) for _ in range(l)]),
            "ln2": {"scale": torch.ones(l, d), "bias": torch.zeros(l, d)},
            "fc1": _stack([_linear(gen, d, f) for _ in range(l)]),
            "fc2": _stack([_linear(gen, f, d) for _ in range(l)]),
        },
        "norm": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "head": {"kernel": torch.zeros(d, cfg.num_classes),
                 "bias": torch.zeros(cfg.num_classes)},
        "block_gating": torch.tensor([-1.0, 1.0]).repeat(l, 1),
        "attn_gating": torch.tensor([-1.0, 1.0]).repeat(l, 1),
        "mlp_gating": torch.tensor([-1.0, 1.0]).repeat(l, 1),
        "token_scorer": _linear(gen, d, 1),
    }
    if cfg.distilled:
        params["dist_token"] = _trunc_normal(gen, (1, 1, d))
        params["head_dist"] = {"kernel": torch.zeros(d, cfg.num_classes),
                               "bias": torch.zeros(cfg.num_classes)}
    if patch_gating:
        params["patch_gating"] = torch.full((1, cfg.num_patches, 1), 3.0)
    if cfg.hybrid:
        params["resnet"] = resnet.init_resnet_stem(gen, cfg.resnet_layers,
                                                   cfg.resnet_width)
    return params


def _to_device(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _attention_ln(x, blk, num_heads, scale, attn_mask_row, eps, dtype):
    mask = (attn_mask_row.to(dtype) if attn_mask_row is not None
            else torch.ones(x.shape[-1], dtype=dtype, device=x.device))
    return fused_layer_attention_ln(
        x, blk["ln1"]["scale"], blk["ln1"]["bias"],
        blk["qkv"]["kernel"].to(dtype), blk["qkv"]["bias"].to(dtype),
        blk["proj"]["kernel"].to(dtype), blk["proj"]["bias"].to(dtype), mask,
        num_heads=num_heads, scale=scale, eps=eps)


def _attention(x, blk, num_heads, scale, attn_mask_row, dtype):
    """The bare attention sublayer ``proj(mask * MHA(x))`` (kernel A7), no
    LayerNorm, no residual."""
    mask = (attn_mask_row.to(dtype) if attn_mask_row is not None
            else torch.ones(x.shape[-1], dtype=dtype, device=x.device))
    return fused_layer_attention(
        x, blk["qkv"]["kernel"].to(dtype), blk["qkv"]["bias"].to(dtype),
        blk["proj"]["kernel"].to(dtype), blk["proj"]["bias"].to(dtype), mask,
        num_heads=num_heads, scale=scale)


def _mlp(x, blk, mlp_mask_row, dtype):
    """The composed MLP branch: fc1, exact GELU in the compute dtype, the
    structural unit mask, fc2 (library matmuls, as in the JAX package)."""
    h = x @ blk["fc1"]["kernel"].to(dtype) + blk["fc1"]["bias"].to(dtype)
    h = torch.nn.functional.gelu(h)
    if mlp_mask_row is not None:
        h = h * mlp_mask_row.to(dtype)
    return h @ blk["fc2"]["kernel"].to(dtype) + blk["fc2"]["bias"].to(dtype)


def _drop_path(branch, keep_row, rate: float):
    """Stochastic depth on a residual branch (timm DropPath): the ``[B]``
    keep decisions zero whole samples, survivors are divided by ``1 -
    rate`` rounded to the branch dtype, as the JAX body divides."""
    keep = float(torch.tensor(1.0 - rate, dtype=torch.float32).to(
        branch.dtype))
    return branch * keep_row.to(branch.dtype)[:, None, None] / keep


def drop_path_rates(depth: int, rate: float) -> list:
    """Per-layer drop rates ``linspace(0, rate, depth)`` in f32."""
    return torch.linspace(0.0, rate, depth, dtype=torch.float32).tolist()


def sample_drop_path(generator: torch.Generator, depth: int, rate: float,
                     batch: int) -> torch.Tensor:
    """``[L, 2, B]`` bool keep decisions (layer, attention / MLP branch,
    image), each kept with probability ``1 - rates[layer]``; drawn on the
    generator's device."""
    keep = 1.0 - torch.tensor(drop_path_rates(depth, rate))
    u = torch.rand((depth, 2, batch), generator=generator,
                   device=generator.device)
    return u < keep.to(u.device)[:, None, None]


def _mlp_args(blk, mlp_mask_row, dtype, device):
    f = blk["fc1"]["kernel"].shape[-1]
    mask = (mlp_mask_row.to(dtype) if mlp_mask_row is not None
            else torch.ones(f, dtype=dtype, device=device))
    return (blk["ln2"]["scale"], blk["ln2"]["bias"],
            blk["fc1"]["kernel"].to(dtype), blk["fc1"]["bias"].to(dtype),
            blk["fc2"]["kernel"].to(dtype), blk["fc2"]["bias"].to(dtype),
            mask)


def patch_embed(params: dict, x: torch.Tensor, cfg: ViTConfig,
                dtype=torch.float32) -> torch.Tensor:
    """Non-overlapping patchify of NHWC images as reshape + one matmul, in
    the JAX package's patch order (row-major patches, (p, p, C) inside).
    The R50 hybrid runs its ResNetV2 stem first (in ``dtype``) and its
    1 x 1 patch kernel on the stem's ``[B, g * g, C]`` features; the
    product is a contiguous residual stream, as the kernels take it."""
    b = x.shape[0]
    if cfg.hybrid:
        feat = resnet.apply_resnet_stem(params["resnet"], x.to(dtype),
                                        cfg.resnet_layers)
        g, c = feat.shape[1], feat.shape[-1]
        feat = feat.reshape(b, g * g, c)
        kernel = params["patch_embed"]["kernel"].reshape(c, cfg.embed_dim)
        return (feat @ kernel.to(dtype)
                + params["patch_embed"]["bias"].to(dtype))
    p = cfg.patch_size
    g = cfg.img_size // p
    x = x.reshape(b, g, p, g, p, cfg.in_chans)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * cfg.in_chans)
    kernel = params["patch_embed"]["kernel"].reshape(
        p * p * cfg.in_chans, cfg.embed_dim)
    return (x.to(dtype) @ kernel.to(dtype)
            + params["patch_embed"]["bias"].to(dtype))


class ForwardOutput(NamedTuple):
    logits: torch.Tensor
    logits_kd: torch.Tensor    # distillation-head logits (== logits when
                               # there is no dist head)
    token_mask: Optional[torch.Tensor]


def apply(params: dict, x: torch.Tensor, cfg: ViTConfig, *,
          gating_distrib: Optional[torch.Tensor] = None,
          attn_distrib: Optional[torch.Tensor] = None,
          mlp_distrib: Optional[torch.Tensor] = None,
          masks: Optional[Dict[str, torch.Tensor]] = None,
          tau: float = -1.0,
          patch_ratio: float = 0.9,
          patch_gate_mode: int = 0,
          patch_hard: bool = False,
          patch_physical: bool = False,
          jumping: bool = False,
          rng=None,
          train: bool = False,
          drop_path_rate: float = 0.0,
          drop_path: Optional[torch.Tensor] = None,
          dtype=torch.float32) -> ForwardOutput:
    """Forward with the JAX ``apply``'s arguments and semantics;
    differentiable (the sublayers are ``torch.autograd.Function``s).

    gating_distrib: ``[L, 2]`` per-block (skip, keep) distribution, or None
    for ungated blocks.  attn_distrib / mlp_distrib: ``[L, 2]`` part-gating
    distributions, the sublayer output scaled by ``[1]`` and its input by
    ``[0]``.  masks: ``{"attn": [L, D], "mlp": [L, F]}`` or None.
    patch_gate_mode 1 applies the sigmoid patch gate (hard with
    ``patch_hard``); mode 2 (or a positive ``tau``) selects
    ``int(patch_ratio * N)`` tokens: with ``rng`` None by the deterministic
    top-k, zero-masked or, with ``patch_physical``, gathered; with ``rng``
    the ``[B, N]`` Gumbel noise of the straight-through top-k mask at
    temperature ``tau`` (``x * mask``, never gathered).  With ``train`` and
    ``drop_path_rate > 0``, stochastic depth at the per-layer rates
    ``linspace(0, drop_path_rate, L)``, whose keep decisions ``drop_path``
    ``[L, 2, B]`` must be given.  A PRNG key as ``rng`` raises
    NotImplementedError."""
    if rng is not None and not torch.is_tensor(rng):
        raise NotImplementedError(_NOT_PORTED.format(
            "a PRNG key as rng (pass the [B, N] Gumbel token noise)"))
    eps = cfg.layer_norm_eps
    b = x.shape[0]
    x = patch_embed(params, x, cfg, dtype)  # [B, N, D]

    if patch_gate_mode == 1 and "patch_gating" in params:
        gate = torch.sigmoid(params["patch_gating"]).to(dtype)
        if patch_hard:
            hard = (gate >= 0.5).to(dtype)
            hard[:, 0] = 1.0
            x = x * hard
        else:
            x = x * gate

    token_mask = None
    token_select = patch_gate_mode == 2 or (
        isinstance(tau, (int, float)) and tau > 0)
    physical = token_select and patch_physical and rng is None
    idx = None
    if token_select:
        k = int(patch_ratio * cfg.num_patches)
        scores = token_scores(x, params["token_scorer"])  # [B, N]
        if physical:
            idx = physical_topk_indices(scores, k)
        else:
            if rng is None:
                token_mask = topk_token_mask(scores, k)
            else:
                token_mask = gumbel_topk_mask(rng, scores, k, tau)
            x = x * token_mask[..., None].to(dtype)

    tokens = [params["cls_token"].expand(b, 1, cfg.embed_dim).to(dtype)]
    if cfg.distilled:
        tokens.append(params["dist_token"].expand(
            b, 1, cfg.embed_dim).to(dtype))
    if physical:
        x = gather_tokens_with_pos(x, idx, tokens, params["pos_embed"], dtype)
    else:
        x = torch.cat(tokens + [x], dim=1) + params["pos_embed"].to(dtype)

    x = transformer_encode(
        params, x, cfg, gating_distrib=gating_distrib,
        attn_distrib=attn_distrib, mlp_distrib=mlp_distrib, masks=masks,
        jumping=jumping,
        drop_path_rate=drop_path_rate if train else 0.0,
        drop_path=drop_path, dtype=dtype)

    cls = x[:, 0].float()
    logits = cls @ params["head"]["kernel"] + params["head"]["bias"]
    if cfg.distilled:
        dist = x[:, 1].float()
        logits_kd = dist @ params["head_dist"]["kernel"] \
            + params["head_dist"]["bias"]
    else:
        logits_kd = logits
    return ForwardOutput(logits=logits, logits_kd=logits_kd,
                         token_mask=token_mask)


def _per_block(t: Optional[torch.Tensor], depth: int):
    """A stacked ``[L, ...]`` leaf as its L blocks (L Nones for None): one
    unbind, whose backward stacks the blocks' gradients once, where a
    select per block would fill and add L dense ``[L, ...]`` gradients (the
    reference's ``lax.scan`` over the stacked leaves stacks them once
    too)."""
    return [None] * depth if t is None else t.unbind(0)


def transformer_encode(params: dict, x: torch.Tensor, cfg: ViTConfig, *,
                       gating_distrib=None, attn_distrib=None,
                       mlp_distrib=None, masks=None, jumping: bool = False,
                       drop_path_rate: float = 0.0,
                       drop_path: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """The block stack + final LN, routed as the JAX package routes it.

    A sublayer without a branch coefficient (no part gating, no drop-path)
    is one LN-fused kernel with the residual inside; with one, the
    separate-LN branch (``_attention`` / ``_mlp``) is scaled before the
    add.  The block-gating blend ``d1 * block(h) + d0 * h`` is fused into
    the MLP sublayer when there is a gating distribution, no MLP part
    gating and no drop-path; otherwise it runs after the block.
    ``jumping`` sums every block's output into the final representation."""
    eps = cfg.layer_norm_eps
    scale = cfg.qk_scale if cfg.qk_scale is not None else cfg.head_size ** -0.5
    use_dp = drop_path_rate > 0.0
    if use_dp:
        if drop_path is None:
            raise ValueError("drop_path_rate > 0 needs the drop_path keep "
                             "decisions [L, 2, B]")
        rates = drop_path_rates(cfg.depth, drop_path_rate)
    depth = cfg.depth
    blocks = {name: {k: _per_block(v, depth) for k, v in sub.items()}
              for name, sub in params["blocks"].items()}
    attn_ms, mlp_ms = (_per_block(None if masks is None else masks[k], depth)
                       for k in ("attn", "mlp"))
    distribs, a_ds, m_ds = (_per_block(t, depth) for t in (
        gating_distrib, attn_distrib, mlp_distrib))
    h = x
    accum = torch.zeros_like(x) if jumping else None
    for i in range(cfg.depth):
        blk = {name: {k: v[i] for k, v in sub.items()}
               for name, sub in blocks.items()}
        attn_m, mlp_m = attn_ms[i], mlp_ms[i]
        distrib, a_d, m_d = distribs[i], a_ds[i], m_ds[i]

        if a_d is None and not use_dp:
            z = _attention_ln(h, blk, cfg.num_heads, scale, attn_m, eps,
                              dtype)
        else:
            a_in = _layer_norm(h, blk["ln1"]["scale"], blk["ln1"]["bias"],
                               eps)
            a_out = _attention(a_in, blk, cfg.num_heads, scale, attn_m,
                               dtype)
            if use_dp:
                a_out = _drop_path(a_out, drop_path[i, 0], rates[i])
            z = (a_d[0].to(dtype) * h + a_d[1].to(dtype) * a_out
                 if a_d is not None else h + a_out)

        if distrib is not None and m_d is None and not use_dp:
            h = fused_mlp_ln_blend(z, h, distrib.float(),
                                   *_mlp_args(blk, mlp_m, dtype, x.device),
                                   eps=eps)
        else:
            if m_d is None and not use_dp:
                out = fused_mlp_ln(z, *_mlp_args(blk, mlp_m, dtype, x.device),
                                   eps=eps)
            else:
                m_in = _layer_norm(z, blk["ln2"]["scale"], blk["ln2"]["bias"],
                                   eps)
                m_out = _mlp(m_in, blk, mlp_m, dtype)
                if use_dp:
                    m_out = _drop_path(m_out, drop_path[i, 1], rates[i])
                out = (m_d[0].to(dtype) * z + m_d[1].to(dtype) * m_out
                       if m_d is not None else z + m_out)
            if distrib is not None:
                out = distrib[1].to(dtype) * out + distrib[0].to(dtype) * h
            h = out
        if jumping:
            accum = accum + h
    if jumping:
        h = accum
    return _layer_norm(h, params["norm"]["scale"], params["norm"]["bias"],
                       eps)


def eval_logits(out: ForwardOutput, cfg: ViTConfig) -> torch.Tensor:
    """Average of the cls and dist predictions for distilled models."""
    if cfg.distilled:
        return (out.logits + out.logits_kd) / 2.0
    return out.logits
