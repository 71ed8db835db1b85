"""Physical model compaction for serving (counterpart of
``uvc_tpu/infer/compact.py``).

The discovered architecture becomes a physically smaller model: blocks the
gating skips are removed, attention heads whose columns are all pruned are
sliced out of q/k/v/proj (within-head pruned dims stay as zero rows of
proj), and MLP hidden units are gathered to the kept set, padded to a
multiple of 128 (never beyond dense).  Each kept layer then runs the same
LN-fused sublayer kernels as the dense model, at its own widths.  The
compacted model is built once in its serving dtype, so a forward passes
its tensors to the kernels as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from uvc_tpu_torch.compress.resource import build_macs_table
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.models import get_model, vit
from uvc_tpu_torch.models.vit import ForwardOutput, _layer_norm
from uvc_tpu_torch.ops.attention import layer_attention_ln
from uvc_tpu_torch.ops.gumbel import (gather_tokens_with_pos,
                                      physical_topk_indices, token_scores)
from uvc_tpu_torch.ops.mlp import mlp_ln
from uvc_tpu_torch.utils.profiler import span
from uvc_tpu_torch.utils.tree import tree_map


# kept MLP units are padded to a multiple of this, as the JAX package pads
# them, so that a compacted layer has the same shapes in both packages (the
# parity tests compare them); the kernels themselves need a multiple of 8
_UNIT_PAD = 128
# top-level tensors that enter the forward in the serving dtype; the final
# LayerNorm, the heads and the token scorer stay f32, as in the eval forward
_TOP_CAST = ("patch_embed", "cls_token", "dist_token", "pos_embed")


def _pad_to(n: int) -> int:
    return max(_UNIT_PAD, -(-n // _UNIT_PAD) * _UNIT_PAD)


def layer_plans(masks: Dict[str, torch.Tensor], cfg: ViTConfig, *,
                block_keep: np.ndarray) -> List[dict]:
    """Per-kept-layer slicing plan: the original block id, the kept heads'
    q/k/v column gather, the within-head v-mask and the padded kept MLP
    units (numpy, as in the JAX package)."""
    attn_keep = np.asarray(masks["attn"].detach().cpu())   # [L, D]
    mlp_keep = np.asarray(masks["mlp"].detach().cpu())     # [L, F]
    l, d = attn_keep.shape
    h, hs = cfg.num_heads, cfg.head_size
    plans = []
    for i in range(l):
        if not bool(block_keep[i]):
            continue
        keep_dims = attn_keep[i].reshape(h, hs)
        kept_heads = np.nonzero(keep_dims.any(axis=1))[0]
        hk = max(len(kept_heads), 1)
        if len(kept_heads) == 0:
            kept_heads = np.array([0])
        cols = np.concatenate(
            [np.arange(hh * hs, (hh + 1) * hs) for hh in kept_heads])
        sel3 = np.concatenate([cols, d + cols, 2 * d + cols])
        vmask = keep_dims[kept_heads].reshape(-1)          # [hk * hs]
        kept_units = np.nonzero(mlp_keep[i] > 0)[0]
        fk = min(_pad_to(len(kept_units)), mlp_keep.shape[1])
        plans.append({"layer_id": i, "hk": int(hk), "cols": cols,
                      "sel3": sel3, "vmask": vmask,
                      "kept_units": kept_units, "fk": int(fk)})
    return plans


def _tree_to(tree, dev, dtype=None):
    return tree_map(lambda t: t.detach().to(dev, dtype), tree)


def _check_stack(cfg: ViTConfig) -> None:
    if cfg.t2t_variant != "none":
        raise NotImplementedError(
            f"{cfg.name}: the T2T architecture ablations have no stacked "
            "blocks to compact (nor in the JAX package); see ROADMAP.md")


def compact_model(params: dict, masks: Dict[str, torch.Tensor],
                  cfg: ViTConfig, *,
                  block_keep: Optional[np.ndarray] = None,
                  dtype=torch.bfloat16, device="cuda"
                  ) -> Tuple[List[dict], dict]:
    """Slice the pruned architecture out of the parameters.

    Returns (layers, top): per-kept-layer weight dicts at layer-specific
    widths, and the shared top-level parameters, all on ``device``.  The
    layers' matrices and biases, their all-ones ctx and hidden masks, and
    the patch embedding, class/distillation tokens and position embedding
    are in ``dtype``, the dtype ``apply_compact`` is then called with;
    LayerNorm parameters, heads and the token scorer stay f32.
    ``block_keep`` defaults to the frozen gating decision ``g1 > g0``."""
    _check_stack(cfg)
    dev = resolve_device(device)
    blocks = _tree_to(params["blocks"], dev)
    d = masks["attn"].shape[1]
    if block_keep is None:
        g = params["block_gating"].detach().cpu()
        block_keep = (g[:, 1] > g[:, 0]).numpy()

    layers = []
    for plan in layer_plans(masks, cfg, block_keep=block_keep):
        i = plan["layer_id"]
        cols = torch.as_tensor(plan["cols"], device=dev)
        sel3 = torch.as_tensor(plan["sel3"], device=dev)
        vmask = torch.as_tensor(plan["vmask"], device=dev)
        units = torch.as_tensor(plan["kept_units"], device=dev)
        fk, nk = plan["fk"], len(plan["kept_units"])
        fc1 = torch.zeros((d, fk), dtype=dtype, device=dev)
        fc1_b = torch.zeros((fk,), dtype=dtype, device=dev)
        fc2 = torch.zeros((fk, d), dtype=dtype, device=dev)
        if nk:
            fc1[:, :nk] = blocks["fc1"]["kernel"][i][:, units]
            fc1_b[:nk] = blocks["fc1"]["bias"][i][units]
            fc2[:nk, :] = blocks["fc2"]["kernel"][i][units, :]
        layers.append({
            "ln1": {"scale": blocks["ln1"]["scale"][i],
                    "bias": blocks["ln1"]["bias"][i]},
            "qkv": {"kernel": blocks["qkv"]["kernel"][i][:, sel3].to(dtype),
                    "bias": blocks["qkv"]["bias"][i][sel3].to(dtype)},
            "proj": {"kernel": (blocks["proj"]["kernel"][i][cols, :]
                                * vmask[:, None]).to(dtype),
                     "bias": blocks["proj"]["bias"][i].to(dtype)},
            "ln2": {"scale": blocks["ln2"]["scale"][i],
                    "bias": blocks["ln2"]["bias"][i]},
            "fc1": {"kernel": fc1, "bias": fc1_b},
            "fc2": {"kernel": fc2,
                    "bias": blocks["fc2"]["bias"][i].to(dtype)},
            # the within-head vmask is folded into proj's rows above and
            # the pruned units are gone, so both kernel masks are all ones
            "ctx_mask": torch.ones(len(plan["cols"]), dtype=dtype,
                                   device=dev),
            "hidden_mask": torch.ones(fk, dtype=dtype, device=dev),
            "num_heads": plan["hk"],
        })

    # the R50 hybrid's stem stays f32 and runs in the forward's dtype
    top_keys = ["patch_embed", "cls_token", "pos_embed", "norm", "head",
                "dist_token", "head_dist", "resnet", "t2t", "token_scorer"]
    top = {k: _tree_to(params[k], dev, dtype if k in _TOP_CAST else None)
           for k in top_keys if k in params}
    return layers, top


def _embed_vit(top, x, cfg, dtype, token_ratio):
    """Patch embedding, class / distillation tokens and the learned position
    embedding, with the physical token drop at ``token_ratio``."""
    b = x.shape[0]
    t = vit.patch_embed(top, x, cfg, dtype)
    tokens = [top["cls_token"].expand(b, 1, cfg.embed_dim).to(dtype)]
    if cfg.distilled and "dist_token" in top:
        tokens.append(top["dist_token"].expand(b, 1, cfg.embed_dim).to(dtype))
    if token_ratio is not None and token_ratio < 1.0 \
            and "token_scorer" in top:
        k = int(token_ratio * cfg.num_patches)
        idx = physical_topk_indices(token_scores(t, top["token_scorer"]), k)
        return gather_tokens_with_pos(t, idx, tokens, top["pos_embed"], dtype)
    return torch.cat(tokens + [t], dim=1) + top["pos_embed"].to(dtype)


def apply_compact(layers: List[dict], top: dict, x: torch.Tensor,
                  cfg: ViTConfig, *, dtype=torch.bfloat16,
                  token_ratio: Optional[float] = None) -> ForwardOutput:
    """Inference forward of the compacted model.

    ``token_ratio`` physically drops tokens with the trained token scorer:
    only the top ``int(ratio * N)`` patch tokens per image (token 0
    force-kept) enter the transformer, by the same rule as the eval
    forward's ``patch_physical`` selection (ViT/DeiT family; the T2T
    forward selects no tokens).  ``dtype`` is the one the model was
    compacted in.  The T2T family runs its stem (``t2t_vit.embed``, the
    performer kernels) before the kept layers; the attention scale is
    ``cfg.qk_scale`` where the config sets it, as in the trained
    forward."""
    _check_stack(cfg)
    with span("uvc.serve"):
        return _apply_compact(layers, top, x, cfg, dtype, token_ratio)


def _apply_compact(layers, top, x, cfg, dtype, token_ratio):
    eps = cfg.layer_norm_eps
    with span("uvc.embed"):
        if cfg.tokens_type != "none":
            t = get_model(cfg).embed(top, x, cfg, dtype)
        else:
            t = _embed_vit(top, x, cfg, dtype, token_ratio)

    scale = cfg.qk_scale if cfg.qk_scale is not None else cfg.head_size ** -0.5
    for blk in layers:
        t = layer_attention_ln(
            t, blk["ln1"]["scale"], blk["ln1"]["bias"],
            blk["qkv"]["kernel"], blk["qkv"]["bias"],
            blk["proj"]["kernel"], blk["proj"]["bias"], blk["ctx_mask"],
            num_heads=blk["num_heads"], scale=scale, eps=eps)
        t = mlp_ln(
            t, blk["ln2"]["scale"], blk["ln2"]["bias"],
            blk["fc1"]["kernel"], blk["fc1"]["bias"],
            blk["fc2"]["kernel"], blk["fc2"]["bias"], blk["hidden_mask"],
            eps=eps)

    with span("uvc.head"):
        t = _layer_norm(t, top["norm"]["scale"], top["norm"]["bias"], eps)
        logits = (t[:, 0].float() @ top["head"]["kernel"]
                  + top["head"]["bias"])
        if cfg.distilled and "head_dist" in top:
            logits_kd = (t[:, 1].float() @ top["head_dist"]["kernel"]
                         + top["head_dist"]["bias"])
        else:
            logits_kd = logits
    return ForwardOutput(logits=logits, logits_kd=logits_kd,
                         token_mask=None)


def compact_flops_fraction(layers: List[dict], cfg: ViTConfig,
                           token_ratio: Optional[float] = None) -> float:
    """Fraction of dense FLOPs the compact model computes."""
    table = build_macs_table(cfg)
    n = cfg.seq_len
    d = cfg.embed_dim
    macs = float(table.embed)
    if token_ratio is not None and token_ratio < 1.0:
        n = (cfg.seq_len - cfg.num_patches) + int(
            token_ratio * cfg.num_patches)
        macs += cfg.num_patches * d                # scorer matmul
    for blk in layers:
        hk_dim = blk["proj"]["kernel"].shape[0]
        fk = blk["fc1"]["kernel"].shape[1]
        macs += n * d * 3 * hk_dim                 # qkv
        macs += n * n * hk_dim * 2                 # qk + av
        macs += n * hk_dim * d                     # proj
        macs += n * d * fk * 2                     # fc1 + fc2
    return 2.0 * macs / float(table.dense_flops)
