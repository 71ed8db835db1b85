"""Structural masks, proximal shrinkage and parameter accounting
(counterpart of ``uvc_tpu/compress/masks.py``).

``attn [L, D]`` masks the attention projection's input features
(head-major) and ``mlp [L, d_ff]`` the MLP hidden units; the forward
multiplies the activations feeding proj / fc2 by them.  ``prox_weights``
is the stage-1 proximal shrinkage of the bottom groups.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from uvc_tpu_torch.compress.scores import group_scores
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.ops.stes import bottom_k_mask
from uvc_tpu_torch.utils.tree import tree_leaves_with_path


def _structural_keep_masks(params: dict, s: torch.Tensor, r: torch.Tensor,
                           cfg: ViTConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attn_keep [L, D], mlp_keep [L, d_ff]) 0/1 f32 masks: column j of
    head h is pruned when dim j is in head h's bottom ceil(r[l, h]) or head
    h is in the bottom ceil(s[l, 0]) heads; MLP unit u is pruned when it is
    in the bottom ceil(s[l, 1])."""
    scores1, scores2, scores3 = group_scores(params["blocks"], cfg.num_heads)
    l = scores2.shape[0]
    dim_pruned = bottom_k_mask(scores1, torch.ceil(r).long())
    head_pruned = bottom_k_mask(scores2, torch.ceil(s[:, 0]).long())
    attn_pruned = dim_pruned | head_pruned[..., None]
    attn_keep = (~attn_pruned).reshape(l, cfg.embed_dim).float()
    mlp_keep = (~bottom_k_mask(scores3, torch.ceil(s[:, 1]).long())).float()
    return attn_keep, mlp_keep


def build_masks(params: dict, s: torch.Tensor, r: torch.Tensor,
                cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    attn_keep, mlp_keep = _structural_keep_masks(params, s, r, cfg)
    return {"attn": attn_keep, "mlp": mlp_keep}


def prox_weights(params: dict, s: torch.Tensor, r: torch.Tensor,
                 y: torch.Tensor, p: torch.Tensor, lr,
                 cfg: ViTConfig) -> dict:
    """Proximal shrink of the bottom groups, in the reference's order:
    each head's bottom ``ceil(r)`` proj input columns by
    ``1 / (1 + 2 lr p[l, h])``, then the bottom ``ceil(s0)`` whole heads
    by ``1 / (1 + 2 lr y[l, 0])`` (multiplicative where both apply), then
    fc2's bottom ``ceil(s1)`` input rows by ``1 / (1 + 2 lr y[l, 1])``.
    Returns a new tree; ``params`` is not modified."""
    scores1, scores2, scores3 = group_scores(params["blocks"], cfg.num_heads)
    l = scores2.shape[0]
    y, p = y.detach(), p.detach()
    one = torch.ones((), device=s.device)
    dim_sel = bottom_k_mask(scores1, torch.ceil(r).long())        # [L, H, hs]
    shrink_r = torch.where(dim_sel, 1.0 / (1.0 + 2.0 * lr * p[..., None]),
                           one)
    head_sel = bottom_k_mask(scores2, torch.ceil(s[:, 0]).long())  # [L, H]
    shrink_s = torch.where(head_sel[..., None],
                           1.0 / (1.0 + 2.0 * lr * y[:, 0][:, None, None]),
                           one)
    col_scale = (shrink_r * shrink_s).reshape(l, cfg.embed_dim)
    mlp_sel = bottom_k_mask(scores3, torch.ceil(s[:, 1]).long())   # [L, F]
    mlp_scale = torch.where(mlp_sel,
                            1.0 / (1.0 + 2.0 * lr * y[:, 1][:, None]), one)
    blocks = dict(params["blocks"])
    blocks["proj"] = dict(blocks["proj"], kernel=blocks["proj"]["kernel"]
                          * col_scale[:, :, None])
    blocks["fc2"] = dict(blocks["fc2"], kernel=blocks["fc2"]["kernel"]
                         * mlp_scale[:, :, None])
    return dict(params, blocks=blocks)


def prune_weights(params: dict, masks: Dict[str, torch.Tensor],
                  cfg: ViTConfig) -> dict:
    """Hard-zero pruned groups in the weights: proj input rows, fc2 input
    rows and fc1 output columns.  Returns a new tree; ``params`` is not
    modified."""
    blocks = dict(params["blocks"])
    blocks["proj"] = dict(blocks["proj"],
                          kernel=blocks["proj"]["kernel"]
                          * masks["attn"][:, :, None])
    blocks["fc2"] = dict(blocks["fc2"],
                         kernel=blocks["fc2"]["kernel"]
                         * masks["mlp"][:, :, None])
    blocks["fc1"] = dict(blocks["fc1"],
                         kernel=blocks["fc1"]["kernel"]
                         * masks["mlp"][:, None, :])
    return dict(params, blocks=blocks)


def total_maskable_params(params: dict) -> float:
    """Every kernel and scale entry (biases excluded): the count the
    reference's count_mask reports at init."""
    return float(sum(leaf.numel()
                     for path, leaf in tree_leaves_with_path(params)
                     if any("kernel" in p or "scale" in p for p in path)))


def count_remaining_params(params: dict, masks: Dict[str, torch.Tensor],
                           cfg: ViTConfig) -> float:
    """Total maskable entries minus the pruned ones: per layer, pruned
    attention columns x D (proj) and pruned MLP units x 2D (fc1 + fc2)."""
    d = cfg.embed_dim
    attn_removed = float((1.0 - masks["attn"]).sum()) * d
    mlp_removed = float((1.0 - masks["mlp"]).sum()) * (2 * d)
    return total_maskable_params(params) - attn_removed - mlp_removed
