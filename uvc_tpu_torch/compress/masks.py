"""Structural masks and parameter accounting (counterpart of
``uvc_tpu/compress/masks.py``, the parts serving needs).

``attn [L, D]`` masks the attention projection's input features
(head-major) and ``mlp [L, d_ff]`` the MLP hidden units; the forward
multiplies the activations feeding proj / fc2 by them.  The proximal
shrinkage belongs to training and comes with it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from uvc_tpu_torch.compress.scores import group_scores
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.ops.stes import bottom_k_mask


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


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),))
    else:
        yield path, tree


def total_maskable_params(params: dict) -> float:
    """Every kernel and scale entry (biases excluded): the count the
    reference's count_mask reports at init."""
    return float(sum(leaf.numel() for path, leaf in _leaves_with_path(params)
                     if any("kernel" in p or "scale" in p for p in path)))


def count_remaining_params(params: dict, masks: Dict[str, torch.Tensor],
                           cfg: ViTConfig) -> float:
    """Total maskable entries minus the pruned ones: per layer, pruned
    attention columns x D (proj) and pruned MLP units x 2D (fc1 + fc2)."""
    d = cfg.embed_dim
    attn_removed = float((1.0 - masks["attn"]).sum()) * d
    mlp_removed = float((1.0 - masks["mlp"]).sum()) * (2 * d)
    return total_maskable_params(params) - attn_removed - mlp_removed
