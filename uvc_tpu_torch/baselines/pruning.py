"""Unstructured weight masks of the pruning baselines (counterpart of
``uvc_tpu/baselines/pruning.py``: the mask plumbing, the magnitude scorer
and the thresholds).

Masks are a tree that mirrors the parameters, with a 0/1 f32 tensor at
every maskable kernel and None at every other leaf.  The baseline step
multiplies them into the parameters inside its loss
(``apply_weight_masks``), so the gradient at a masked coordinate is
exactly zero.  Thresholding keeps the scores strictly above the k-th
smallest, k = ``(1 - density) * numel``.  Every tensor a function makes
lies on its input's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from uvc_tpu_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                      tree_map, tree_unflatten)

#: path suffixes of the maskable kernels: every linear / patch-conv weight
_MASKABLE_SUFFIXES = (
    "patch_embed.kernel", "qkv.kernel", "proj.kernel",
    "fc1.kernel", "fc2.kernel", "head.kernel", "head_dist.kernel",
    "token_scorer.kernel",
)


def _path_str(path) -> str:
    return ".".join(path)


def _is_maskable(path) -> bool:
    s = _path_str(path)
    return any(s.endswith(suf) for suf in _MASKABLE_SUFFIXES)


def _map_maskable(fn: Callable, params: dict) -> dict:
    """``fn`` of every maskable leaf, None elsewhere (the params' tree)."""
    return tree_unflatten(params, [
        fn(leaf) if _is_maskable(path) else None
        for path, leaf in tree_leaves_with_path(params)])


def maskable_paths(params: dict) -> List[str]:
    """Dotted paths of the maskable kernels, in the tree's order."""
    return [_path_str(p) for p, _ in tree_leaves_with_path(params)
            if _is_maskable(p)]


def identity_masks(params: dict) -> dict:
    """All-ones masks."""
    return _map_maskable(torch.ones_like, params)


def apply_weight_masks(params: dict, masks: dict) -> dict:
    """``w * mask`` at every masked leaf, the other leaves as they are."""
    return tree_map(lambda w, m: w if m is None else w * m, params, masks)


def masks_to_flat(masks: dict) -> Dict[str, np.ndarray]:
    """``{dotted path: numpy mask}`` of the masked leaves (the form a
    checkpoint stores)."""
    return {_path_str(p): m.detach().cpu().numpy()
            for p, m in tree_leaves_with_path(masks) if m is not None}


def masks_from_flat(flat: Dict[str, np.ndarray], params: dict) -> dict:
    """The mask tree from ``{dotted path: mask}`` (inverse of
    ``masks_to_flat``), each mask f32 on its parameter's device."""
    return tree_unflatten(params, [
        torch.as_tensor(np.array(flat[_path_str(p)]),
                        dtype=torch.float32).to(leaf.device)
        if _path_str(p) in flat else None
        for p, leaf in tree_leaves_with_path(params)])


def mask_sparsity(masks: dict) -> float:
    """Fraction of the masked weights that remain."""
    leaves = [m for m in tree_leaves(masks) if m is not None]
    total = sum(m.numel() for m in leaves)
    remain = sum(float(m.sum()) for m in leaves)
    return remain / max(total, 1)


def magnitude_scores(params: dict) -> dict:
    """``|w|`` at every maskable kernel."""
    return _map_maskable(torch.abs, params)


def _threshold(flat: torch.Tensor, density: float):
    """The k-th smallest score, k = ``int((1 - density) * numel)``; None
    when k < 1 (nothing to prune)."""
    k = int((1.0 - density) * flat.numel())
    if k < 1:
        return None
    return torch.kthvalue(flat.float(), k).values


def global_threshold_mask(scores: dict, density: float) -> dict:
    """One threshold across all maskable leaves."""
    thr = _threshold(torch.cat([s.reshape(-1) for s in tree_leaves(scores)
                                if s is not None]), density)
    return tree_map(lambda s: None if s is None else (
        torch.ones_like(s) if thr is None else (s > thr).float()), scores)


def local_threshold_mask(scores: dict, density: float) -> dict:
    """One threshold per leaf."""

    def one(s):
        if s is None:
            return None
        thr = _threshold(s.reshape(-1), density)
        return torch.ones_like(s) if thr is None else (s > thr).float()

    return tree_map(one, scores)
