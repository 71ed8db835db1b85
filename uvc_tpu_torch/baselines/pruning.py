"""Weight masks of the pruning baselines (counterpart of
``uvc_tpu/baselines/pruning.py``): the mask plumbing, the thresholds and
the scorers (magnitude, Taylor, SynFlow, and SP's structured head /
channel masks).

Masks are a tree that mirrors the parameters, with a 0/1 f32 tensor at
every maskable kernel and None at every other leaf.  The baseline step
multiplies them into the parameters inside its loss
(``apply_weight_masks``), so the gradient at a masked coordinate is
exactly zero.  Thresholding keeps the scores strictly above the k-th
smallest, k = ``(1 - density) * numel``.  The gradient scorers take
``torch.autograd.grad`` of a loss over the parameter leaves, so the
forward they run (the fused sublayer kernels on the card, their plain
versions on the CPU) decides the dtype.  Every tensor a function makes
lies on its input's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from uvc_tpu_torch.utils.tree import (leaf_at, tree_leaves,
                                      tree_leaves_with_path, tree_map,
                                      tree_unflatten)

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


def _map_maskable(fn: Callable, params: dict, *rest) -> dict:
    """``fn`` of every maskable leaf (and the same leaves of ``rest``),
    None elsewhere (the params' tree)."""
    return tree_unflatten(params, [
        fn(leaf, *(leaf_at(r, path) for r in rest))
        if _is_maskable(path) else None
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
    ``masks_to_flat``), each mask f32 on its parameter's device; a mask
    whose shape is not its parameter's raises."""
    def one(p, leaf):
        m = torch.as_tensor(np.array(flat[_path_str(p)]),
                            dtype=torch.float32)
        if tuple(m.shape) != tuple(leaf.shape):
            raise ValueError(f"mask {_path_str(p)} has shape "
                             f"{tuple(m.shape)}, its parameter "
                             f"{tuple(leaf.shape)}")
        return m.to(leaf.device)

    return tree_unflatten(params, [
        one(p, leaf) if _path_str(p) in flat else None
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


def tree_grad(fn: Callable, params: dict, *args) -> dict:
    """The gradient of the scalar ``fn(params, *args)`` with respect to
    every leaf of ``params`` (zeros where ``fn`` does not read a leaf, as
    under ``jax.grad``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        out = fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def taylor_scores(params: dict, loss_fn: Callable,
                  batches: Iterable) -> dict:
    """``|sum over batches of dL/dw * w|`` at every maskable kernel: the
    gradients add up over the batches and are never zeroed in between
    (``loss_fn(params, *batch)``)."""
    acc = None
    for batch in batches:
        g = tree_grad(loss_fn, params, *batch)
        acc = g if acc is None else tree_map(torch.add, acc, g)
    return _map_maskable(lambda w, g: (g * w).abs(), params, acc)


def synflow_scores(params: dict, forward_sum: Callable, density: float,
                   epochs: int = 100) -> Tuple[dict, dict]:
    """SynFlow with the exponential density schedule: ``epochs`` rounds,
    each scoring ``|dR/dw * w|`` on the |w|-linearised network under the
    current masks (``forward_sum(params) -> scalar`` runs an all-ones
    batch and sums the output) and re-thresholding globally at density
    ``density ** ((epoch + 1) / epochs)``.  Returns the last round's
    ``(scores, masks)``."""
    abs_params = tree_map(lambda t: t.detach().abs(), params)
    masks = identity_masks(params)
    scores = None
    for epoch in range(epochs):
        scores = synflow_round(abs_params, masks, forward_sum)
        masks = global_threshold_mask(scores, density ** ((epoch + 1)
                                                          / epochs))
    return scores, masks


def synflow_round(abs_params: dict, masks: dict,
                  forward_sum: Callable) -> dict:
    """One SynFlow round's scores ``|dR/dw * w|`` at the maskable kernels
    of ``abs_params`` (the weights' magnitudes) under ``masks``."""
    g = tree_grad(lambda p, m: forward_sum(apply_weight_masks(p, m)),
                  abs_params, masks)
    return _map_maskable(lambda w, gg: (gg * w).abs(), abs_params, g)


def _threshold(flat: torch.Tensor, density: float):
    """The k-th smallest score, k = ``int((1 - density) * numel)``; None
    when k < 1 (nothing to prune).  On the card from a full sort (its
    ``kthvalue`` selects with one thread block a slice, and the scores
    are one slice), on the CPU by selection."""
    k = int((1.0 - density) * flat.numel())
    if k < 1:
        return None
    if flat.is_cuda:
        return torch.sort(flat.float()).values[k - 1]
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


# ---------------------------------------------------------------------------
# SP: structured head / MLP-channel masks from gradients
# ---------------------------------------------------------------------------


def _keep_top(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """1.0 at the ``keep`` largest scores of each row: the rank of each
    score by a stable argsort of a stable argsort (JAX's ``argsort`` is
    stable; torch's only with ``stable=True``, so tied scores rank as
    they do there)."""
    rank = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1,
                         stable=True)
    return (rank >= scores.shape[1] - keep).float()


def sp_structured_masks(params: dict, grads: dict, cfg,
                        atten_density: float,
                        mlp_density: float) -> Dict[str, torch.Tensor]:
    """Structural keep masks ``{"attn": [L, H], "mlp": [L, F]}``: a head's
    score is ``|sum(dL/dW_v * W_v)|`` over its value columns; an MLP
    unit's is the L1 norm of its fc1 column's gradient plus that of its
    fc2 row's; each layer keeps its top ``max(int(density * n), 1)``."""
    l, h, hs = cfg.depth, cfg.num_heads, cfg.head_size
    d = cfg.embed_dim
    qkv_w = params["blocks"]["qkv"]["kernel"]          # [L, D, 3D]
    qkv_g = grads["blocks"]["qkv"]["kernel"]
    v_w = qkv_w[:, :, 2 * d:].reshape(l, d, h, hs)     # the value columns
    v_g = qkv_g[:, :, 2 * d:].reshape(l, d, h, hs)
    head_scores = (v_g * v_w).sum(dim=(1, 3)).abs()    # [L, H]
    attn_mask = _keep_top(head_scores, max(int(atten_density * h), 1))

    chan = (grads["blocks"]["fc1"]["kernel"].abs().sum(dim=1)
            + grads["blocks"]["fc2"]["kernel"].abs().sum(dim=2))  # [L, F]
    mlp_mask = _keep_top(chan, max(int(mlp_density * chan.shape[1]), 1))
    return {"attn": attn_mask, "mlp": mlp_mask}


def head_masks_to_weight_masks(head_mask: torch.Tensor,
                               mlp_mask: torch.Tensor, params: dict,
                               cfg) -> dict:
    """Elementwise weight masks from structural ``[L, H]`` / ``[L, F]``
    keep masks: a head's q, k and v columns of ``qkv``, a unit's ``fc1``
    column and ``fc2`` row; every other maskable kernel all ones."""
    per_dim = head_mask.repeat_interleave(cfg.head_size, dim=1)   # [L, D]
    qkv_mask = per_dim.repeat(1, 3)                                # [L, 3D]
    blocks = params["blocks"]
    masks = identity_masks(params)
    masks["blocks"]["qkv"]["kernel"] = (
        torch.ones_like(blocks["qkv"]["kernel"]) * qkv_mask[:, None, :])
    masks["blocks"]["fc1"]["kernel"] = (
        torch.ones_like(blocks["fc1"]["kernel"]) * mlp_mask[:, None, :])
    masks["blocks"]["fc2"]["kernel"] = (
        torch.ones_like(blocks["fc2"]["kernel"]) * mlp_mask[:, :, None])
    return masks
