"""Gradient-sparsity diagnostics (counterpart of
``uvc_tpu/diagnostics.py``): per-leaf and overall statistics of a
gradient tree (the fraction of exact and near zeros, the L1 / L2 norms
and the largest magnitude), the working form of the reference's
``show_gradient_sparsity.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from uvc_tpu_torch.utils.tree import tree_leaves_with_path


def gradient_sparsity_stats(grads, *, threshold: float = 0.0
                            ) -> Dict[str, Dict[str, float]]:
    """``{dotted path: {size, zeros, near_zeros, l1, l2, max}}`` per leaf,
    the leaves in the JAX package's order (dict keys sorted at each
    level); ``near_zeros`` counts ``|g| <= threshold`` (exact zeros at
    0).  Each leaf's numbers are reduced on its device and read once."""
    out = {}
    for path, g in sorted(tree_leaves_with_path(grads),
                          key=lambda kv: kv[0]):
        a = g.detach().float().abs()
        vals = torch.stack([(a == 0).float().mean(),
                            (a <= threshold).float().mean(), a.sum(),
                            (a * a).sum().sqrt(), a.max()]).tolist()
        out[".".join(path)] = {"size": int(g.numel()),
                               **dict(zip(("zeros", "near_zeros", "l1", "l2",
                                           "max"), vals))}
    return out


def aggregate_sparsity(stats: Dict[str, Dict[str, float]]) -> float:
    """The fraction of zero gradients over all leaves."""
    total = sum(s["size"] for s in stats.values())
    zeros = sum(s["zeros"] * s["size"] for s in stats.values())
    return zeros / max(total, 1)


def format_report(stats: Dict[str, Dict[str, float]], top: int = 20) -> str:
    """The ``top`` leaves with the most zero gradients, then the overall
    fraction."""
    lines = [f"{'leaf':60s} {'zeros%':>8s} {'l2':>12s} {'max':>10s}"]
    ranked = sorted(stats.items(), key=lambda kv: -kv[1]["zeros"])
    for name, s in ranked[:top]:
        lines.append(f"{name[:60]:60s} {s['zeros'] * 100:7.2f}% "
                     f"{s['l2']:12.4e} {s['max']:10.3e}")
    lines.append(f"overall zero-gradient fraction: "
                 f"{aggregate_sparsity(stats) * 100:.3f}%")
    return "\n".join(lines)
