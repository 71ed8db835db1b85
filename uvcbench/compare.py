"""The numbers the output check compares, each against the plain
reference.

Training: each step's loss; the first gradient, as the optimizer got it,
leaf by leaf, by its norm and by the norm of its difference from the
reference's (the norms' gap is second order in an error that is not
aligned with the gradient, so rounding below bfloat16 shows in the
difference first); each leaf's change over the first steps.  A leaf counts by
its norm, against the reference's norm of that leaf or of the median
leaf, whichever is larger (some gradients are all but zero), and the
number is the worst leaf's.  Leaves whose reference gradient is under a
thousandth of the median leaf's (the frozen ones, the unused gating
logits) are left out of both, and so, from each leaf's change, are the
elements whose reference gradient is under a thousandth of the leaf's
root mean square.

Serving: each sampled batch's logits, by the relative Frobenius norm of
their difference, and each served class id by how far its reference
logit lies below the reference's best, in units of that row's spread,
averaged over the sampled rows: the widest such gap is a near tie's,
which rounding of either precision flips, and it does not tell the
float8 control from the program (PERF.md); the mean counts how often and
how far ids move, and an altered answer moves far.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch

# a leaf is left out where its reference gradient is under this share of
# the median leaf's
DEAD_LEAF = 1e-3


def norms(flat: Iterable) -> Dict[str, float]:
    """``{path: norm}`` of ``[(path, tensor)]``, read in one copy."""
    flat = list(flat)
    values = torch.stack([t.detach().float().norm() for _, t in flat])
    return dict(zip((p for p, _ in flat), values.cpu().tolist()))


def live(ref_grad: Dict[str, float]) -> set:
    med = statistics.median(ref_grad.values())
    return {p for p, v in ref_grad.items() if v >= DEAD_LEAF * med}


def live_elements(ref_grad: Dict[str, torch.Tensor]) -> Dict:
    """Per leaf, 1 where the reference's gradient element is at least a
    thousandth of the leaf's root mean square, else 0: an element whose
    gradient is nought to rounding (a key's bias under the softmax) moves
    under Adam by round-off alone, on either side."""
    return {p: (g.abs() >= DEAD_LEAF * g.float().pow(2).mean().sqrt())
            .to(g.dtype) for p, g in ref_grad.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: set, against: Dict[str, float] = None) -> tuple:
    """(the worst leaf's gap, its path): ``|prog - against|`` (``against``
    the reference's norms unless given) over the reference's norm of the
    leaf or of the median leaf, whichever is larger."""
    against = ref if against is None else against
    med = statistics.median(ref[p] for p in keep)
    gaps = {p: abs(prog[p] - against[p]) / max(ref[p], med, 1e-30)
            for p in keep}
    path = max(gaps, key=gaps.get)
    return gaps[path], path


def loss_gap(prog, ref) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def logit_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.float() - ref).norm() / ref.norm())


def id_gaps(ids: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each served id's reference logit below the reference's best, over
    the row's standard deviation (0 where the ids agree)."""
    served = ref.gather(1, ids.to(ref.device).long()[:, None])[:, 0]
    return (ref.max(dim=1).values - served) / ref.std(dim=1)
