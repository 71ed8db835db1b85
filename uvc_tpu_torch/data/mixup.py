"""Mixup / cutmix with smoothed soft targets (counterpart of
``uvc_tpu/data/mixup.py``, timm's ``Mixup`` semantics).

The draw is split from its application: ``sample_mixup`` draws every
mixing decision (``MixupDraw``: lam, use_blend, box) on the host from a
``torch.Generator``, and ``mixup_cutmix`` applies a draw to a batch on its
device.  A test hands the JAX package's own draw (``_sample_one``) to
``mixup_cutmix`` and compares the mixed batches.

Modes: ``batch`` draws one decision for the batch, the partner being the
flipped batch; ``elem`` one per sample; ``pair`` one per sample pair
(sample i and b-1-i share it).  ``cutmix_minmax`` takes the box sides
uniformly in [min, max] of H and W instead of from a Beta draw.

Across data-parallel ranks the flip is the global batch's, as inside the
JAX package's SPMD step: every rank draws the global batch's decisions,
keeps its rows' (``rows_of_draw``) and takes its partners' images and
labels from the rank they lie on (``parallel/mesh.py::flip_partners``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class MixupDraw(NamedTuple):
    """One mixing decision, or a batch of them along a leading axis."""

    lam: torch.Tensor        # [] or [D] f32: weight of the image itself
    use_blend: torch.Tensor  # [] or [D] bool: the element blend is on
    box: torch.Tensor        # [H, W] or [D, H, W] bool: pixels cut from
                             # the partner


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.1) -> torch.Tensor:
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return one_hot * (on - off) + off


def _sample_one(rng: np.random.Generator, h: int, w: int, mixup_alpha,
                cutmix_alpha, prob, switch_prob, cutmix_minmax):
    """(lam, use_blend, box [h, w]) for one decision, as the JAX package's
    ``_sample_one`` draws it (its box arithmetic in f32)."""
    apply_mix = rng.random() < prob
    cutmix_on = cutmix_alpha > 0 or cutmix_minmax is not None
    if mixup_alpha <= 0:
        use_cutmix = True
    elif not cutmix_on:
        use_cutmix = False
    else:
        use_cutmix = rng.random() < switch_prob
    lam_mix = (np.float32(rng.beta(mixup_alpha, mixup_alpha))
               if mixup_alpha > 0 else np.float32(1.0))
    if cutmix_minmax is not None:
        lo, hi = float(cutmix_minmax[0]), float(cutmix_minmax[1])
        cut_h = int(rng.integers(int(h * lo), max(int(h * hi),
                                                  int(h * lo) + 1)))
        cut_w = int(rng.integers(int(w * lo), max(int(w * hi),
                                                  int(w * lo) + 1)))
        y0 = int(rng.integers(0, h - cut_h + 1))
        x0 = int(rng.integers(0, w - cut_w + 1))
        y0, y1, x0, x1 = y0, y0 + cut_h, x0, x0 + cut_w
    else:
        lam_cut = (np.float32(rng.beta(cutmix_alpha, cutmix_alpha))
                   if cutmix_alpha > 0 else np.float32(1.0))
        ratio = np.sqrt(np.float32(1.0) - lam_cut)
        cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        y0, y1 = (int(np.clip(cy - cut_h // 2, 0, h)),
                  int(np.clip(cy + cut_h // 2, 0, h)))
        x0, x1 = (int(np.clip(cx - cut_w // 2, 0, w)),
                  int(np.clip(cx + cut_w // 2, 0, w)))
    box = np.zeros((h, w), bool)
    box[y0:y1, x0:x1] = True
    lam_cut_real = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / (
        np.float32(h * w))
    lam = lam_cut_real if use_cutmix else lam_mix
    lam = lam if apply_mix else np.float32(1.0)
    box &= apply_mix and use_cutmix
    use_blend = apply_mix and not use_cutmix
    return np.float32(lam), use_blend, box


def sample_mixup(generator: torch.Generator, h: int, w: int, *,
                 decisions: Optional[int] = None, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 0.8,
                 switch_prob: float = 0.5,
                 cutmix_minmax: Optional[Sequence[float]] = None
                 ) -> MixupDraw:
    """Draw one decision (``decisions=None``, the ``batch`` mode) or
    ``decisions`` of them, on the host, from a numpy generator seeded by
    one draw of ``generator`` (PyTorch has no seeded Beta sampler)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    rng = np.random.default_rng(seed)
    args = (h, w, mixup_alpha, cutmix_alpha, prob, switch_prob,
            cutmix_minmax)
    if decisions is None:
        lam, blend, box = _sample_one(rng, *args)
        return MixupDraw(torch.tensor(lam), torch.tensor(blend),
                         torch.from_numpy(box))
    draws = [_sample_one(rng, *args) for _ in range(decisions)]
    return MixupDraw(torch.tensor(np.array([d[0] for d in draws])),
                     torch.tensor(np.array([d[1] for d in draws])),
                     torch.from_numpy(np.stack([d[2] for d in draws])))


def rows_of_draw(draw: MixupDraw, mode: str,
                 rows: torch.Tensor) -> MixupDraw:
    """The decisions of the batch rows ``rows`` (indices into the batch
    ``draw`` was drawn for): the ``batch`` mode's one decision as it is,
    the ``elem`` mode's rows, and in the ``pair`` mode each row's pair's
    (rows i and b-1-i share one)."""
    if mode == "batch":
        return draw
    if mode == "pair":
        rows = torch.minimum(rows, draw.lam.shape[0] - 1 - rows)
    return MixupDraw(*(t[rows.to(t.device)] for t in draw))


def mixup_cutmix(x: torch.Tensor, labels: torch.Tensor, draw: MixupDraw, *,
                 num_classes: int, smoothing: float = 0.1,
                 mode: str = "batch", partner=None):
    """Apply ``draw`` to the NHWC batch ``x``; returns (mixed x, soft
    targets ``[B, classes]``).  The partner of sample i is sample b-1-i,
    or, given ``partner`` (a data-parallel step's ``(images, labels)`` of
    the partners, row i's at i), ``partner``'s row i; ``draw`` then holds
    one decision a row (``rows_of_draw``), in the ``pair`` mode too."""
    b = x.shape[0]
    dev = x.device
    lam, use_blend, box = (t.to(dev) for t in draw)
    t1 = one_hot_smooth(labels, num_classes, smoothing)
    if partner is None:
        x_flip, t2 = x.flip(0), t1.flip(0)
    else:
        x_flip = partner[0]
        t2 = one_hot_smooth(partner[1], num_classes, smoothing)
    if mode == "batch":
        x_out = torch.where(box[None, :, :, None], x_flip, x)
        x_out = torch.where(use_blend, lam * x + (1.0 - lam) * x_flip, x_out)
        return x_out.to(x.dtype), lam * t1 + (1.0 - lam) * t2
    if mode == "pair" and partner is None:
        idx = torch.arange(b, device=dev)
        first = torch.minimum(idx, b - 1 - idx)
        lam, use_blend, box = lam[first], use_blend[first], box[first]
    lam_b = lam[:, None, None, None]
    x_out = torch.where(box[:, :, :, None], x_flip, x)
    x_out = torch.where(use_blend[:, None, None, None],
                        lam_b * x + (1.0 - lam_b) * x_flip, x_out)
    return (x_out.to(x.dtype),
            lam[:, None] * t1 + (1.0 - lam[:, None]) * t2)
