"""The random numbers of the training steps, drawn by the reference itself
from ``--seed``: a frozen sampler of the stream UVC's CLIs draw, so that
the reference runs on its own draws and the check can hold the program's
draws against them.

The stream: a CPU ``torch.Generator`` seeded with the seed; each step
first draws its mixing decision (one ``torch.randint`` below 2**62 seeds
numpy's ``default_rng``, which draws timm's batch-mode Mixup / CutMix
decision), then, in a stage-1 step, standard Gumbel noise
``-log(-log(u))`` for the block gating ``[L, 2]``, the token top-k
``[B, P]`` and the resource's two draws ``[L, 2]``.
"""

from __future__ import annotations

import numpy as np
import torch


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen).clamp(tiny, 1.0)
    return -torch.log(-torch.log(u))


def mixing(gen: torch.Generator, size: int, thp: dict) -> tuple:
    """One batch-mode decision ``(lam, use_blend, box [size, size])``: with
    probability ``mixup_prob`` the batch is mixed, by CutMix with
    probability ``mixup_switch_prob`` (a box of side ``sqrt(1 - lam)``
    about a uniform centre, cut at the border, lam then the share left
    uncut) and else by the element blend at lam ~ Beta(mixup, mixup)."""
    if thp.get("cutmix_minmax") is not None or not (
            thp["mixup"] > 0 and thp["cutmix"] > 0):
        raise ValueError("the reference draws Mixup and CutMix both on, "
                         "without cutmix_minmax")
    rng = np.random.default_rng(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))
    mixed = rng.random() < thp["mixup_prob"]
    cut = rng.random() < thp["mixup_switch_prob"]
    lam_blend = np.float32(rng.beta(thp["mixup"], thp["mixup"]))
    lam_cut = np.float32(rng.beta(thp["cutmix"], thp["cutmix"]))
    side = int(np.float32(size) * np.sqrt(np.float32(1.0) - lam_cut))
    cy, cx = int(rng.integers(0, size)), int(rng.integers(0, size))
    y0, y1 = max(cy - side // 2, 0), min(cy + side // 2, size)
    x0, x1 = max(cx - side // 2, 0), min(cx + side // 2, size)
    box = torch.zeros(size, size, dtype=torch.bool)
    if mixed and cut:
        box[y0:y1, x0:x1] = True
    uncut = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) \
        / np.float32(size * size)
    lam = (uncut if cut else lam_blend) if mixed else np.float32(1.0)
    return (torch.tensor(np.float32(lam)), torch.tensor(mixed and not cut),
            box)


def stage1(seed: int, steps: int, cfg, batch: int, tau: float, thp: dict,
           device) -> list:
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        draw = {"mixup": mixing(gen, cfg.img_size, thp)}
        for key, shape in (("gate", (cfg.depth, 2)),
                           ("token", (batch, cfg.num_patches)),
                           ("res1", (cfg.depth, 2)),
                           ("res2", (cfg.depth, 2))):
            draw[key] = gumbel(gen, shape)
        out.append(_to(draw, device) | {"tau": tau})
    return out


def stage2(seed: int, steps: int, cfg, thp: dict, device) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [_to({"mixup": mixing(gen, cfg.img_size, thp)}, device)
            for _ in range(steps)]


def _to(draw: dict, device) -> dict:
    return {k: tuple(t.to(device) for t in v) if isinstance(v, tuple)
            else v.to(device) for k, v in draw.items()}


def gap(program: list, reference: list) -> float:
    """The largest difference between the program's draws and the
    reference's over every number of every step (a flag or a box pixel
    as 0 or 1); infinite where a draw is missing or of another shape."""
    worst = 0.0
    for got, want in zip(program, reference, strict=True):
        for key, w in want.items():
            if key == "tau":
                continue
            g = got.get(key)
            pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
            for a, b in pairs:
                if a is None or tuple(a.shape) != tuple(b.shape):
                    return float("inf")
                d = (a.float() - b.to(a.device).float()).abs()
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst
