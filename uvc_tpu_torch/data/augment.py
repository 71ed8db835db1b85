"""Random erasing on the device (counterpart of
``uvc_tpu/data/augment.py::random_erasing``, timm's ``RandomErasing``).

As with mixup, the draw is split from its application: ``sample_erasing``
draws every rectangle and the fill, ``random_erasing`` applies a draw to
a normalized NHWC batch on its device.  The rectangles are a few numbers
per image and come from a CPU ``torch.Generator``; the ``pixel`` fill (one
Gaussian per pixel and channel, 38.5 MB in f32 at batch 64 and 224 x 224)
is drawn on the batch's device from a generator seeded by one CPU draw.
A test hands the JAX package's own rectangles and fill to
``random_erasing`` instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from uvc_tpu_torch.interop import resolve_device


class ErasingDraw(NamedTuple):
    """The rectangles and fill of ``count`` erasing passes over a batch."""

    y0: torch.Tensor     # [count, B] int64: first erased row
    x0: torch.Tensor     # [count, B] int64: first erased column
    eh: torch.Tensor     # [count, B] int64: rectangle height
    ew: torch.Tensor     # [count, B] int64: rectangle width
    do: torch.Tensor     # [count, B] bool: the image is erased this pass
    fill: Optional[torch.Tensor]  # [count, B, H, W, C] ('pixel'),
                                  # [count, B, 1, 1, C] ('rand'), None
                                  # ('const': zeros)


def sample_erasing(generator: torch.Generator, batch: int, h: int, w: int,
                   c: int, *, prob: float = 0.25, count: int = 1,
                   scale: Sequence[float] = (0.02, 1 / 3),
                   ratio: Sequence[float] = (0.3, 10 / 3),
                   mode: str = "pixel", device="cuda") -> ErasingDraw:
    """Draw ``count`` erasing passes for a ``[batch, h, w, c]`` batch.

    Per pass and image: a target area uniform in ``scale`` of ``h * w``, a
    log aspect ratio uniform in ``log(ratio)``, the sides
    ``clip(round(sqrt(area * ratio)), 1, h)`` (width with ``/ ratio``), the
    corner uniform over the positions that keep the rectangle inside, and
    the decision ``u < prob``, all in f32 as the JAX package computes them.
    ``generator`` is a CPU generator; ``device`` the batch's (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if mode not in ("pixel", "rand", "const"):
        raise ValueError(f"unknown random-erasing mode {mode!r}")
    shape = (count, batch)

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    target = (h * w) * uniform(scale[0], scale[1])
    ar = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    eh = torch.clamp(torch.round(torch.sqrt(target * ar)), 1, h)
    ew = torch.clamp(torch.round(torch.sqrt(target / ar)), 1, w)
    y0 = torch.floor(uniform() * (h - eh + 1))
    x0 = torch.floor(uniform() * (w - ew + 1))
    do = uniform() < prob
    fill = None
    if mode == "rand":
        fill = torch.randn((count, batch, 1, 1, c), generator=generator)
    fill = None if fill is None else fill.to(device)
    if mode == "pixel":
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        dgen = torch.Generator(device=device).manual_seed(seed)
        fill = torch.randn((count, batch, h, w, c), generator=dgen,
                           device=device)
    return ErasingDraw(*(t.long().to(device) for t in (y0, x0, eh, ew)),
                       do.to(device), fill)


def random_erasing(x: torch.Tensor, draw: ErasingDraw) -> torch.Tensor:
    """Apply ``draw`` to the normalized ``[B, H, W, C]`` batch ``x``: in
    each pass, every image with ``do`` set has its rectangle overwritten by
    the fill (cast to ``x.dtype``), the passes one after the other."""
    b, h, w, c = x.shape
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    for i in range(draw.do.shape[0]):
        y0, x0 = draw.y0[i, :, None, None], draw.x0[i, :, None, None]
        y1 = y0 + draw.eh[i, :, None, None]
        x1 = x0 + draw.ew[i, :, None, None]
        inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
        mask = (inside & draw.do[i, :, None, None])[..., None]
        fill = (torch.zeros((), dtype=x.dtype, device=x.device)
                if draw.fill is None else draw.fill[i].to(x.dtype))
        x = torch.where(mask, fill, x)
    return x
