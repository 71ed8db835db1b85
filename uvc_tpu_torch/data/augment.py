"""DeiT training-recipe augmentation (counterpart of
``uvc_tpu/data/augment.py``).

The host side is the JAX package's: ``RandAugment`` (timm's
``rand-m9-mstd0.5-inc1`` policy of 15 increasing transforms, applied per
image in the loader's worker pool after the crop and flip),
``color_jitter_image`` (used only when RandAugment is off) and
``make_train_augment``, with timm's magnitude mappings
(``_LEVEL_DENOM = 10``).  Their control flow and numpy draws are the JAX
package's, unchanged; the images are uint8 ``[H, W, 3]`` arrays, and the
pixel work of each op is Pillow's, done by the port's image library
(``data/imagelib.py``, ``csrc/image/pil_ops.cpp``) with no PIL: the look-up
tables of the integer ops and the affine matrices are built here as
Pillow's Python builds them.

Random erasing runs on the device (timm's ``RandomErasing``).  As with
mixup, the draw is split from its application: ``sample_erasing``
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

import numpy as np
import torch

from uvc_tpu_torch.data import imagelib
from uvc_tpu_torch.interop import resolve_device

_LEVEL_DENOM = 10.0
_FILL = (124, 116, 104)  # timm default img_mean fill


def _enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    return imagelib.enhance(img, kind, factor)


def _resample(interpolation: str):
    # timm passes the recipe's train interpolation into the aa params
    # (DeiT: bicubic); PIL codes: 2 = BILINEAR, 3 = BICUBIC
    return 3 if interpolation == "bicubic" else 2


def _shear(img, ax: str, v: float, resample: int):
    mat = (1, v, 0, 0, 1, 0) if ax == "x" else (1, 0, 0, v, 1, 0)
    return imagelib.affine(img, mat, resample, _FILL)


def _translate(img, ax: str, frac: float, resample: int):
    px = frac * (img.shape[1] if ax == "x" else img.shape[0])
    mat = (1, 0, px, 0, 1, 0) if ax == "x" else (1, 0, 0, 0, 1, px)
    return imagelib.affine(img, mat, resample, _FILL)


def _rotate(img, angle: float, resample: int):
    """``Image.rotate(angle, resample, fillcolor=_FILL)``: its fast paths,
    then the inverse matrix about the centre with entries rounded to 15
    places, as Pillow builds it."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    center = (w / 2, h / 2)
    angle = -math.radians(angle)
    matrix = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
              round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]

    def transform(x, y, matrix):
        (a, b, c, d, e, f) = matrix
        return a * x + b * y + c, d * x + e * y + f

    matrix[2], matrix[5] = transform(-center[0], -center[1], matrix)
    matrix[2] += center[0]
    matrix[5] += center[1]
    return imagelib.affine(img, matrix, resample, _FILL)


def _autocontrast(img):
    """``ImageOps.autocontrast`` (cutoff 0): per band, the LUT that maps
    the lowest and highest values present to 0 and 255."""
    histogram = imagelib.histogram(img)
    lut = []
    for layer in range(0, len(histogram), 256):
        h = histogram[layer:layer + 256]
        for lo in range(256):
            if h[lo]:
                break
        for hi in range(255, -1, -1):
            if h[hi]:
                break
        if hi <= lo:
            lut.extend(list(range(256)))
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            for ix in range(256):
                ix = int(ix * scale + offset)
                lut.append(min(max(ix, 0), 255))
    return imagelib.point(img, lut)


def _equalize(img):
    """``ImageOps.equalize``: per band, the cumulative histogram's LUT."""
    h = imagelib.histogram(img)
    lut = []
    for b in range(0, len(h), 256):
        histo = [_f for _f in h[b:b + 256] if _f]
        if len(histo) <= 1:
            lut.extend(list(range(256)))
        else:
            step = (sum(histo) - histo[-1]) // 255
            if not step:
                lut.extend(list(range(256)))
            else:
                n = step // 2
                for i in range(256):
                    lut.append(n // step)
                    n = n + h[i + b]
    return imagelib.point(img, lut)


def _neg(rng, v):
    return -v if rng.random() < 0.5 else v


def _apply_op(img: np.ndarray, name: str, level: float,
              rng: np.random.Generator, resample: int = 2) -> np.ndarray:
    """One RandAugment op on a uint8 ``[H, W, 3]`` array at the given
    (already noise-jittered) level, each as PIL computes it.
    Increasing-transform argument mappings: timm auto_augment.py
    ``_RAND_INCREASING_TRANSFORMS`` + ``*_increasing_level_to_arg``."""
    frac = level / _LEVEL_DENOM
    if name == "AutoContrast":
        return _autocontrast(img)
    if name == "Equalize":
        return _equalize(img)
    if name == "Invert":
        return imagelib.point(img, [255 - i for i in range(256)])
    if name == "Rotate":
        return _rotate(img, _neg(rng, frac * 30.0), resample)
    if name == "Posterize":
        bits = 4 - int(frac * 4)
        mask = ~(2 ** (8 - bits) - 1)
        return imagelib.point(img, [i & mask for i in range(256)]) \
            if bits < 8 else img
    if name == "Solarize":
        threshold = int(256 - frac * 256)
        return imagelib.point(img, [i if i < threshold else 255 - i
                                    for i in range(256)])
    if name == "SolarizeAdd":
        add = int(frac * 110)
        arr = np.asarray(img).astype(np.int32)
        lut = arr + np.where(arr < 128, add, 0)
        return np.clip(lut, 0, 255).astype(np.uint8)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        return _enhance(img, name.lower(), 1.0 + _neg(rng, frac * 0.9))
    if name == "ShearX":
        return _shear(img, "x", _neg(rng, frac * 0.3), resample)
    if name == "ShearY":
        return _shear(img, "y", _neg(rng, frac * 0.3), resample)
    if name == "TranslateX":
        return _translate(img, "x", _neg(rng, frac * 0.45), resample)
    if name == "TranslateY":
        return _translate(img, "y", _neg(rng, frac * 0.45), resample)
    raise ValueError(name)


_RAND_OPS = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
             "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
             "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY")


class RandAugment:
    """``rand-mM-mstdS-incl`` policy: ``num_ops`` ops drawn uniformly, each
    applied with prob ``prob`` at magnitude ~ N(magnitude, mstd) clipped to
    [0, 10]."""

    def __init__(self, magnitude: float = 9.0, mstd: float = 0.5,
                 num_ops: int = 2, prob: float = 0.5,
                 interpolation: str = "bilinear"):
        self.magnitude = magnitude
        self.mstd = mstd
        self.num_ops = num_ops
        self.prob = prob
        self.resample = _resample(interpolation)

    @classmethod
    def from_string(cls, spec: str,
                    interpolation: str = "bilinear") -> "RandAugment":
        """Parse a timm auto-augment string, e.g. ``rand-m9-mstd0.5-inc1``
        (the ``inc`` flag is implicit: this implementation always uses the
        increasing transforms, timm's recommended set)."""
        if not spec.startswith("rand"):
            raise ValueError(f"unsupported auto-augment policy: {spec}")
        kw = dict(magnitude=9.0, mstd=0.5, num_ops=2, prob=0.5,
                  interpolation=interpolation)
        for part in spec.split("-")[1:]:
            if part.startswith("mstd"):
                kw["mstd"] = float(part[4:])
            elif part.startswith("m"):
                kw["magnitude"] = float(part[1:])
            elif part.startswith("n"):
                kw["num_ops"] = int(part[1:])
            elif part.startswith("p"):
                kw["prob"] = float(part[1:])
            elif part.startswith("inc"):
                pass  # increasing transforms are always used
            elif part.startswith("w"):
                pass  # weighted op choice: timm stub, never implemented
        return cls(**kw)

    def __call__(self, img, rng: np.random.Generator):
        for _ in range(self.num_ops):
            if rng.random() > self.prob:
                continue
            name = _RAND_OPS[rng.integers(len(_RAND_OPS))]
            level = self.magnitude
            if self.mstd > 0:
                level = rng.normal(self.magnitude, self.mstd)
            level = float(np.clip(level, 0.0, _LEVEL_DENOM))
            img = _apply_op(img, name, level, rng, self.resample)
        return img


def color_jitter_image(img, rng: np.random.Generator, strength: float = 0.4):
    """Brightness/contrast/saturation jitter with uniform factors in
    [1-s, 1+s], random order (torchvision ColorJitter semantics used by
    timm when no aa policy is given)."""
    kinds = ["brightness", "contrast", "color"]
    rng.shuffle(kinds)
    for kind in kinds:
        img = _enhance(img, kind, rng.uniform(1 - strength, 1 + strength))
    return img


def make_train_augment(aa: Optional[str] = None,
                       color_jitter: float = 0.0,
                       interpolation: str = "bilinear"):
    """Returns ``fn(uint8_hwc_array, np_rng) -> uint8_hwc_array`` or None.

    timm precedence: an auto-augment policy disables color jitter
    (Baseline_pruning passes both; timm create_transform keeps only aa).
    """
    ra = RandAugment.from_string(aa, interpolation) \
        if aa and aa != "none" else None
    if ra is None and color_jitter <= 0:
        return None

    def fn(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        arr = np.ascontiguousarray(arr, np.uint8)
        return ra(arr, rng) if ra is not None \
            else color_jitter_image(arr, rng, color_jitter)

    return fn



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
