"""Write the image fixtures (``tests/fixtures/images/``) and their digests.

The files cover what the port's image library decodes: JPEG at several
sizes (1x1 to 500x375), samplings (4:4:4, 4:2:2, 4:2:0), qualities (50,
75, 95), baseline, progressive and optimised, grayscale, CMYK and
restart markers; PNG in modes RGB, RGBA, L, LA, P (8- and 4-bit) and 1;
BMP at 24 and 32 bits. Six of the JPEGs are photo-sized
(``IMAGENET_LIKE``: 500x375, 500x333, 375x500 and 333x500, 4:2:0
baseline at quality 85-95, 2.9-5.4 bits a pixel, 87 KB a file on
average; ILSVRC-2012's train files average about 108 KB, 138 GB in 1.28
M files): the loader benchmarks time those alone, since a decode's cost
grows with the file's pixels and bits. Five more (``LIBJPEG_FILES``)
carry samplings that PIL cannot write (h1v2, 4:1:1, 4:1:0, 3:1, chroma
above luma); they were written once by libjpeg-turbo 2.1.5's encoder
with the components' sampling factors set, from ``photo`` at seeds 40-44
and quality 85, and are committed as they are: this script does not
rewrite them, and their records are the PIL decode alone.
``digests.json`` holds, per record, the sha256
(``tests/image_check.py::digest``) of what PIL and the JAX package make
of them: each file's ``convert("RGB")``, the PIL path's train and eval
crops (``uvc_tpu.data.pipeline``), the native path's
(``uvc_tpu.data.native_loader``, its library built from ``native/``),
and RandAugment's ops, colour jitter and the whole policy
(``uvc_tpu.data.augment``) on one PIL-path crop. A train record also
keeps the box the port draws here, which the card's check prints beside
its own when a digest differs.

``python tests/make_image_fixtures.py`` rewrites the files and the
digests with this machine's PIL; the tier-1 test recomputes the digests
from the committed files and compares (``reference_records``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "images"

# name -> (format, mode, width, height, save options)
FILES = {
    "jpeg_1x1_420.jpg": ("JPEG", "RGB", 1, 1, dict(subsampling=2)),
    "jpeg_17x9_420.jpg": ("JPEG", "RGB", 17, 9, dict(subsampling=2)),
    "jpeg_97x131_444_q95.jpg": ("JPEG", "RGB", 97, 131,
                                dict(subsampling=0, quality=95)),
    "jpeg_333x500_422.jpg": ("JPEG", "RGB", 333, 500, dict(subsampling=1)),
    "jpeg_500x375_420_q50.jpg": ("JPEG", "RGB", 500, 375,
                                 dict(subsampling=2, quality=50)),
    "jpeg_500x375_420_progressive.jpg": ("JPEG", "RGB", 500, 375,
                                         dict(subsampling=2,
                                              progressive=True)),
    "jpeg_333x500_444_progressive_optimized_q95.jpg": (
        "JPEG", "RGB", 333, 500,
        dict(subsampling=0, progressive=True, optimize=True, quality=95)),
    "jpeg_97x131_422_optimized_q50.jpg": ("JPEG", "RGB", 97, 131,
                                          dict(subsampling=1, optimize=True,
                                               quality=50)),
    "jpeg_201x143_420_q95.jpg": ("JPEG", "RGB", 201, 143,
                                 dict(subsampling=2, quality=95)),
    "jpeg_gray_131x97.jpg": ("JPEG", "L", 131, 97, {}),
    "jpeg_gray_64x48_progressive.jpg": ("JPEG", "L", 64, 48,
                                        dict(progressive=True)),
    "jpeg_cmyk_97x131.jpg": ("JPEG", "CMYK", 97, 131, dict(quality=90)),
    "jpeg_200x150_420_restart_rows.jpg": ("JPEG", "RGB", 200, 150,
                                          dict(subsampling=2,
                                               restart_marker_rows=1)),
    "jpeg_160x120_progressive_restart.jpg": ("JPEG", "RGB", 160, 120,
                                             dict(progressive=True,
                                                  restart_marker_blocks=4)),
    "png_rgb_64x48.png": ("PNG", "RGB", 64, 48, {}),
    "png_rgba_48x64.png": ("PNG", "RGBA", 48, 64, {}),
    "png_l_33x21.png": ("PNG", "L", 33, 21, {}),
    "png_la_21x33.png": ("PNG", "LA", 21, 33, {}),
    "png_p_64x48.png": ("PNG", "P", 64, 48, dict(optimize=True)),
    "png_p4_40x30.png": ("PNG", "P16", 40, 30, {}),
    "png_1bit_45x31.png": ("PNG", "1", 45, 31, {}),
    "bmp_24_50x37.bmp": ("BMP", "RGB", 50, 37, {}),
    "bmp_32_37x50.bmp": ("BMP", "RGBA", 37, 50, {}),
}
# name -> (width, height, quality): photo-sized 4:2:0 baseline JPEGs with
# more noise than the others (``photo(..., noise=PHOTO_NOISE)``)
IMAGENET_LIKE = {
    "imagenet_500x375_420_q90.jpg": (500, 375, 90),
    "imagenet_500x375_420_q95.jpg": (500, 375, 95),
    "imagenet_500x333_420_q88.jpg": (500, 333, 88),
    "imagenet_500x333_420_q92.jpg": (500, 333, 92),
    "imagenet_375x500_420_q90.jpg": (375, 500, 90),
    "imagenet_333x500_420_q85.jpg": (333, 500, 85),
}
PHOTO_NOISE = 16
FILES.update({name: ("JPEG", "RGB", w, h, dict(subsampling=2, quality=q))
              for name, (w, h, q) in IMAGENET_LIKE.items()})
# committed JPEGs that PIL cannot write: name -> the sampling factors
# (h, v) of Y, Cb, Cr
LIBJPEG_FILES = {
    "jpeg_97x131_h1v2.jpg": ((1, 2), (1, 1), (1, 1)),
    "jpeg_131x97_411.jpg": ((4, 1), (1, 1), (1, 1)),
    "jpeg_131x97_410_progressive.jpg": ((4, 2), (1, 1), (1, 1)),
    "jpeg_97x61_311.jpg": ((3, 1), (1, 1), (1, 1)),
    "jpeg_61x97_chroma_2x2_luma_1x1.jpg": ((1, 1), (2, 2), (2, 2)),
}

SEEDS = (0, 1, 2)
SIZE = 224
INTERPS = ("bilinear", "bicubic")
OP_SOURCE = {"file": "jpeg_500x375_420_progressive.jpg", "seed": 0,
             "size": SIZE, "interp": "bicubic"}
OP_LEVELS = (0.0, 2.5, 5.0, 7.5, 10.0)
OP_RNG = 7
DRAWS = (0, 1, 2, 3)


def photo(w: int, h: int, seed: int, noise: float = 4) -> np.ndarray:
    """A photo-like test card: smooth waves, a few flat shapes with edges,
    noise of standard deviation ``noise``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 1)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            f = rng.uniform(0.5, 6, 2)
            img[..., c] += np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) +
                                  rng.uniform(0, 2 * np.pi))
    img = 128 + 35 * img
    for _ in range(4):
        x0, y0 = rng.integers(0, max(w, 1)), rng.integers(0, max(h, 1))
        img[y0:y0 + h // 3, x0:x0 + w // 4] = rng.integers(0, 256, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(out: Path = FIXTURES) -> None:
    from PIL import Image
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, (fmt, mode, w, h, opts)) in enumerate(FILES.items()):
        img = Image.fromarray(photo(
            w, h, i, PHOTO_NOISE if name in IMAGENET_LIKE else 4))
        if mode == "P16":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=16)
        elif mode == "P":
            img = img.convert("P", palette=Image.ADAPTIVE, colors=200)
        elif mode != "RGB":
            img = img.convert(mode)
        img.save(out / name, fmt, **opts)


def _records() -> list:
    """The records without their digests (and boxes)."""
    recs = [{"kind": "decode", "file": f} for f in [*FILES, *LIBJPEG_FILES]]
    for f in FILES:
        for interp in INTERPS:
            for path in ("pil", "native"):
                for seed in SEEDS:
                    recs.append({"kind": f"{path}_train", "file": f,
                                 "seed": seed, "size": SIZE,
                                 "interp": interp})
                recs.append({"kind": f"{path}_eval", "file": f, "size": SIZE,
                             "interp": interp})
    for op in ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
               "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
               "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY"):
        for level in OP_LEVELS:
            for resample in (2, 3):
                recs.append({"kind": "op", "source": OP_SOURCE, "op": op,
                             "level": level, "resample": resample,
                             "rng": OP_RNG})
    for r in DRAWS:
        recs.append({"kind": "jitter", "source": OP_SOURCE, "rng": r,
                     "strength": 0.4})
        for interp in INTERPS:
            recs.append({"kind": "augment", "source": OP_SOURCE, "rng": r,
                         "aa": "rand-m9-mstd0.5-inc1", "interp": interp})
    return recs


def reference(rec: dict, fixtures: Path) -> np.ndarray:
    """What PIL and the JAX package make of one record."""
    from PIL import Image

    from uvc_tpu.data import augment, native_loader, pipeline
    kind = rec["kind"]
    if kind in ("op", "jitter", "augment"):
        src = rec["source"]
        img = pipeline.load_train_image(
            str(fixtures / src["file"]), np.random.default_rng(src["seed"]),
            src["size"], interpolation=src["interp"])
        rng = np.random.default_rng(rec["rng"])
        if kind == "op":
            out = augment._apply_op(Image.fromarray(img), rec["op"],
                                    rec["level"], rng, rec["resample"])
        elif kind == "jitter":
            out = augment.color_jitter_image(Image.fromarray(img), rng,
                                             rec["strength"])
        else:
            return augment.make_train_augment(rec["aa"], 0.0,
                                              rec["interp"])(img, rng)
        return np.asarray(out, np.uint8)
    path = str(fixtures / rec["file"])
    if kind == "decode":
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    if kind == "pil_train":
        return pipeline.load_train_image(
            path, np.random.default_rng(rec["seed"]), rec["size"],
            interpolation=rec["interp"])
    if kind == "pil_eval":
        return pipeline.load_eval_image(path, rec["size"],
                                        interpolation=rec["interp"])
    if not native_loader.available():
        raise RuntimeError("the JAX package's native loader does not build")
    seeds = np.asarray([rec.get("seed", 0)], np.uint64)
    return native_loader.load_batch(
        [path], rec["size"], train=kind == "native_train", seeds=seeds,
        interpolation=rec["interp"], num_threads=2)[0]


def reference_records(fixtures: Path = FIXTURES) -> list:
    """Every record with PIL's / the JAX package's digest; a train record
    with the box the port draws here."""
    sys.path.insert(0, str(REPO))
    from image_check import _port_box, digest
    out = []
    for rec in _records():
        rec = dict(rec, sha256=digest(reference(rec, fixtures)))
        if rec["kind"] in ("pil_train", "native_train"):
            rec["box"] = _port_box(rec, str(fixtures / rec["file"]))
        out.append(rec)
    return out


def main() -> None:
    write_fixtures()
    (FIXTURES / "digests.json").write_text(json.dumps(
        {"records": reference_records()}, indent=0) + "\n")
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    print(f"{len(FILES) + len(LIBJPEG_FILES)} files, {total} bytes with the "
          "digests")


if __name__ == "__main__":
    main()
