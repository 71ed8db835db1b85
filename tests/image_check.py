"""Hold the port's image path to the digests of PIL and the JAX package.

``tests/fixtures/images/`` holds small JPEG, PNG and BMP files and
``digests.json``, the sha256 of what PIL and the JAX package make of them
(written by ``tests/make_image_fixtures.py``): each file's decode, the
PIL path's and the native path's train and eval crops at recorded seeds
and filters, and RandAugment's ops, colour jitter and the whole policy on
one crop at recorded levels and draws.  This script recomputes every
record with the port alone (``data/imagelib.py`` and the loaders built on
it; no PIL, no JAX) and compares.  A crop that differs is printed with
the box this host drew beside the recorded one, so that a draw that parts
(numpy or libm) can be told from a fault in the pixel work.

Test-side, beside the fixtures it reads: it imports no PIL and no JAX,
so the card's machine runs it (``chip_smoke.py`` phase 19).

Usage: python tests/image_check.py [--fixtures DIR]
Prints one JSON line (records and mismatches per kind) and exits 1 on a
mismatch.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


def digest(img: np.ndarray) -> str:
    a = np.ascontiguousarray(img, np.uint8)
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def _port_box(rec: dict, path: str):
    """The crop box this host draws for a train record."""
    from uvc_tpu_torch.data import imagelib, native_loader, pipeline
    w, h = imagelib.image_size(path)
    if rec["kind"] == "native_train":
        return native_loader.crop_box(w, h, rec["seed"])
    rng = np.random.default_rng(rec["seed"])
    plan = pipeline._random_resized_crop((w, h), rng, rec["size"],
                                         interpolation=rec["interp"])
    plan[9] = int(rng.random() < 0.5)
    return plan


def compute(rec: dict, fixtures: Path) -> np.ndarray:
    """What the port makes of one record."""
    from uvc_tpu_torch.data import augment, imagelib, native_loader, pipeline
    kind = rec["kind"]
    if kind in ("op", "jitter", "augment"):
        src = rec["source"]
        img = pipeline.load_train_image(
            str(fixtures / src["file"]), np.random.default_rng(src["seed"]),
            src["size"], interpolation=src["interp"])
        rng = np.random.default_rng(rec["rng"])
        if kind == "op":
            return augment._apply_op(img, rec["op"], rec["level"], rng,
                                     rec["resample"])
        if kind == "jitter":
            return augment.color_jitter_image(img, rng, rec["strength"])
        return augment.make_train_augment(rec["aa"], 0.0,
                                          rec["interp"])(img, rng)
    path = str(fixtures / rec["file"])
    if kind == "decode":
        return imagelib.decode_rgb(path)
    if kind == "pil_train":
        return pipeline.load_train_image(
            path, np.random.default_rng(rec["seed"]), rec["size"],
            interpolation=rec["interp"])
    if kind == "pil_eval":
        return pipeline.load_eval_image(path, rec["size"],
                                        interpolation=rec["interp"])
    if kind in ("native_train", "native_eval"):
        seeds = np.asarray([rec.get("seed", 0)], np.uint64)
        return native_loader.load_batch(
            [path], rec["size"], train=kind == "native_train", seeds=seeds,
            interpolation=rec["interp"], num_threads=2)[0]
    raise ValueError(f"unknown record kind {kind!r}")


def check(fixtures: Path = FIXTURES) -> dict:
    """Recompute every record of ``digests.json``; returns the counts per
    kind and the mismatches."""
    records = json.loads((fixtures / "digests.json").read_text())["records"]
    counts, bad = {}, []
    for rec in records:
        n = counts.setdefault(rec["kind"], [0, 0])
        n[0] += 1
        try:
            got = digest(compute(rec, fixtures))
        except Exception as e:  # noqa: BLE001 - reported as a mismatch
            got = f"raised {type(e).__name__}: {e}"
        if got == rec["sha256"]:
            continue
        n[1] += 1
        miss = {k: rec[k] for k in rec if k not in ("sha256", "box")}
        miss["got"] = got
        if rec["kind"] in ("pil_train", "native_train"):
            miss["box_recorded"] = rec["box"]
            miss["box_here"] = _port_box(rec, str(fixtures / rec["file"]))
        bad.append(miss)
    return {"records": len(records),
            "per_kind": {k: {"records": v[0], "mismatches": v[1]}
                         for k, v in counts.items()},
            "mismatches": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fixtures", default=str(FIXTURES))
    args = ap.parse_args(argv)
    report = check(Path(args.fixtures))
    for m in report["mismatches"]:
        print("MISMATCH " + json.dumps(m), file=sys.stderr)
    print(json.dumps({"image_check": {k: report[k]
                                      for k in ("records", "per_kind")},
                      "mismatches": len(report["mismatches"])}))
    return 1 if report["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
