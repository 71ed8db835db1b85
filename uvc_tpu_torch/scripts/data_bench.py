"""Input-pipeline throughput on the host: the folder loader's native path
against its PIL path, with and without RandAugment (counterpart of the
repo's ``scripts/data_bench.py``).

Both paths are the port's own host code (``data/imagelib.py``: no PIL),
so this runs on a machine without PIL, the card's included.  It measures
``FolderLoader``'s end-to-end img/s (decode, crop, resize, RandAugment
where asked, batch assembly) over a folder of photo-sized JPEGs
(``--fixtures DIR``, the files matching ``--glob``; the repo's
``tests/fixtures/images`` holds six, ``imagenet_*.jpg``: 500x375 to
333x500, 4:2:0 baseline, quality 85-95, 87 KB a file on average) repeated by
symlinks to ImageNet's batch sizes, same thread count on both paths,
best of ``--repeats`` interleaved runs a side.  Decode time grows with a
file's pixels and bits, so the files set the rate: time photo-sized ones.

Usage: python -m uvc_tpu_torch.scripts.data_bench --fixtures DIR
    [--out DATABENCH.json]
The record has the JAX script's keys and flags, ``train_randaug`` (the
train loader with ``rand-m9-mstd0.5-inc1``, the DeiT recipe), the
sources with their sizes and bytes, and the card's name and power limit
where there is a card.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import tempfile
import time

PHOTOS = "imagenet_*.jpg"


def fixture_folder(root: str, n: int, fixtures: str, pattern: str = PHOTOS,
                   classes: int = 2) -> list:
    """``n`` symlinks to the files of ``fixtures`` that match ``pattern``,
    spread over ``classes`` class folders; returns the sources."""
    fixtures = os.path.abspath(fixtures)      # the links' targets
    srcs = sorted(os.path.join(fixtures, f) for f in os.listdir(fixtures)
                  if fnmatch.fnmatch(f, pattern))
    if not srcs:
        raise ValueError(f"no file in {fixtures} matches {pattern!r}")
    for i in range(n):
        d = os.path.join(root, f"class_{i % classes}")
        os.makedirs(d, exist_ok=True)
        os.symlink(srcs[i % len(srcs)], os.path.join(d, f"img_{i:06d}.jpg"))
    return srcs


def run_loader(root: str, *, batch: int, workers: int, batches: int,
               interpolation: str, img_size: int, train: bool,
               aug=None) -> float:
    from uvc_tpu_torch.data.pipeline import FolderLoader
    loader = FolderLoader(root, batch, train=train, img_size=img_size,
                          num_workers=workers, interpolation=interpolation,
                          aug=aug)
    it = iter(loader)
    next(it)                       # warm: thread pool + library load
    t0 = time.perf_counter()
    n = 0
    for _ in range(batches):
        x, y = next(it)
        n += x.shape[0]
    dt = time.perf_counter() - t0
    del it
    return n / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--interpolation", default="bicubic",
                    help="bicubic = the DeiT recipe default")
    ap.add_argument("--fixtures", required=True,
                    help="directory of the JPEGs to time (the repo's "
                    "tests/fixtures/images)")
    ap.add_argument("--glob", default=PHOTOS,
                    help="which files of --fixtures to time")
    args = ap.parse_args(argv)

    import torch

    from uvc_tpu_torch.data import augment, imagelib, native_loader
    from uvc_tpu_torch.scripts import device_record
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    report = {"harness": "data_bench", "unit": "img/s (one host)",
              "batch": args.batch, "workers": args.workers,
              "cores": cores,
              "img_size": args.img_size,
              "interpolation": args.interpolation,
              "native_available": native_loader.available(),
              "device": device_record(torch.device(
                  "cuda" if torch.cuda.is_available() else "cpu"))[1],
              "note": ("the port's own host code on both paths (no PIL): "
                       "the native path is the JAX package's C++ loader "
                       "re-implemented with its float resample, the PIL "
                       "path Pillow's resample; both decode with the same "
                       "JPEG decoder and release the GIL")}

    aug = augment.make_train_augment("rand-m9-mstd0.5-inc1", 0.0,
                                     args.interpolation)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        # enough images for the warm batch and the timed batches an epoch
        need = args.batch * (args.batches + 1)
        srcs = fixture_folder(root, need, args.fixtures, args.glob)
        report["synth_s"] = round(time.time() - t0, 1)
        report["sources"] = [
            {"file": os.path.basename(s), "size": list(imagelib.image_size(s)),
             "bytes": os.path.getsize(s)} for s in srcs]

        for mode in ("train", "train_randaug", "eval"):
            train = mode != "eval"
            rows = {}
            # interleave sides, best-of-N per side: thread-pool timings
            # drift with scheduler noise, and best-of filters it
            for rep in range(args.repeats):
                for path in ("native", "pil"):
                    orig = native_loader.available
                    if path == "pil":
                        native_loader.available = lambda: False
                    try:
                        v = run_loader(
                            root, batch=args.batch, workers=args.workers,
                            batches=args.batches,
                            interpolation=args.interpolation,
                            img_size=args.img_size, train=train,
                            aug=aug if mode == "train_randaug" else None)
                    finally:
                        native_loader.available = orig
                    rows[path] = round(max(rows.get(path, 0.0), v), 1)
            rows["speedup"] = round(rows["native"] / rows["pil"], 2)
            report[mode] = rows
            print(f"{mode}: {rows}", flush=True)

    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
