"""The port's PIL-free transforms against PIL and the JAX package, bit for
bit.

* ``imagelib.resize`` against ``Image.resize`` over random up- and
  downscales and the three filters, and ``imagelib.crop``'s plans (crop
  box, resize, centre crop, flip) against PIL's ``crop`` / ``resize`` /
  ``transpose``;
* the PIL path's crops (``pipeline.load_train_image`` /
  ``load_eval_image``) against ``uvc_tpu.data.pipeline``'s at many seeds,
  on JPEG (RGB, grayscale, CMYK), PNG and BMP files and the three
  interpolations, and the native path (``native_loader.load_batch``)
  against ``uvc_tpu.data.native_loader`` over ``native/``'s library;
* each of RandAugment's 15 ops at levels 0 to 10, both interpolations and
  several sizes, colour jitter and the whole policy against
  ``uvc_tpu.data.augment`` on PIL images.  Every op is held bit for bit.
"""

import torch_port_env
from torch_port_env import capped_threads  # noqa: F401  (autouse)
import numpy as np
import pytest

from uvc_tpu.data import augment as jaug
from uvc_tpu.data import native_loader as jnative
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu_torch.data import augment as taug
from uvc_tpu_torch.data import imagelib
from uvc_tpu_torch.data import native_loader as tnative
from uvc_tpu_torch.data import pipeline as tpipe

Image = pytest.importorskip("PIL.Image")


def _photo(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 90 * np.sin(9 * xx - 4 * yy + c) for c in range(3)],
                   -1)
    img[h // 5:h // 2, w // 4:w // 2] = rng.integers(0, 256, 3)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255
                   ).astype(np.uint8)


@pytest.mark.parametrize("filt", [imagelib.NEAREST, imagelib.BILINEAR,
                                  imagelib.BICUBIC],
                         ids=["nearest", "bilinear", "bicubic"])
def test_resize_matches_pil(filt):
    rng = np.random.default_rng(filt)
    for _ in range(80):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        ow, oh = (int(v) for v in rng.integers(1, 120, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), filt))
        np.testing.assert_array_equal(imagelib.resize(img, ow, oh, filt), ref)


def test_crop_plans_match_pil():
    rng = np.random.default_rng(4)
    for i in range(60):
        h, w = (int(v) for v in rng.integers(8, 120, 2))
        img = _photo(w, h, i)
        bw, bh = (int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1)))
        bx = int(rng.integers(0, w - bw + 1))
        by = int(rng.integers(0, h - bh + 1))
        size = int(rng.integers(1, 40))
        rw, rh = size + int(rng.integers(0, 9)), size + int(rng.integers(0, 9))
        cx, cy = int(rng.integers(0, rw - size + 1)), \
            int(rng.integers(0, rh - size + 1))
        flip, filt = int(rng.integers(0, 2)), int(rng.choice([0, 2, 3]))
        ref = Image.fromarray(img).crop((bx, by, bx + bw, by + bh)).resize(
            (rw, rh), filt).crop((cx, cy, cx + size, cy + size))
        if flip:
            ref = ref.transpose(Image.FLIP_LEFT_RIGHT)
        out = imagelib.crop(img, [bx, by, bw, bh, rw, rh, cx, cy, size, flip,
                                  filt])
        np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """JPEG (RGB 4:2:0 and 4:4:4, progressive, grayscale, CMYK), PNG and BMP
    files of photo-like content, including one narrower than the crop."""
    d = tmp_path_factory.mktemp("image_files")
    specs = [("a.jpg", (211, 157), "RGB", dict(quality=85)),
             ("b.jpg", (160, 240), "RGB", dict(subsampling=0, quality=95)),
             ("c.jpg", (300, 200), "RGB", dict(progressive=True)),
             ("d.jpg", (97, 131), "L", {}),
             ("e.jpg", (120, 90), "CMYK", {}),
             ("f.png", (90, 70), "RGBA", {}),
             ("g.bmp", (70, 90), "RGB", {}),
             ("h.jpg", (20, 300), "RGB", {})]
    paths = []
    for i, (name, (w, h), mode, opts) in enumerate(specs):
        Image.fromarray(_photo(w, h, i)).convert(mode).save(d / name, **opts)
        paths.append(str(d / name))
    return paths


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_pil_path_crops_match_jax(image_files, interp):
    for path in image_files:
        for seed in range(12):
            np.testing.assert_array_equal(
                tpipe.load_train_image(path, np.random.default_rng(seed), 64,
                                       interpolation=interp),
                jpipe.load_train_image(path, np.random.default_rng(seed), 64,
                                       interpolation=interp))
        for size, resize_to in ((64, None), (48, 80), (32, 32)):
            np.testing.assert_array_equal(
                tpipe.load_eval_image(path, size, resize_to,
                                      interpolation=interp),
                jpipe.load_eval_image(path, size, resize_to,
                                      interpolation=interp))


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_native_path_crops_match_jax(image_files, interp):
    if not torch_port_env.jax_native_available():
        pytest.skip("the JAX package's native loader does not build here")
    for start in (0, 1000, 2 ** 31 - 50):
        seeds = np.arange(len(image_files), dtype=np.uint64) * 13 + start
        for train, size in ((True, 64), (True, 224), (False, 64)):
            np.testing.assert_array_equal(
                tnative.load_batch(image_files, size, train=train,
                                   seeds=seeds, interpolation=interp,
                                   num_threads=2),
                jnative.load_batch(image_files, size, train=train,
                                   seeds=seeds, interpolation=interp,
                                   num_threads=2))


def test_native_path_raises_for_an_unreadable_file(image_files, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff not really")
    for train in (True, False):
        with pytest.raises(ValueError, match="bad.jpg"):
            tnative.load_batch(image_files[:2] + [str(bad)], 32, train=train,
                               seeds=np.arange(3, dtype=np.uint64))


def test_native_path_refuses_other_filters(image_files):
    """The native path resamples with its two filters; ``FolderLoader``
    sends any other to the PIL path, and a direct call raises."""
    with pytest.raises(ValueError, match="nearest"):
        tnative.load_batch(image_files[:1], 32, train=False,
                           interpolation="nearest")


OP_SIZES = [(1, 1), (7, 5), (24, 20), (64, 48)]


@pytest.mark.parametrize("op", jaug._RAND_OPS)
def test_randaugment_op_matches_jax_at_every_level(op):
    for k, (w, h) in enumerate(OP_SIZES):
        arr = _photo(w, h, k) if k % 2 else np.random.default_rng(k).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        for level in np.arange(11.0):
            for interp in ("bilinear", "bicubic"):
                res = jaug._resample(interp)
                for draw in (1, 2):
                    a = jaug._apply_op(Image.fromarray(arr), op, level,
                                       np.random.default_rng(draw), res)
                    b = taug._apply_op(arr, op, level,
                                       np.random.default_rng(draw), res)
                    np.testing.assert_array_equal(b, np.asarray(a))


def test_color_jitter_and_policy_match_jax():
    for i in range(20):
        arr = _photo(40 + i, 30 + 2 * i, i)
        a = jaug.color_jitter_image(Image.fromarray(arr),
                                    np.random.default_rng(i), 0.4)
        b = taug.color_jitter_image(arr, np.random.default_rng(i), 0.4)
        np.testing.assert_array_equal(b, np.asarray(a))
        for spec in ("rand-m9-mstd0.5-inc1", "rand-m9-n4-mstd1.0-p1.0"):
            for interp in ("bilinear", "bicubic"):
                fj = jaug.make_train_augment(spec, 0.0, interp)
                ft = taug.make_train_augment(spec, 0.0, interp)
                np.testing.assert_array_equal(
                    ft(arr, np.random.default_rng(i)),
                    fj(arr, np.random.default_rng(i)))
