"""The port's data pipeline (uvc_tpu_torch/data/{pipeline,augment,
native_loader}.py) against the JAX package's, on the CPU.

The loaders are host numpy / PIL code in both packages, so their batches
must be equal bit for bit: the synthetic, procedural (white and lowpass
noise, jitter, a contrast range, two train epochs and the eval split),
array (CIFAR's pickle layout, written here) and folder loaders (a tree of
small JPEG and PNG files written here with PIL), with RandAugment and
colour jitter, on the PIL path and on the native path where its library
builds.  ``normalize_on_device`` agrees with JAX's to 1e-6 and
``device_prefetch`` on the CPU passes the batches through in order.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.data import augment as jaug
from uvc_tpu.data import native_loader as jnative
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu_torch.data import augment as taug
from uvc_tpu_torch.data import native_loader as tnative
from uvc_tpu_torch.data import pipeline as tpipe

PIL = pytest.importorskip("PIL.Image")


def assert_same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and len(a) > 0
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_synthetic_loader_matches():
    kw = dict(num_batches=3, img_size=16, num_classes=5, seed=4)
    assert_same_batches(jpipe.SyntheticLoader(4, **kw),
                        tpipe.SyntheticLoader(4, **kw))
    assert len(tpipe.SyntheticLoader(4, **kw)) == 3


@pytest.mark.parametrize("variant", [
    dict(),
    dict(noise_mode="lowpass"),
    dict(jitter=3),
    dict(contrast_range=(0.2, 0.8)),
    dict(noise_mode="lowpass", jitter=2, contrast_range=(0.1, 0.6),
         pid=1, pcount=2),
], ids=["white", "lowpass", "jitter", "contrast_range", "all_sharded"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_procedural_loader_matches(variant, train):
    kw = dict(num_batches=2, img_size=16, num_classes=4, train=train,
              seed=3, **variant)
    jl, tl = jpipe.ProceduralLoader(5, **kw), tpipe.ProceduralLoader(5, **kw)
    np.testing.assert_array_equal(jl.templates, tl.templates)
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert_same_batches(jl, tl)


def _write_cifar(tmp_path, dataset, n_per_file):
    rng = np.random.default_rng(5)
    if dataset == "cifar10":
        base = tmp_path / "cifar-10-batches-py"
        files = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        key = b"labels"
    else:
        base = tmp_path / "cifar-100-python"
        files = ["train", "test"]
        key = b"fine_labels"
    base.mkdir()
    for f in files:
        d = {b"data": rng.integers(0, 256, (n_per_file, 3 * 32 * 32),
                                   dtype=np.uint8),
             key: rng.integers(0, 10, n_per_file).tolist()}
        with open(base / f, "wb") as fh:
            pickle.dump(d, fh)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_cifar_arrays_match(tmp_path, dataset):
    _write_cifar(tmp_path, dataset, 7)
    for train in (True, False):
        jx, jy = jpipe.cifar_arrays(str(tmp_path), dataset, train=train)
        tx, ty = tpipe.cifar_arrays(str(tmp_path), dataset, train=train)
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)
        assert tx.shape[1:] == (32, 32, 3) and tx.dtype == np.uint8


@pytest.mark.parametrize("img_size", [32, 40], ids=["native_size",
                                                    "resized"])
@pytest.mark.parametrize("mode", ["train", "train_aug", "eval"])
def test_array_loader_matches(tmp_path, img_size, mode):
    """ArrayLoader over a CIFAR-layout pickle: train (with and without
    RandAugment), and the eval split with its padded last batch."""
    _write_cifar(tmp_path, "cifar10", 5)
    train = mode != "eval"
    x, y = jpipe.cifar_arrays(str(tmp_path), "cifar10", train=train)
    kw = dict(train=train, img_size=img_size, seed=9, pid=0, pcount=1)
    if mode == "train_aug":
        kw_j = dict(kw, aug=jaug.make_train_augment("rand-m9-mstd0.5-inc1"))
        kw_t = dict(kw, aug=taug.make_train_augment("rand-m9-mstd0.5-inc1"))
    else:
        kw_j = kw_t = kw
    jl = jpipe.ArrayLoader(x, y, 4, **kw_j)
    tl = tpipe.ArrayLoader(x, y, 4, **kw_t)
    assert len(jl) == len(tl)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert_same_batches(jl, tl)
    if not train:
        assert (list(tl)[-1][1] == -1).any()


@pytest.mark.parametrize("n,epoch,rank,replicas", [
    (300, 0, 0, 1), (300, 3, 1, 2), (1000, 1, 2, 4), (517, 7, 3, 4),
    (256, 2, 0, 3), (10, 0, 0, 1)])
def test_ra_sampler_indices_match(n, epoch, rank, replicas):
    np.testing.assert_array_equal(
        jpipe.ra_sampler_indices(n, epoch, rank, replicas),
        tpipe.ra_sampler_indices(n, epoch, rank, replicas))
    np.testing.assert_array_equal(
        jpipe.ra_sampler_indices(n, epoch, rank, replicas, shuffle=False),
        tpipe.ra_sampler_indices(n, epoch, rank, replicas, shuffle=False))


@pytest.mark.parametrize("op", jaug._RAND_OPS)
def test_randaugment_ops_match(op):
    """The port's op on the uint8 array against JAX's on the PIL image."""
    from PIL import Image
    rng = np.random.default_rng(6)
    arr = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    for level in (0.0, 4.5, 10.0):
        for interp in ("bilinear", "bicubic"):
            res = jaug._resample(interp)
            a = jaug._apply_op(Image.fromarray(arr), op, level,
                               np.random.default_rng(1), res)
            b = taug._apply_op(arr, op, level, np.random.default_rng(1), res)
            assert isinstance(b, np.ndarray) and b.dtype == np.uint8
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("spec,jitter", [
    ("rand-m9-mstd0.5-inc1", 0.0), ("rand-m7-n3-mstd0-p0.9", 0.0),
    (None, 0.4), ("none", 0.3)])
def test_train_augment_matches(spec, jitter):
    fj = jaug.make_train_augment(spec, jitter, "bicubic")
    ft = taug.make_train_augment(spec, jitter, "bicubic")
    rng = np.random.default_rng(8)
    for i in range(6):
        arr = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            fj(arr, np.random.default_rng(i)),
            ft(arr, np.random.default_rng(i)))
    assert jaug.make_train_augment(None, 0.0) is None
    assert taug.make_train_augment(None, 0.0) is None


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """A dozen small JPEG and PNG images in three class folders."""
    from PIL import Image
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(11)
    for c in range(3):
        d = root / f"class_{c}"
        d.mkdir()
        for i in range(4):
            h, w = rng.integers(20, 48, 2)
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                               dtype=np.uint8))
            ext = "png" if i % 2 else "jpg"
            img.save(d / f"img_{i}.{ext}")
    return str(root)


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("mode", ["train", "train_randaug", "train_jitter",
                                  "eval"])
def test_folder_loader_matches(image_tree, monkeypatch, native, mode):
    if native and not jnative.available():
        pytest.skip("the native loader library does not build here")
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    assert tnative.available() == native
    train = mode != "eval"
    aug = {"train_randaug": ("rand-m9-mstd0.5-inc1", 0.0),
           "train_jitter": (None, 0.4)}.get(mode)
    kw = dict(train=train, img_size=24, seed=2, num_workers=2,
              interpolation="bicubic", drop_last=False)
    jl = jpipe.FolderLoader(image_tree, 5, **kw,
                            aug=jaug.make_train_augment(*aug, "bicubic")
                            if aug else None)
    tl = tpipe.FolderLoader(image_tree, 5, **kw,
                            aug=taug.make_train_augment(*aug, "bicubic")
                            if aug else None)
    assert len(jl) == len(tl) == 3
    assert tl.classes == jl.classes
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert_same_batches(jl, tl)


def test_folder_scan_and_split_file(image_tree, tmp_path):
    jp, jl, jc = jpipe.scan_image_folder(image_tree)
    tp, tl, tc = tpipe.scan_image_folder(image_tree)
    assert jp == tp and jc == tc
    np.testing.assert_array_equal(jl, tl)
    txt = tmp_path / "split.txt"
    txt.write_text("".join(f"{p[len(image_tree) + 1:]} {c}\n"
                           for p, c in zip(tp, tl)))
    a = jpipe.load_split_file(image_tree, str(txt), 0.5)
    b = tpipe.load_split_file(image_tree, str(txt), 0.5)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_native_batches_match_when_built(image_tree):
    if not tnative.available():
        pytest.skip("the native loader library does not build here")
    paths, _, _ = tpipe.scan_image_folder(image_tree)
    seeds = np.arange(len(paths), dtype=np.uint64) * 7 + 1
    for train in (True, False):
        a = jnative.load_batch(paths, 24, train=train, seeds=seeds,
                               num_threads=2)
        b = tnative.load_batch(paths, 24, train=train, seeds=seeds,
                               num_threads=2)
        np.testing.assert_array_equal(a, b)


def test_normalize_on_device_matches():
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    ref = np.asarray(jpipe.normalize_on_device(jnp.asarray(x)))
    out = tpipe.normalize_on_device(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    xf = rng.random((2, 4, 4, 3), dtype=np.float32)
    np.testing.assert_allclose(
        tpipe.normalize_on_device(torch.from_numpy(xf)).numpy(),
        np.asarray(jpipe.normalize_on_device(jnp.asarray(xf))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_device_prefetch_on_the_cpu_passes_batches_in_order(depth):
    loader = tpipe.ProceduralLoader(3, num_batches=5, img_size=8, seed=1)
    batches = list(tpipe.device_prefetch(iter(loader), depth=depth,
                                         device="cpu"))
    ref = list(loader)
    assert len(batches) == len(ref)
    for (x, y), (rx, ry) in zip(batches, ref):
        assert torch.is_tensor(x) and x.device.type == "cpu"
        assert x.dtype == torch.uint8 and y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(y.numpy(), ry)


def test_device_prefetch_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tpipe.device_prefetch(iter([(np.zeros(2),)])))
