"""The committed image fixtures and their digests, the port's image path
with PIL made unimportable, and the library's build.

* ``tests/fixtures/images/digests.json`` is what PIL and the JAX package
  make of the committed files today (``make_image_fixtures.py``
  recomputes every record), so the card's check against it
  (``chip_smoke.py --images-only``) holds the port to an honest record;
* the port gives every record (``tests/image_check.py``);
* in a subprocess where ``import PIL`` fails, ``FolderLoader`` on both
  paths, ``ArrayLoader`` resizing to 40 px and ``make_train_augment`` run
  and give the batches of this process, and no module of
  ``uvc_tpu_torch`` imports PIL;
* a file the loaders cannot decode raises from the loader's iterator;
  a library that does not compile raises with the compiler's output.
"""

import torch_port_env
from torch_port_env import capped_threads  # noqa: F401  (autouse)
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from uvc_tpu_torch.data import imagelib
from uvc_tpu_torch.data import native_loader as tnative
from uvc_tpu_torch.data import pipeline as tpipe

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import image_check  # noqa: E402
import make_image_fixtures  # noqa: E402

FIXTURES = make_image_fixtures.FIXTURES


def test_fixtures_cover_the_matrix_and_stay_small():
    names = sorted(p.name for p in FIXTURES.iterdir() if p.name !=
                   "digests.json")
    assert names == sorted(make_image_fixtures.file_names())
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1.5e6


def test_committed_digests_are_pil_and_jax_today():
    pytest.importorskip("PIL.Image")
    torch_port_env.jax_native_available()
    committed = json.loads((FIXTURES / "digests.json").read_text())
    assert committed["records"] == make_image_fixtures.reference_records()


def test_port_gives_every_committed_digest():
    report = image_check.check()
    assert report["records"] == 1318
    assert report["mismatches"] == []


def _folder(tmp_path, n_train=None, n_val=10):
    """Symlinks to the fixtures in train/ (every fixture once unless
    ``n_train`` says) and val/ (from the end of the list: the PNG and BMP
    files among them), 4 classes."""
    files = sorted(p for p in FIXTURES.iterdir() if p.name != "digests.json")
    n_train = len(files) if n_train is None else n_train
    for split, n, srcs in (("train", n_train, files),
                           ("val", n_val, files[::-1])):
        for i in range(n):
            d = tmp_path / split / f"class_{i % 4}"
            d.mkdir(parents=True, exist_ok=True)
            src = srcs[i % len(srcs)]
            (d / f"{i:04d}{src.suffix}").symlink_to(src)
    return tmp_path


_NO_PIL = textwrap.dedent("""
    import sys
    sys.modules["PIL"] = None          # any import of PIL now fails
    import pickle
    import numpy as np
    from uvc_tpu_torch.data import augment, native_loader, pipeline
    root, x_path, out_path = sys.argv[1:4]
    out = {}
    aug = augment.make_train_augment("rand-m9-mstd0.5-inc1", 0.0, "bicubic")
    for native in (True, False):
        if not native:
            native_loader.available = lambda: False
        for split, train in (("train", True), ("val", False)):
            loader = pipeline.FolderLoader(
                f"{root}/{split}", 8, train=train, img_size=48, seed=3,
                num_workers=2, interpolation="bicubic", drop_last=False,
                aug=aug if train else None)
            out[(native, split)] = list(loader)
    x = np.load(x_path)
    out["array"] = list(pipeline.ArrayLoader(
        x, np.arange(len(x), dtype=np.int32) % 10, 4, train=True,
        img_size=40, seed=1, aug=aug))
    assert "PIL" not in [m.split(".")[0] for m in sys.modules
                         if sys.modules[m] is not None]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""")


def test_image_path_runs_without_pil(tmp_path):
    root = _folder(tmp_path / "folder")
    x = np.random.default_rng(0).integers(0, 256, (12, 32, 32, 3),
                                          dtype=np.uint8)
    np.save(tmp_path / "x.npy", x)
    out_path = tmp_path / "out.pkl"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _NO_PIL, str(root),
                    str(tmp_path / "x.npy"), str(out_path)],
                   check=True, env=env, timeout=300)
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    # the same batches in this process, where PIL is importable
    from uvc_tpu_torch.data import augment
    aug = augment.make_train_augment("rand-m9-mstd0.5-inc1", 0.0, "bicubic")
    for native in (True, False):
        for split, train in (("train", True), ("val", False)):
            orig = tnative.available
            if not native:
                tnative.available = lambda: False
            try:
                ref = list(tpipe.FolderLoader(
                    str(root / split), 8, train=train, img_size=48, seed=3,
                    num_workers=2, interpolation="bicubic", drop_last=False,
                    aug=aug if train else None))
            finally:
                tnative.available = orig
            batches = got[(native, split)]
            assert len(batches) == len(ref) > 0
            for (xa, ya), (xb, yb) in zip(batches, ref):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
    ref = list(tpipe.ArrayLoader(x, np.arange(12, dtype=np.int32) % 10, 4,
                                 train=True, img_size=40, seed=1, aug=aug))
    assert len(got["array"]) == len(ref) == 3
    for (xa, _), (xb, _) in zip(got["array"], ref):
        assert xa.shape == (4, 40, 40, 3)
        np.testing.assert_array_equal(xa, xb)


def test_data_bench_times_the_photo_fixtures(capsys, monkeypatch):
    """``scripts/data_bench.py`` at a toy size on the CPU, given the
    fixtures as a relative path: it times the photo-sized JPEGs alone, on
    both paths, and writes its record."""
    from uvc_tpu_torch.scripts import data_bench
    monkeypatch.chdir(REPO)
    rep = data_bench.main(["--fixtures", "tests/fixtures/images",
                           "--batch", "4", "--batches", "1", "--repeats",
                           "1", "--workers", "2", "--img_size", "32"])
    assert [s["file"] for s in rep["sources"]] == sorted(
        make_image_fixtures.IMAGENET_LIKE)
    for s in rep["sources"]:
        w, h, _ = make_image_fixtures.IMAGENET_LIKE[s["file"]]
        assert tuple(s["size"]) == (w, h) and s["bytes"] > 30000
    for mode in ("train", "train_randaug", "eval"):
        assert rep[mode]["native"] > 0 and rep[mode]["pil"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rep


def test_no_module_of_the_port_imports_pil():
    pattern = re.compile(r"^\s*(import PIL|from PIL\b)", re.M)
    hits = [str(p.relative_to(REPO))
            for p in (REPO / "uvc_tpu_torch").rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
def test_folder_loader_raises_for_an_unreadable_file(tmp_path, monkeypatch,
                                                     native):
    root = _folder(tmp_path, n_train=6, n_val=0)
    bad = tmp_path / "train" / "class_1" / "zz_bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 cut short")
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    loader = tpipe.FolderLoader(str(root / "train"), 7, train=False,
                                img_size=32, num_workers=2)
    with pytest.raises(ValueError, match="zz_bad.jpg"):
        list(loader)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    cxx = tmp_path / "broken-c++"
    cxx.write_text("#!/bin/sh\necho 'error: this compiler refuses'\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(imagelib, "build_dir", lambda: tmp_path / "b")
    with pytest.raises(RuntimeError, match="this compiler refuses"):
        imagelib.build()
    assert not list((tmp_path / "b").glob("*.so"))
