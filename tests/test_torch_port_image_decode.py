"""The port's image decoders (``uvc_tpu_torch/data/imagelib.py``,
``csrc/image/{jpeg,png}.cpp``) against PIL, bit for bit.

JPEG over sizes 1x1 to 500x375, samplings 4:4:4 / 4:2:2 / 4:2:0,
qualities 50 / 75 / 95, baseline, progressive and optimised, grayscale,
CMYK and restart markers, plus a hypothesis property over random sizes,
qualities and samplings; PNG in modes RGB, RGBA, L, LA, P (8-, 4- and
2-bit) and 1; BMP at 24 and 32 bits (WebP, PNG at 16 bits and Adam7 and
the other BMPs in ``test_torch_port_image_formats.py``).  Each decode
must equal ``np.asarray(Image.open(f).convert("RGB"))`` exactly, and
``image_size`` must equal ``Image.open(f).size``.  Files that PIL refuses
too (a corrupt JPEG or WebP, a WebP without an image or of more pixels
than PIL opens, a 2-bit BMP, no image at all) raise ``ValueError`` naming the file, and mutated fixtures
decode or raise but never crash.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import itertools
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from uvc_tpu_torch.data import imagelib

Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (17, 9), (97, 131), (333, 500), (500, 375)]


def _photo(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 90 * np.sin(7 * xx + 3 * yy + c) for c in range(3)],
                   -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.integers(0, 256, 3)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255
                   ).astype(np.uint8)


def assert_decodes_as_pil(path):
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
        size = im.size
    out = imagelib.decode_rgb(str(path))
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert imagelib.image_size(str(path)) == size


@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("sampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_jpeg_matches_pil(tmp_path, wh, sampling):
    """Qualities 50 / 75 / 95, each baseline / progressive and plain /
    optimised Huffman tables."""
    img = Image.fromarray(_photo(*wh, seed=sampling))
    for q, prog, opt in itertools.product((50, 75, 95), (False, True),
                                          (False, True)):
        p = tmp_path / f"q{q}_{prog}_{opt}.jpg"
        img.save(p, quality=q, subsampling=sampling, progressive=prog,
                 optimize=opt)
        assert_decodes_as_pil(p)


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_jpeg_gray_and_cmyk_match_pil(tmp_path, mode, progressive):
    for i, (w, h) in enumerate([(1, 1), (57, 83), (131, 97)]):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(_photo(w, h, i)).convert(mode).save(
            p, quality=85, progressive=progressive)
        assert_decodes_as_pil(p)


@pytest.mark.parametrize("opts", [
    dict(restart_marker_rows=1, subsampling=2),
    dict(restart_marker_blocks=3, subsampling=0),
    dict(restart_marker_blocks=1, progressive=True),
    dict(restart_marker_rows=2, progressive=True, subsampling=1),
], ids=["rows_420", "blocks_444", "blocks_progressive", "rows_progressive"])
def test_jpeg_restart_markers_match_pil(tmp_path, opts):
    p = tmp_path / "r.jpg"
    Image.fromarray(_photo(101, 75, 3)).save(p, quality=80, **opts)
    assert b"\xff\xdd" in p.read_bytes()          # a DRI segment
    assert_decodes_as_pil(p)


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 90), h=st.integers(1, 90),
       quality=st.integers(1, 100), sampling=st.sampled_from([0, 1, 2]),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_jpeg_property_matches_pil(tmp_path_factory, w, h, quality, sampling,
                                   progressive, seed):
    p = tmp_path_factory.mktemp("prop") / "x.jpg"
    Image.fromarray(_photo(w, h, seed)).save(
        p, quality=quality, subsampling=sampling, progressive=progressive)
    assert_decodes_as_pil(p)


def _png_image(mode, w, h):
    base = Image.fromarray(_photo(w, h, 5))
    if mode.startswith("P"):
        colors = {"P": 200, "P16": 16, "P4": 4}[mode]
        return base.convert("P", palette=Image.ADAPTIVE, colors=colors)
    return base.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P16", "P4",
                                  "1"])
def test_png_matches_pil(tmp_path, mode):
    for i, (w, h) in enumerate([(1, 1), (7, 13), (45, 31)]):
        for optimize in (False, True):
            p = tmp_path / f"{i}_{optimize}.png"
            _png_image(mode, w, h).save(p, optimize=optimize)
            assert_decodes_as_pil(p)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"], ids=["24bit", "32bit"])
def test_bmp_matches_pil(tmp_path, mode):
    for i, (w, h) in enumerate([(1, 1), (13, 7), (50, 37)]):
        p = tmp_path / f"{i}.bmp"
        Image.fromarray(_photo(w, h, i)).convert(mode).save(p)
        assert_decodes_as_pil(p)


def _bad_files(tmp_path):
    good = tmp_path / "good.jpg"
    Image.fromarray(_photo(64, 48, 1)).save(good, quality=90)
    data = good.read_bytes()
    Image.fromarray(_photo(16, 16, 2)).save(tmp_path / "w.webp")
    webp = (tmp_path / "w.webp").read_bytes()
    files = {"truncated.jpg": data[: len(data) // 2],
             "garbage.jpg": b"not an image at all",
             "truncated.webp": webp[: len(webp) - 9],
             # a VP8X header and no image chunk
             "empty.webp": b"RIFF\x16\0\0\0WEBPVP8X\x0a\0\0\0" + bytes(4)
             + b"\x0f\0\0\x0f\0\0",
             # 2 bits a pixel, which PIL's BMP reader refuses
             "two_bit.bmp": bytes(_bmp_2bit()),
             # 16383 x 16383: more pixels than PIL opens
             "bomb.webp": webp[:26] + b"\xff\x3f\xff\x3f" + webp[30:]}
    for name, b in files.items():
        (tmp_path / name).write_bytes(b)
    return {"truncated.jpg": "truncated", "garbage.jpg": "not a JPEG",
            "truncated.webp": "truncated", "empty.webp": "without an image",
            "two_bit.bmp": "2 bits per pixel",
            "bomb.webp": "more pixels than PIL opens"}


def _bmp_2bit():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import make_image_fixtures as mk
    return mk.bmp_bytes(8, 2, 2, bytes(8), palette=[(0, 0, 0)] * 4)


def test_undecodable_files_raise_naming_the_file(tmp_path):
    for name, why in _bad_files(tmp_path).items():
        path = str(tmp_path / name)
        with pytest.raises(Exception):        # PIL refuses it too
            with Image.open(path) as im:
                im.convert("RGB")
        with pytest.raises(ValueError, match=why) as info:
            imagelib.decode_rgb(path)
        assert path in str(info.value)
        if name in ("garbage.jpg", "empty.webp", "two_bit.bmp", "bomb.webp"):
            with pytest.raises(ValueError, match=why):
                imagelib.image_size(path)


def test_formats_once_refused_decode_as_pil(tmp_path):
    """WebP, 16-bit and interlaced PNG, which the library refused before
    its decoders for them, decode as PIL decodes them."""
    Image.fromarray(_photo(16, 16, 2)).save(tmp_path / "w.webp")
    Image.fromarray(np.arange(256, dtype=np.uint16).reshape(16, 16) * 200
                    ).save(tmp_path / "g16.png")
    Image.fromarray(_photo(16, 16, 3)).save(tmp_path / "adam7.png")
    raw = bytearray((tmp_path / "adam7.png").read_bytes())
    raw[28] = 1                                   # IHDR interlace method
    raw[29:33] = zlib.crc32(bytes(raw[12:29])).to_bytes(4, "big")
    (tmp_path / "adam7.png").write_bytes(bytes(raw))
    for name in ("w.webp", "g16.png"):
        assert_decodes_as_pil(tmp_path / name)
    # the scanlines were not written for Adam7: PIL and the port read
    # them as its seven passes all the same, or both refuse them
    try:
        with Image.open(tmp_path / "adam7.png") as im:
            ref = np.asarray(im.convert("RGB"))
    except (OSError, ValueError):
        with pytest.raises(ValueError):
            imagelib.decode_rgb(str(tmp_path / "adam7.png"))
    else:
        np.testing.assert_array_equal(
            imagelib.decode_rgb(str(tmp_path / "adam7.png")), ref)


_FUZZ = """
import os, sys
from pathlib import Path
import numpy as np
from uvc_tpu_torch.data import imagelib
fixtures, out, seed, n = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
if len(sys.argv) > 5:        # a library built otherwise (the sanitizers')
    imagelib.build = lambda: Path(sys.argv[5])
files = sorted(f for f in os.listdir(fixtures) if f != "digests.json")
rng = np.random.default_rng(seed)
raised = 0
for it in range(n):
    name = files[rng.integers(len(files))]
    data = bytearray(open(os.path.join(fixtures, name), "rb").read())
    kind = rng.integers(3)
    if kind == 0:            # a few bytes anywhere
        for _ in range(rng.integers(1, 8)):
            data[rng.integers(len(data))] = rng.integers(256)
    elif kind == 1:          # cut short
        data = data[:rng.integers(1, len(data))]
    else:                    # one byte of the headers
        data[rng.integers(2, min(len(data), 400))] = rng.integers(256)
    path = out + os.path.splitext(name)[1]
    with open(path, "wb") as f:
        f.write(data)
    try:
        img = imagelib.decode_rgb(path)
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
        imagelib.load_crop(path, [0, 0, 1, 1, 8, 8, 0, 0, 8, 0, 3])
    except ValueError as e:
        assert path in str(e), e
        raised += 1
print(raised)
"""


def test_corrupted_fixtures_decode_or_raise(tmp_path):
    """300 mutations of the committed fixtures (bytes changed, files cut
    short, headers changed) each decode to an RGB array or raise
    ``ValueError`` naming the file; none crashes the process (run in a
    child, so that a crash fails this test)."""
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", _FUZZ, str(repo / "tests" / "fixtures" /
                                          "images"), str(tmp_path / "m"), "5",
         "300"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(repo)))
    assert res.returncode == 0, res.stderr[-2000:]
    assert 0 < int(res.stdout) < 300


@pytest.mark.slow
def test_corrupted_fixtures_under_sanitizers(tmp_path):
    """The mutation loop above, 6000 mutations over 4 seeds, against the
    library built with AddressSanitizer and UndefinedBehaviorSanitizer
    (any report aborts the child): the decoders read untrusted files, so
    no mutated file may read or write out of bounds or reach undefined
    behaviour.  ~1.5 min on one core."""
    cxx = imagelib._compiler()
    # the runtime first, and the C++ library with it, so that its
    # interceptors find what they wrap (``__cxa_throw``)
    preload = [subprocess.run([cxx, f"-print-file-name={name}"],
                              capture_output=True, text=True).stdout.strip()
               for name in ("libasan.so", "libstdc++.so")]
    if not all(os.path.isabs(p) for p in preload):
        pytest.skip(f"{cxx} has no AddressSanitizer runtime")
    lib = tmp_path / "libuvc_image_asan.so"
    flags = [f for f in imagelib._FLAGS if f != "-O3"]
    subprocess.run(
        [cxx, *flags, "-O1", "-g", "-fno-omit-frame-pointer",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-o", str(lib), *map(str, sorted(imagelib._SRC.glob("*.cpp")))],
        check=True)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), LD_PRELOAD=" ".join(preload),
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1")
    for seed in range(4):
        res = subprocess.run(
            [sys.executable, "-c", _FUZZ, str(repo / "tests" / "fixtures" /
                                              "images"),
             str(tmp_path / f"m{seed}"), str(100 + seed), "1500", str(lib)],
            capture_output=True, text=True, timeout=1200, env=env)
        assert res.returncode == 0, res.stderr[-4000:]
        assert 0 < int(res.stdout) < 1500
