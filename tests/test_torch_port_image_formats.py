"""The port's WebP, interlaced and 16-bit PNG and palette, 16-bit and
run-length BMP decoders (``csrc/image/{webp_vp8,webp_vp8l,png,bmp}.cpp``)
against PIL, bit for bit.

Lossy WebP over sizes 1x1 to 500x375, qualities and methods, with and
without alpha, plus a hypothesis property; lossless WebP in RGB, RGBA and
palettes of 2 to 200 colours (every pixel bundling); uncompressed alpha
under each of its four filters, and ALPH chunks that libwebp refuses or
takes; an animation's first frame, also at an offset inside its canvas;
VP8 frames with the header fields libwebp's encoder never writes; PNG of
every colour type at every bit depth, plain and Adam7; BMP at 1, 4, 8 and
16 bits, OS/2, top-down, and RLE8 / RLE4 (PIL cannot write them, so the
files are written here with ``make_image_fixtures``'s encoders, and a run
of random RLE streams holds the port to PIL's reading of them), and an
RLE delta that points past an image of a million pixels.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import itertools
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from uvc_tpu_torch.data import imagelib

Image = pytest.importorskip("PIL.Image")
sys.path.insert(0, str(Path(__file__).resolve().parent))
import make_image_fixtures as mk  # noqa: E402

photo = mk.photo


def assert_decodes_as_pil(path):
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
        size = im.size
    out = imagelib.decode_rgb(str(path))
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert imagelib.image_size(str(path)) == size


def decodes_or_raises_as_pil(path) -> bool:
    """The port's decode equals PIL's, or both refuse the file (the port
    with a ``ValueError`` naming it); whether PIL decoded it."""
    try:
        with Image.open(path) as im:
            ref = np.asarray(im.convert("RGB"))
    except (OSError, ValueError):
        with pytest.raises(ValueError, match=str(path)):
            imagelib.decode_rgb(str(path))
        return False
    np.testing.assert_array_equal(imagelib.decode_rgb(str(path)), ref)
    return True


def _rgba(w, h, seed):
    """A photo with an alpha of its own: a transparent corner, and the
    RGB under it kept (PIL's ``convert("RGB")`` drops alpha unblended)."""
    a = photo(w, h, seed + 1)[..., :1]
    a[: h // 3, : w // 3] = 0
    return np.dstack([photo(w, h, seed), a])


WEBP_SIZES = [(1, 1), (17, 9), (33, 47), (500, 375)]


@pytest.mark.parametrize("wh", WEBP_SIZES,
                         ids=[f"{w}x{h}" for w, h in WEBP_SIZES])
def test_webp_lossy_matches_pil(tmp_path, wh):
    """Qualities 5 / 50 / 95 at methods 0, 4 and 6, on a noisy photo."""
    img = Image.fromarray(photo(*wh, seed=wh[0], noise=16))
    for q, m in itertools.product((5, 50, 95), (0, 4, 6)):
        p = tmp_path / f"q{q}_m{m}.webp"
        img.save(p, quality=q, method=m)
        assert_decodes_as_pil(p)


@pytest.mark.parametrize("wh", [(1, 1), (31, 17), (97, 64)],
                         ids=["1x1", "31x17", "97x64"])
def test_webp_lossy_with_alpha_matches_pil(tmp_path, wh):
    """The ALPH chunk, lossless (alpha quality 100) or level-reduced, at
    methods 0 and 6; the RGB under transparent pixels as decoded."""
    img = Image.fromarray(_rgba(*wh, seed=3))
    for aq, m, exact in ((100, 0, True), (100, 6, False), (40, 4, True)):
        p = tmp_path / f"a{aq}_m{m}.webp"
        img.save(p, quality=60, method=m, alpha_quality=aq, exact=exact)
        assert_decodes_as_pil(p)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "p2", "p4", "p16", "p200"])
def test_webp_lossless_matches_pil(tmp_path, kind):
    """Each predictor, cross-colour, subtract-green and colour-indexing
    transform the encoder picks over sizes, qualities and methods; the
    palettes of 2, 4 and 16 colours bundle 8, 4 and 2 pixels a byte."""
    for i, ((w, h), (q, m)) in enumerate(itertools.product(
            [(1, 1), (13, 7), (64, 48), (250, 187)], [(0, 0), (75, 4),
                                                      (100, 6)])):
        if kind == "rgba":
            img = Image.fromarray(_rgba(w, h, i))
        elif kind == "rgb":
            img = Image.fromarray(photo(w, h, i))
        else:
            img = Image.fromarray(photo(w, h, i)).quantize(int(kind[1:]))
        p = tmp_path / f"{i}.webp"
        img.save(p, lossless=True, quality=q, method=m, exact=True)
        assert_decodes_as_pil(p)


def test_webp_alpha_filters_and_animations_match_pil(tmp_path):
    """Uncompressed alpha under the none / horizontal / vertical /
    gradient filters; the first frame of animations PIL writes (lossy and
    lossless) and of one written here whose first frame sits at (6, 8)
    inside its canvas, on zeros."""
    rgb, alpha = photo(21, 13, 7), photo(21, 13, 8)[..., 0]
    for filt in range(4):
        p = tmp_path / f"alpha_{filt}.webp"
        p.write_bytes(mk.raw_alpha_webp(rgb, alpha, filt))
        assert_decodes_as_pil(p)
    frames = [Image.fromarray(photo(40, 30, s)) for s in range(3)]
    for lossless in (False, True):
        p = tmp_path / f"anim_{lossless}.webp"
        frames[0].save(p, save_all=True, append_images=frames[1:],
                       duration=50, lossless=lossless)
        assert_decodes_as_pil(p)
    p = tmp_path / "offset.webp"
    p.write_bytes(mk.anim_webp((48, 32), [(6, 8, frames[1].crop((0, 0, 30,
                                                                  20))),
                                          (0, 0, frames[2].resize((48,
                                                                   32)))]))
    assert_decodes_as_pil(p)
    assert imagelib.decode_rgb(str(p))[:8].max() == 0



def test_webp_alpha_chunk_decodes_or_raises_as_pil(tmp_path):
    """No RGB value depends on the alpha, but libwebp refuses a file whose
    ALPH chunk does not decode: every header byte over an uncompressed and
    a lossless-coded alpha, each cut short and made longer, and 100
    lossless streams with bits flipped."""
    chunks = mk._webp_chunks(Image.fromarray(_rgba(31, 17, seed=3)),
                             quality=60, alpha_quality=100)
    assert chunks[:4] == b"ALPH"
    n = struct.unpack("<I", chunks[4:8])[0]
    coded, vp8 = chunks[8:8 + n], chunks[8 + n + n % 2:]
    raw = bytes((coded[0] & ~3,)) + photo(31, 17, 4)[..., 0].tobytes()
    bodies = [bytes((b,)) + body[1:] for body in (raw, coded)
              for b in range(256)]
    for body in (raw, coded):
        bodies += [body[:k] for k in (0, 1, 2, len(body) // 2, len(body) - 1)]
        bodies.append(body + bytes(9))
    rng = np.random.default_rng(0)
    for _ in range(100):
        body = bytearray(coded)
        for _ in range(int(rng.integers(1, 4))):
            body[int(rng.integers(1, len(body)))] ^= 1 << int(rng.integers(8))
        bodies.append(bytes(body))
    decoded = 0
    for i, body in enumerate(bodies):
        p = tmp_path / f"{i}.webp"
        p.write_bytes(mk._riff(mk._vp8x(0x10, 31, 17) +
                               mk._chunk(b"ALPH", body) + vp8))
        decoded += decodes_or_raises_as_pil(p)
    assert 0 < decoded < len(bodies)


@settings(max_examples=25, deadline=None)
@given(w=st.integers(1, 90), h=st.integers(1, 90),
       quality=st.integers(0, 100), method=st.integers(0, 6),
       alpha=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_webp_property_matches_pil(tmp_path_factory, w, h, quality, method,
                                   alpha, seed):
    p = tmp_path_factory.mktemp("webp") / "x.webp"
    img = _rgba(w, h, seed) if alpha else photo(w, h, seed, noise=16)
    Image.fromarray(img).save(p, quality=quality, method=method)
    assert_decodes_as_pil(p)


def test_vp8_header_fields_match_pil(tmp_path):
    """60 key frames whose headers carry what libwebp's encoder never
    writes (``make_image_fixtures.vp8_webp``: the simple loop filter,
    sharpness, loop-filter deltas, 2-8 token partitions, relative segment
    values, coefficient probability updates; random modes and tokens):
    each decodes as libwebp decodes it, or both refuse it (a partition
    read past its end)."""
    rng = np.random.default_rng(0)
    decoded = 0
    for i in range(60):
        w, h = (int(v) for v in rng.integers(1, 70, 2))
        p = tmp_path / f"{i}.webp"
        p.write_bytes(mk.vp8_webp(
            rng, w, h, simple=bool(rng.integers(2)),
            level=int(rng.integers(0, 64)),
            sharpness=int(rng.integers(0, 8)),
            lf_delta=bool(rng.integers(2)), parts_log2=int(rng.integers(4)),
            segments=bool(rng.integers(2)), absolute=bool(rng.integers(2)),
            q=int(rng.integers(0, 128)), update_probs=bool(rng.integers(2))))
        try:
            with Image.open(p) as im:
                ref = np.asarray(im.convert("RGB"))
        except OSError:
            with pytest.raises(ValueError, match="truncated"):
                imagelib.decode_rgb(str(p))
            continue
        np.testing.assert_array_equal(imagelib.decode_rgb(str(p)), ref)
        decoded += 1
    assert decoded > 45


# colour type -> its bit depths
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}


@pytest.mark.parametrize("ctype", sorted(PNG_DEPTHS),
                         ids=["gray", "rgb", "palette", "gray_alpha", "rgba"])
def test_png_depths_and_adam7_match_pil(tmp_path, ctype):
    """Every bit depth of the colour type, plain and Adam7 (passes that
    are empty at 1x1 and 3x2), every filter in turn; 16-bit samples by
    their high byte, 16-bit gray clipped to 255 as PIL's mode I;16."""
    rng = np.random.default_rng(ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for depth, interlace, (w, h) in itertools.product(
            PNG_DEPTHS[ctype], (False, True), [(1, 1), (3, 2), (9, 11),
                                               (37, 21)]):
        s = rng.integers(0, 1 << depth, (h, w, ch))
        if ctype == 0 and depth == 16:
            s %= 600                       # about PIL's clip at 255
        plte = rng.integers(0, 256, 3 << depth, dtype=np.uint8).tobytes() \
            if ctype == 3 else b""
        p = tmp_path / f"{depth}_{interlace}_{w}x{h}.png"
        p.write_bytes(mk.png_bytes(s, depth, ctype, interlace, plte))
        assert_decodes_as_pil(p)


def test_bmp_depths_match_pil(tmp_path):
    """1-, 4- and 8-bit palettes (and a gray one, read as PIL's L mode),
    16 bits as 5-5-5 and through 5-6-5 / 5-5-5 bit fields, 24 and 32
    bits with every bit-field layout PIL takes, the OS/2 core header and
    top-down rows, over odd sizes."""
    rng = np.random.default_rng(0)
    layouts = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
               (0xFF000000, 0xFF00, 0xFF, 0),
               (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
               (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
               (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
               (0xFF000000, 0xFF00, 0xFF, 0xFF0000)]
    for w, h in [(1, 1), (13, 7), (37, 23)]:
        cases = []
        for bits in (1, 4, 8):
            for gray in (False, True):
                n = 1 << bits
                pal = [(v, v, v) for v in (range(n) if n != 2 else (0, 255))] \
                    if gray and bits in (1, 8) else \
                    [tuple(int(x) for x in c) for c in
                     rng.integers(0, 256, (n - (bits == 8) * 56, 3))]
                for core in (False, True):
                    cases.append(dict(bits=bits, palette=pal, core=core))
        cases += [dict(bits=16), dict(bits=16, comp=3,
                                      masks=(0xF800, 0x7E0, 0x1F)),
                  dict(bits=16, comp=3, masks=(0x7C00, 0x3E0, 0x1F)),
                  dict(bits=24, top_down=True), dict(bits=24, core=True),
                  dict(bits=32, comp=3, masks=(0xFF0000, 0xFF00, 0xFF))]
        for i, c in enumerate(cases):
            stride = (w * c["bits"] + 31) // 32 * 4
            pixels = rng.integers(0, 256, stride * h, dtype=np.uint8)
            p = tmp_path / f"{w}_{i}.bmp"
            p.write_bytes(mk.bmp_bytes(w, h, pixels=pixels.tobytes(), **c))
            assert_decodes_as_pil(p)
        for m in layouts:  # 32-bit layouts need the masks in the header
            data = bytearray(mk.bmp_bytes(
                w, h, 32, rng.integers(0, 256, 4 * w * h,
                                       dtype=np.uint8).tobytes(), comp=3,
                masks=m))
            data[14:18] = struct.pack("<I", 56)  # a V3 header: 4 masks
            p = tmp_path / f"{w}_mask_{m[0]:x}_{m[3]:x}.bmp"
            p.write_bytes(bytes(data))
            assert_decodes_as_pil(p)


def _random_rle(rng, w, h, rle4):
    """A stream of runs, literal stretches (odd ones too), ends of line,
    deltas and maybe the end of the bitmap, some running past a row."""
    s = bytearray()
    for _ in range(int(rng.integers(1, 3 * h + 5))):
        op = rng.integers(0, 10)
        if op < 5:
            s += bytes([int(rng.integers(1, w + 3)), int(rng.integers(256))])
        elif op < 7:
            n = int(rng.integers(3, 2 * w + 3))
            s += bytes([0, n]) + rng.integers(0, 256, (n + 1) // 2 if rle4
                                              else n, dtype=np.uint8).tobytes()
            s += b"\0" * (len(s) % 2)
        elif op < 9:
            s += b"\0\0"
        else:
            s += bytes([0, 2, *rng.integers(0, 4, 4).tolist()])
    return bytes(s + (b"\0\1" if rng.integers(2) else b""))


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_bmp_rle_matches_pil(tmp_path, rle4):
    """A clean RLE file from the fixtures' encoder, then 300 random
    streams: each decodes as PIL's BmpRleDecoder reads it (its four-byte
    delta, its odd RLE4 literals) or raises where PIL raises."""
    rng = np.random.default_rng(int(rle4))
    bits = 4 if rle4 else 8
    pal = [tuple(int(x) for x in c) for c in
           rng.integers(0, 256, (1 << bits, 3))]
    idx = photo(37, 23, 5)[..., 0] >> (8 - bits)
    p = tmp_path / "clean.bmp"
    p.write_bytes(mk.bmp_bytes(37, 23, bits, mk.rle_bytes(idx, rle4),
                               comp=2 if rle4 else 1, palette=pal))
    assert_decodes_as_pil(p)
    agreed = 0
    for i in range(300):
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
        gray = rng.integers(5) == 0 and not rle4
        p = tmp_path / f"{i}.bmp"
        p.write_bytes(mk.bmp_bytes(
            w, h, bits, _random_rle(rng, w, h, rle4), comp=2 if rle4 else 1,
            palette=[(v, v, v) for v in range(256)] if gray else pal))
        agreed += decodes_or_raises_as_pil(p)
    assert 50 < agreed < 300


def test_bmp_rle_delta_stops_at_the_image(tmp_path):
    """A delta moves no further than the image's end, since PIL reads only
    its first w * h values: at 40x1 as PIL reads it, and at 2**20 x 1 the
    same bits with a few MB for them (255 rows of 2**20 would be 255 MB)."""
    pal = [(i, 255 - i, i // 2) for i in range(256)]
    # five of index 7, then a delta of 255 rows (PIL skips two bytes first)
    stream = bytes([5, 7, 0, 2, 0, 0, 0, 255])
    small = tmp_path / "small.bmp"
    small.write_bytes(mk.bmp_bytes(40, 1, 8, stream, comp=1, palette=pal))
    assert decodes_or_raises_as_pil(small)
    wide = tmp_path / "wide.bmp"
    wide.write_bytes(mk.bmp_bytes(1 << 20, 1, 8, stream, comp=1,
                                  palette=pal))
    imagelib.library()  # built here, only loaded by the child
    child = (
        "import json, resource, sys\n"
        "import numpy as np\n"
        "from uvc_tpu_torch.data import imagelib\n"
        "imagelib.library()\n"
        "peak = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "before = peak()\n"
        "out = imagelib.decode_rgb(sys.argv[1])\n"
        "print(json.dumps({'grown_kb': peak() - before,\n"
        "                  'shape': list(out.shape),\n"
        "                  'head': np.unique(out[0, :5], axis=0).tolist(),\n"
        "                  'rest': np.unique(out[0, 5:], axis=0).tolist()}))\n")
    got = json.loads(subprocess.run(
        [sys.executable, "-c", child, str(wide)], check=True, text=True,
        capture_output=True, cwd=Path(__file__).resolve().parents[1]).stdout)
    assert got["shape"] == [1, 1 << 20, 3]
    assert got["head"] == [list(pal[7])] and got["rest"] == [list(pal[0])]
    assert got["grown_kb"] < 64 * 1024
