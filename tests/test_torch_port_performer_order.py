"""The token-performer kernels' order of summation (csrc/performer.cu) on
the CPU, against the plain versions and the Pallas kernels.

* ``KernelOrder`` replays the card kernels' sums over the B*N tokens in
  the plain versions (their ``sums`` hook): kptv / kpsum and dkptv / dkpsum
  as per-tile products added tile by tile into per-CTA partials, the
  CTAs of an image in order (``_tile_split``'s partition of each kernel);
  the column sums per CTA of the kernel that takes them (the q kernel's,
  the k|v kernel's); dLN1's a tile (the k|v kernel's, both halves of dxn
  summed there); dWkqv and the 64 x 64 weight gradients over the runs of rows
  that gemm_wg's split takes (``runs``, a mirror of ``product`` in
  csrc/performer.cu), added in run order.  Layouts like the T2T stem's:
  "s2d" (dim 192, the 147 live slots of the space-to-depth stem), "klast"
  (dim 72, a permutation: all live), "dense" (dim 64); N = 50 and 13 (one
  ragged tile) and 520 (nine tiles over two CTAs of an image, the rows of
  the products in two runs).
* Against the plain versions in f32, 1e-5 relative Frobenius per output:
  the same arithmetic summed in another order.  Against the Pallas kernels
  in interpret mode (``_fwd_merged_kernel`` / ``_bwd_merged_kernel`` and
  the split ``_sums_kernel`` + ``_apply_kernel`` / ``_bwd1_kernel`` +
  ``_bwd2_kernel``, one tile of the whole N) in bf16, 2e-2: both round at
  the same places and differ by the order of their f32 sums, i.e. by
  one-ulp flips of single bf16 intermediates carried into the sums after
  them (the tolerance of tests/test_torch_port_performer.py).
* The backward without dx (the stem's first stage) returns every other
  gradient bit for bit, and the autograd Function asks for no dx exactly
  where x needs none.
* The partitions at the card's shapes: every tile in one CTA, contiguous
  runs, about the CTAs aimed for; the scratch the wrappers allocate holds
  every partial the kernels write.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import performer as jperf
from uvc_tpu_torch.configs import get_config
from uvc_tpu_torch.models import t2t_vit as tt2t
from uvc_tpu_torch.ops import performer as tperf
from uvc_tpu_torch.ops.attention import _weight_grad_splits

F32_TOL = 1e-5
BF16_TOL = 2e-2
SMS = 132
EMB, M, TILE = 64, 32, 64
GRAD_OPERANDS = [n for n in tperf.OPERANDS if n not in ("w", "fmask")]
# the operands kept in f32 (LayerNorm parameters, the features, the mask)
F32_NAMES = ("g1", "b1", "w", "fmask", "g2", "b2")


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def runs(rows: int, splits: int):
    """The runs of rows of a product split ``splits`` ways (``product`` in
    csrc/performer.cu): ceil(k-tiles / splits) 64-row k-tiles a run."""
    if splits <= 1:
        return [slice(0, rows)]
    chunk = -(-(-(-rows // 64)) // splits) * 64
    return [slice(z, min(rows, z + chunk)) for z in range(0, rows, chunk)]


class KernelOrder:
    """The sums over tokens in the card kernels' order (see the module
    docstring), for ``performer_plain`` / ``performer_bwd_plain``."""

    def __init__(self, b, n, dim, sms=SMS, tile_sms=None):
        self.b, self.n, self.ntiles = b, n, -(-n // TILE)
        self.split = tperf._splits(b, n, tile_sms or sms)
        rows = b * n
        self.runs = {"dwkqv": runs(rows, _weight_grad_splits(
            dim, 4 * EMB, rows, sms)),
            "dw64": runs(rows, _weight_grad_splits(EMB, EMB, rows, sms))}

    def ctas(self, kernel):
        """Each CTA's tiles, in CTA order."""
        per, ctas = self.split[kernel]
        return [range(c * per, min(self.ntiles, (c + 1) * per))
                for c in range(ctas)]

    def tile(self, t):
        return slice(TILE * t, min(self.n, TILE * (t + 1)))

    @staticmethod
    def _add(total, part):
        return part if total is None else total + part

    def _images(self, kernel, per_tile):
        out = []
        for i in range(self.b):
            total = None
            for cta in self.ctas(kernel):
                part = None
                for t in cta:
                    part = self._add(part, per_tile(i, self.tile(t)))
                total = self._add(total, part)
            out.append(total)
        return out

    def tokens(self, a, b, kernel):
        return torch.stack(self._images(
            kernel, lambda i, sl: a[i, sl].T @ b[i, sl]))

    def token_sum(self, t, kernel):
        return torch.stack(self._images(
            kernel, lambda i, sl: t[i, sl].sum(0, keepdim=True)))

    def colsum(self, t, kernel):
        total = None
        for part in self._images(kernel, lambda i, sl: t[i, sl].sum(0)):
            total = self._add(total, part)
        return total

    def wgrad(self, a, b, kernel):
        a = a.reshape(-1, a.shape[-1])
        b = b.reshape(-1, b.shape[-1])
        total = None
        for sl in self.runs[kernel]:
            total = self._add(total, a[sl].T @ b[sl])
        return total

    def ln1(self, dxn1, dxn2, xhat1):
        g = bt = None
        d = dxn1 + dxn2
        for i in range(self.b):
            for t in range(self.ntiles):
                sl = self.tile(t)
                g = self._add(g, (d[i, sl] * xhat1[i, sl]).sum(0))
                bt = self._add(bt, d[i, sl].sum(0))
        return g, bt


def operands(layout, b, n, seed=0):
    """The stage's operands as ``fused_performer`` builds them (numpy
    draws): x, the LN1 affine and the kqv rows zeroed at dead slots,
    orthogonal random features scaled by sqrt(m), f32 LayerNorm
    parameters; with fcount (None: every slot live, as the JAX package
    passes it)."""
    rng = np.random.default_rng(seed)
    dim = {"s2d": 192, "klast": 72, "dense": 64}[layout]
    fmask = np.ones(dim, np.float32)
    if layout == "s2d":
        _, idx = tperf.s2d_stage1_inputs(torch.zeros(1, 8, 8, 3))
        fmask = (idx >= 0).astype(np.float32)

    def rn(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    q, _ = np.linalg.qr(rng.standard_normal((EMB, M)))
    ops = dict(
        x=rn(b, n, dim), g1=(1 + rn(dim, std=0.1)) * fmask,
        b1=rn(dim, std=0.1) * fmask,
        wkqv=rn(dim, 3 * EMB, std=dim ** -0.5) * fmask[:, None],
        bkqv=rn(3 * EMB, std=0.1), w=(q.T * M ** 0.5).astype(np.float32),
        fmask=fmask, wproj=rn(EMB, EMB, std=0.125), bproj=rn(EMB, std=0.1),
        g2=1 + rn(EMB, std=0.1), b2=rn(EMB, std=0.1),
        wfc1=rn(EMB, EMB, std=0.125), bfc1=rn(EMB, std=0.1),
        wfc2=rn(EMB, EMB, std=0.125), bfc2=rn(EMB, std=0.1))
    live = float(fmask.sum())
    return ops, None if live == dim else live, live


def torch_ops(ops, dtype):
    return [torch.from_numpy(ops[k]).to(torch.float32 if k in F32_NAMES
                                        else dtype)
            for k in tperf.OPERANDS]


CASES = [(layout, n) for layout in ("s2d", "klast", "dense")
         for n in (50, 13)] + [("s2d", 520)]


@pytest.mark.parametrize("layout,n", CASES)
def test_replay_matches_the_plain_versions_f32(layout, n):
    b = 2
    ops, _, live = operands(layout, b, n, seed=n)
    t = torch_ops(ops, torch.float32)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, n, EMB)).astype(np.float32) * 0.1)
    # at N 520 (nine tiles an image) the partition of a two-SM card: CTAs
    # of four or five tiles; the products' rows in two runs
    order = KernelOrder(b, n, t[0].shape[-1], tile_sms=2 if n > TILE else None)
    if n > TILE:
        assert max(len(c) for c in order.ctas("bwd_q")) > 1
        assert len(order.ctas("fwd_sums")) > 1
        assert len(order.runs["dwkqv"]) > 1 and len(order.runs["dw64"]) > 1
    ref = tperf.performer_plain(*t, fcount=live)
    got = tperf.performer_plain(*t, fcount=live, sums=order)
    for o, r in zip(got, ref):
        assert rel_fro(np_(o), np_(r)) <= F32_TOL
    gref = tperf.performer_bwd_plain(*t, ref[1], ref[2], do, fcount=live)
    ggot = tperf.performer_bwd_plain(*t, ref[1], ref[2], do, fcount=live,
                                     sums=order)
    for name, o, r in zip(tperf.GRADS, ggot, gref):
        assert rel_fro(np_(o), np_(r)) <= F32_TOL, name


def _pallas(ops, fcount, merged):
    """The Pallas stage in interpret mode, one tile of the whole N: (out,
    kptv, kpsum) and a function of the output cotangent returning the
    gradients named in ``tperf.GRADS``."""
    args = [jnp.asarray(ops[k]).astype(jnp.float32 if k in F32_NAMES
                                       else jnp.bfloat16)
            for k in tperf.OPERANDS]
    x, rest = args[0], args[1:]
    b, n, _ = x.shape
    if merged:
        out, kptv, kpsum = jperf._call_fwd_merged(
            x, rest, 1, n, jnp.bfloat16, True, fcount)

        def stage(*a):
            return jperf._fused_performer_merged(*a, (1, n), (1, n), True,
                                                 fcount)
    else:
        wkv, bkv, _, _ = jperf._split_kqv(rest[2], rest[3])
        kptv, kpsum = jperf._call_sums(x, rest[0], rest[1], wkv, bkv,
                                       rest[4], rest[5], 1, n, jnp.bfloat16,
                                       True, fcount)
        out = None

        def stage(*a):
            return jperf._fused_performer(*a, 1, n, True, fcount)
    out2, vjp = jax.vjp(stage, *args)

    def grads(do):
        g = vjp(jnp.asarray(do).astype(jnp.bfloat16))
        return [g[tperf.OPERANDS.index(k)] for k in GRAD_OPERANDS]
    return (out2 if out is None else out), kptv, kpsum, grads


# each layout through both Pallas forms, at N 50 or 13
@pytest.mark.parametrize("layout,n,merged", [
    ("s2d", 50, True), ("s2d", 13, False), ("klast", 13, True),
    ("klast", 50, False), ("dense", 50, True), ("dense", 13, False)])
def test_replay_matches_the_pallas_kernels_bf16(layout, n, merged):
    b = 2
    ops, fcount, live = operands(layout, b, n, seed=7)
    t = torch_ops(ops, torch.bfloat16)
    do = np.random.default_rng(2).standard_normal((b, n, EMB)).astype(
        np.float32) * 0.1
    order = KernelOrder(b, n, t[0].shape[-1])
    out, kptv, kpsum = tperf.performer_plain(*t, fcount=live, sums=order)
    grads = tperf.performer_bwd_plain(
        *t, kptv, kpsum, torch.from_numpy(do).to(torch.bfloat16),
        fcount=live, sums=order)
    jout, jkptv, jkpsum, jgrads = _pallas(ops, fcount, merged)
    assert rel_fro(np_(out), np_(jout)) <= BF16_TOL
    assert rel_fro(np_(kptv), np_(jkptv)) <= BF16_TOL
    assert rel_fro(np_(kpsum), np_(jkpsum).reshape(b, 1, M)) <= BF16_TOL
    for name, g, r in zip(tperf.GRADS, grads, jgrads(do)):
        assert rel_fro(np_(g), np_(r)) <= BF16_TOL, name


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_the_dx_less_backward_keeps_every_other_gradient(dt):
    b, n = 2, 50
    ops, _, live = operands("s2d", b, n, seed=3)
    t = torch_ops(ops, dt)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, n, EMB)).astype(np.float32)).to(dt)
    _, kptv, kpsum = tperf.performer(*t, fcount=live)
    full = tperf.performer_bwd(*t, kptv, kpsum, do, fcount=live)
    nodx = tperf.performer_bwd(*t, kptv, kpsum, do, fcount=live, dx=False)
    assert full[0] is not None and nodx[0] is None
    for name, a, c in zip(tperf.GRADS[1:], full[1:], nodx[1:]):
        assert torch.equal(a, c), name


def test_the_stem_asks_for_dx_only_where_x_needs_it(monkeypatch):
    """The stem's first stage reads the image (no gradient): its backward
    takes no dx; the second stage's input is the first's output."""
    cfg = get_config("t2t_vit_14").replace(img_size=32, depth=1)
    params = tt2t.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    asked = []
    real = tperf.performer_bwd

    def spy(*args, **kw):
        asked.append(kw.get("dx", True))
        return real(*args, **kw)

    monkeypatch.setattr(tperf, "performer_bwd", spy)
    for leaf in (params["t2t"]["attention1"]["kqv"]["kernel"],
                 params["t2t"]["attention2"]["kqv"]["kernel"]):
        leaf.requires_grad_()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    tt2t.t2t_stem(params, x, cfg).float().square().sum().backward()
    # the backward runs the second stage first
    assert asked == [True, False]
    assert params["t2t"]["attention1"]["kqv"]["kernel"].grad is not None


# (B, N, dim) of the card's shapes: T2T-ViT-14's stages at batch 64, the
# ragged shape, and one tile of a few tokens
SHAPES = {"t2t_stage1": (64, 3136, 192), "t2t_stage2": (64, 784, 576),
          "ragged": (3, 50, 192), "few": (2, 13, 64)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_partitions_cover_every_tile_and_fit_their_scratch(shape):
    b, n, dim = SHAPES[shape]
    ntiles, rows = -(-n // TILE), b * n
    for kernel, (per, ctas) in tperf._splits(b, n, SMS).items():
        # the kernel's grid: ceil(ntiles / per) CTAs an image
        assert ctas == -(-ntiles // per)
        tiles = [t for c in range(ctas)
                 for t in range(c * per, min(ntiles, (c + 1) * per))]
        assert tiles == list(range(ntiles)), kernel
        aim = tperf._CTAS_PER_SM[kernel] * SMS
        assert b * ctas <= max(b, aim) or ctas == 1, kernel
    sp = tperf._splits(b, n, SMS)
    fwd, (per1, per2) = tperf._fwd_scratch(b, n, "meta", SMS)
    assert (per1, per2) == (sp["fwd_sums"][0], sp["fwd_apply"][0])
    assert fwd["part"].shape == (b * sp["fwd_sums"][1], tperf._PART)
    bwd, (q, kv, s_kqv, s_w) = tperf._bwd_scratch(b, n, dim, "meta", SMS)
    assert (q, kv) == (sp["bwd_q"][0], sp["bwd_kv"][0])
    assert bwd["kpart"].shape[0] == bwd["part1"].shape[0] == b * sp[
        "bwd_q"][1]
    assert bwd["part2"].shape[0] == b * sp["bwd_kv"][1]
    assert bwd["lnpart"].shape == (b * ntiles, 2 * dim)
    # every run of rows of the split products has its partial
    for splits, buf in ((s_kqv, bwd["dpart"]), (s_w, bwd["wpart"][0])):
        parts = runs(rows, splits)
        assert len(parts) <= buf.shape[0]
        assert parts[0].start == 0 and parts[-1].stop == rows
        assert all(a.stop == c.start for a, c in zip(parts, parts[1:]))
