"""The MLP backward kernels A6 (``mlp_ln_bwd``) and A4
(``mlp_ln_blend_bwd``) and the LayerNorm backward they share with A2, in
the port (uvc_tpu_torch/ops/mlp.py, csrc/mlp.cu, csrc/ln_bwd.cuh) against
the JAX package, on the CPU.

* The plain versions at ViT-H/14's widths (dm 1280, F 5120; B = 1,
  N = 13) against ``jax.vjp`` of ``fused_mlp_ln`` / ``fused_mlp_ln_blend``
  in interpret mode in bf16, their VMEM budget set to take the whole width
  in one kernel (at this width the JAX package splits or composes for its
  budget alone; the function is the same): 2e-2 relative Frobenius per
  gradient, as in ``test_torch_port_grads.py``; and against the autodiff
  of the JAX CPU composition in f32: 2e-4.
* ``replay_mlp_bwd``: the card kernels' order on the CPU -- the h
  product's per-tile partials (128-row tiles; dd1's per 128 x 128 tile),
  dW2 and dW1 summed over the splits the wrapper
  chooses, and the LayerNorm backward's partition (``_ln_bwd_split``: a
  warp a row, a CTA's warps' slots added in warp order, the CTAs' partial
  rows in index order) with colsum(do) in the same pass -- against the
  plain versions in f32 (1e-5) and bf16 (2e-2).
* The partitions at the card's shapes ("train", "ragged", "h80",
  "vit_h"): about twice 132 CTAs (at least 4 rows a CTA), every row in
  one CTA, a CTA's slots within ~48 KB of shared memory; and the partial
  buffers the wrappers
  allocate (``_mlp_bwd_scratch``, ``_sublayer_bwd_scratch``) hold every
  partial the kernels write.
* The route at ViT-H/14's width: the autograd Functions take A2 and A4
  (their plain versions on the CPU) at dm 1280 and the composed routes
  past it, as ``composed_counts`` shows.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.configs import get_config
from uvc_tpu_torch.ops import attention as tatt
from uvc_tpu_torch.ops import mlp as tmlp
from uvc_tpu_torch.ops.attention import _ln_rows

BF16_TOL = 2e-2
F32_TOL = 2e-4
EPS = 1e-6
LN_KEYS = ("g2", "b2", "d")
MLP_ORDER = ("x", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2", "mask")
BLEND_ORDER = ("x", "xin", "d", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2",
               "mask")
SMS = 132
VIT_H = dict(dm=1280, f=5120)

# (rows, dm) of the card's backward shapes: DeiT-Small's stage 1 at batch
# 64 and 3, the head-dim-80 sublayer at batch 8, ViT-H/14's at batch 32
SHAPES = {"train": (64 * 197, 384), "ragged": (3 * 197, 384),
          "h80": (8 * 257, 640), "vit_h": (32 * 257, 1280)}


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def mlp_inputs(seed, b, n, dm, f, d=(0.3, 0.7)):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(f) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        xin=rng.standard_normal((b, n, dm)).astype(f32),
        d=np.asarray(d, f32),
        g2=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b2=(0.1 * rng.standard_normal(dm)).astype(f32),
        wfc1=(rng.standard_normal((dm, f)) / np.sqrt(dm)).astype(f32),
        bfc1=(0.1 * rng.standard_normal(f)).astype(f32),
        wfc2=(rng.standard_normal((f, dm)) / np.sqrt(f)).astype(f32),
        bfc2=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask,
        do=(0.5 * rng.standard_normal((b, n, dm))).astype(f32))


def as_jax(inp, order, dtype):
    return [jnp.asarray(inp[k]).astype(jnp.float32 if k in LN_KEYS
                                       else dtype) for k in order]


def as_torch(inp, order, dtype):
    return [torch.from_numpy(inp[k]).to(torch.float32 if k in LN_KEYS
                                        else dtype) for k in order]


def jax_vjp(fn, args, do):
    _, vjp = jax.vjp(fn, *args)
    return vjp(do)


def assert_grads_close(got, ref, order, tol):
    assert len(got) == len(ref) == len(order)
    for name, g, r in zip(order, got, ref):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        assert tuple(g.shape) == r.shape, name
        err = rel_fro(g.float().numpy(), r)
        assert err <= tol, f"d{name}: relative Frobenius {err:.2e} > {tol}"


def _mlp_jax(blend, fused):
    if blend:
        fn = jmlp.fused_mlp_ln_blend if fused else jmlp._composed_mlp_ln_blend
    else:
        fn = jmlp.fused_mlp_ln if fused else jmlp._composed_mlp_ln
    if fused:
        return lambda *a: fn(*a, eps=EPS, interpret=True)
    return lambda *a: fn(*a, EPS)


# ---------------------------------------------------------------------------
# the plain versions at ViT-H/14's widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blend", [False, True])
def test_plain_matches_pallas_at_vit_h_width_bf16(monkeypatch, blend):
    calls = []
    real = jmlp._call_mlp_blend_bwd if blend else jmlp._call_mlp_bwd

    def spy(*a, **k):
        calls.append(k.get("full", True))
        return real(*a, **k)

    # the whole width in one kernel: at dm 1280 the VMEM budget would split
    # F or compose; in interpret mode the body runs at any width
    monkeypatch.setattr(jmlp, "_mlp_bwd_group", lambda *a, **k: 1)
    monkeypatch.setattr(jmlp, "_mlp_blend_bwd_group", lambda *a, **k: 1)
    monkeypatch.setattr(jmlp, "_call_mlp_blend_bwd" if blend
                        else "_call_mlp_bwd", spy)
    order = BLEND_ORDER if blend else MLP_ORDER
    inp = mlp_inputs(40 + blend, 1, 13, VIT_H["dm"], VIT_H["f"])
    ref = jax_vjp(_mlp_jax(blend, True), as_jax(inp, order, jnp.bfloat16),
                  jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    assert calls == [True]
    t = as_torch(inp, order + ("do",), torch.bfloat16)
    plain = tmlp.mlp_ln_blend_bwd_plain if blend else tmlp.mlp_ln_bwd_plain
    got = plain(*t, eps=EPS)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_grads_close(got, ref, order, BF16_TOL)


@pytest.mark.parametrize("blend", [False, True])
def test_plain_matches_composition_at_vit_h_width_f32(blend):
    order = BLEND_ORDER if blend else MLP_ORDER
    inp = mlp_inputs(42 + blend, 1, 13, VIT_H["dm"], VIT_H["f"])
    ref = jax_vjp(_mlp_jax(blend, False), as_jax(inp, order, jnp.float32),
                  jnp.asarray(inp["do"]))
    plain = tmlp.mlp_ln_blend_bwd_plain if blend else tmlp.mlp_ln_bwd_plain
    got = plain(*as_torch(inp, order + ("do",), torch.float32), eps=EPS)
    assert_grads_close(got, ref, order, F32_TOL)


# ---------------------------------------------------------------------------
# the kernels' order, replayed on the CPU
# ---------------------------------------------------------------------------


def in_order(parts):
    """The partials added one after another from 0, as launch_reduce adds
    them."""
    s = torch.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def replay_ln_bwd(x, gamma, dy, resid, d, xin, eps):
    """The LayerNorm backward (csrc/ln_bwd.cuh) in its order: the rows
    split as ``_ln_bwd_split`` splits them, warp w of a CTA adding its rows
    (w, w + warps, ...) into its slot, the slots added in warp order into
    the CTA's partial row ``[dy * xhat | dy | resid | resid . x,
    resid . xin]``, the partial rows added in index order.  x, dy, resid,
    xin: ``[rows, dm]``.  Returns (dx, dxin or None, sums, partial rows)."""
    rows, dm = x.shape
    per, warps, ctas = tatt._ln_bwd_split(rows, dm)
    x32 = x.float()
    _, xhat, inv = _ln_rows(x32, torch.ones(dm), torch.zeros(dm), eps)
    r32 = resid.float()
    c_res = d[1].float() if d is not None else 1.0
    dg = dy * gamma
    m1 = dg.mean(-1, keepdim=True)
    m2 = (dg * xhat).mean(-1, keepdim=True)
    dx = ((dg - m1 - xhat * m2) * inv + c_res * r32).to(x.dtype)
    terms = torch.cat([dy * xhat, dy, r32], dim=1)
    if xin is not None:
        dots = torch.stack([(r32 * x32).sum(1), (r32 * xin.float()).sum(1)],
                           dim=1)
    else:
        dots = torch.zeros(rows, 2)
    parts = []
    seen = torch.zeros(rows, dtype=torch.int64)
    for c in range(ctas):
        r0, r1 = c * per, min(rows, (c + 1) * per)
        slots = []
        for w in range(warps):
            mine = list(range(r0 + w, r1, warps))
            seen[mine] += 1
            slot = torch.zeros(3 * dm + 2)
            for r in mine:
                slot = slot + torch.cat([terms[r], dots[r]])
            slots.append(slot)
        parts.append(in_order(slots))
    assert torch.equal(seen, torch.ones(rows, dtype=torch.int64))
    dxin = (d[0].float() * r32).to(xin.dtype) if xin is not None else None
    return dx, dxin, in_order(parts), torch.stack(parts)


def replay_mlp_bwd(x, xin, d, g2, b2, w1, b1, w2, bias2, mask, do, eps):
    """A6 (``xin`` None) or A4 in the card kernels' order (csrc/mlp.cu::
    mlp_backward): m_in = LN2(x) rounded; dam0 = do . W2^T in f32; the
    h product's epilogue per 128 x 128 tile (dmask, db1 column partials,
    dd1's term a tile); dW2 = d1 *
    am^T . do and dW1 = m_in^T . dh summed over the wrapper's splits in
    order; dmi = dh . W1^T; the LayerNorm backward's partition; dd from
    the sums.  Returns the gradients in ``_MLP_GRADS`` / ``_BLEND_GRADS``
    order, each in its input's dtype."""
    dt = x.dtype
    b, n, dm = x.shape
    f = w1.shape[1]
    rows = b * n
    x2, do2 = x.reshape(rows, dm), do.reshape(rows, dm)
    m32, _, _ = _ln_rows(x2.float(), g2.float(), b2.float(), eps)
    m_in = m32.to(dt).float()
    dob = do2.float()
    d1 = d.float()[1] if d is not None else torch.tensor(1.0)
    dam0 = dob @ w2.float().T
    h = m_in @ w1.float() + b1.float()
    phi = 0.5 * (1.0 + torch.erf(h / 2 ** 0.5))
    pdf = torch.exp(-0.5 * h * h) * 0.39894228040143268
    a = h * phi
    am32 = a * mask.float()
    dam = dam0 * d1
    dh = dam * mask.float() * (phi + h * pdf)
    am, dh_b = am32.to(dt).float(), dh.to(dt).float()
    tm = -(-rows // 128)
    bn = 128
    tiles = [slice(i * 128, (i + 1) * 128) for i in range(tm)]
    dmask = in_order([(dam * a)[t].sum(0) for t in tiles])
    db1 = in_order([dh[t].sum(0) for t in tiles])
    dd1_act = in_order([(dam0 * am32)[t, j * bn:(j + 1) * bn].sum()
                        for t in tiles for j in range(-(-f // bn))])
    s2, s1 = tmlp._mlp_bwd_scratch(rows, dm, f, "meta", SMS)[1]

    def split_sum(lhs, rhs, splits):
        ktiles = -(-rows // 64)
        chunk = -(-ktiles // splits) * 64
        return in_order([lhs[k:k + chunk].T @ rhs[k:k + chunk]
                         for k in range(0, rows, chunk)])

    dw2 = (split_sum(am, dob, s2) * d1).to(w2.dtype)
    dw1 = split_sum(m_in, dh_b, s1).to(w1.dtype)
    dmi = dh_b @ w1.float().T
    dx, dxin, sums, _ = replay_ln_bwd(
        x2, g2.float(), dmi, do2, d, None if xin is None
        else xin.reshape(rows, dm), eps)
    grads = dict(dx=dx.reshape(x.shape), dg2=sums[:dm], db2=sums[dm:2 * dm],
                 dwfc1=dw1, dbfc1=db1.to(b1.dtype), dwfc2=dw2,
                 dbfc2=(d1 * sums[2 * dm:3 * dm]).to(bias2.dtype),
                 dmask=dmask.to(mask.dtype))
    if xin is None:
        return tuple(grads[k] for k in tmlp._MLP_GRADS)
    dd1 = dd1_act + sums[3 * dm] + (sums[2 * dm:3 * dm]
                                    * bias2.float()).sum()
    grads.update(dxin=dxin.reshape(x.shape),
                 dd=torch.stack([sums[3 * dm + 1], dd1]).to(d.dtype))
    return tuple(grads[k] for k in tmlp._BLEND_GRADS)


# rows 600 at dm 96: 4 rows a CTA over 4 warps, 150 CTAs, 5 h tiles (the
# last ragged), F 320 (three 128-column tiles, the last ragged)
@pytest.mark.parametrize("blend", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_replay_matches_plain(blend, dtype, tol):
    order = BLEND_ORDER if blend else MLP_ORDER
    inp = mlp_inputs(44, 4, 150, 96, 320)
    t = as_torch(inp, order + ("do",), dtype)
    plain = tmlp.mlp_ln_blend_bwd_plain if blend else tmlp.mlp_ln_bwd_plain
    ref = plain(*t, eps=EPS)
    if blend:
        got = replay_mlp_bwd(*t, eps=EPS)
    else:
        x, g2, b2, w1, b1, w2, bias2, mask, do = t
        got = replay_mlp_bwd(x, None, None, g2, b2, w1, b1, w2, bias2, mask,
                             do, eps=EPS)
    assert tatt._ln_bwd_split(600, 96) == (4, 4, 150)
    for name, g, r in zip(order, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = rel_fro(g.float().numpy(), r.float().numpy())
        assert err <= tol, f"d{name}: relative Frobenius {err:.2e} > {tol}"


def test_replayed_ln_partials_hold_colsum_of_do():
    """The LayerNorm backward's third partial plane is colsum(do) over the
    CTA's rows: its in-order sum is the output bias's gradient (A2's
    dbproj, A4 and A6's db2 before d1), and the planes' sums are dgamma and
    dbeta."""
    rng = np.random.default_rng(45)
    rows, dm = 2056, 40
    x, dy, do = (torch.from_numpy(rng.standard_normal((rows, dm))
                                  .astype(np.float32)) for _ in range(3))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(dm)
                             .astype(np.float32))
    per, warps, ctas = tatt._ln_bwd_split(rows, dm)
    _, _, sums, parts = replay_ln_bwd(x, gamma, dy, do, None, None, EPS)
    assert parts.shape == (ctas, 3 * dm + 2) == (294, 122)
    _, xhat, _ = _ln_rows(x, torch.ones(dm), torch.zeros(dm), EPS)
    for got, want in ((sums[:dm], (dy * xhat).sum(0)),
                      (sums[dm:2 * dm], dy.sum(0)),
                      (sums[2 * dm:3 * dm], do.sum(0))):
        assert rel_fro(got.numpy(), want.numpy()) <= 1e-5
    assert not sums[3 * dm:].any()
    # each CTA's do plane is the column sum of its own rows
    for c in (0, 150, ctas - 1):
        want = do[c * per:(c + 1) * per].sum(0)
        assert rel_fro(parts[c, 2 * dm:3 * dm].numpy(), want.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# the partitions at the card's shapes and the wrappers' partial buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,split", [
    ("train", (32, 8, 394)), ("ragged", (4, 4, 148)), ("h80", (7, 5, 294)),
    ("vit_h", (31, 3, 266))])
def test_ln_bwd_split_fills_the_card_twice(shape, split):
    """Twice 132 CTAs wherever the rows allow 4 a CTA (591 rows: 148 CTAs,
    so that the in-order sum of their partials stays short)."""
    rows, dm = SHAPES[shape]
    per, warps, ctas = tatt._ln_bwd_split(rows, dm)
    assert (per, warps, ctas) == split
    assert (ctas - 1) * per < rows <= ctas * per
    assert ctas >= 2 * SMS if rows >= 4 * 2 * SMS else per == 4
    assert 4 <= per <= 32 and warps <= min(per, 8)
    chunks = -(-dm // 256)
    assert warps * 3 * chunks * 256 * 4 + 8 * warps <= 48 * 1024 + 64


@pytest.mark.parametrize("rows,cols,split", [
    (64 * 197, 3 * 384, (232, 55)), (64 * 197, 384, (88, 144)),
    (3 * 197, 3 * 384, (8, 74)), (8 * 257, 3 * 640, (56, 37)),
    (32 * 257, 3 * 1280, (464, 18)), (13, 16, (8, 2))])
def test_colsum_split_covers_the_card(rows, cols, split):
    per, parts = tatt._colsum_split(rows, cols)
    assert (per, parts) == split
    assert per % 8 == 0 and (parts - 1) * per < rows <= parts * per
    if rows >= 8 * 2 * SMS:
        assert parts * -(-cols // 256) >= 2 * SMS - 8


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_wrappers_allocate_every_partial(shape):
    rows, dm = SHAPES[shape]
    f = 4 * dm
    ctas = tatt._ln_bwd_split(rows, dm)[2]
    scratch, (s2, s1) = tmlp._mlp_bwd_scratch(rows, dm, f, "meta", SMS)
    assert list(scratch) == ["m_in", "am", "dh", "dmi", "part", "sums"]
    assert scratch["dmi"].dtype == torch.float32
    tm, tn = -(-rows // 128), -(-f // 128)
    assert scratch["part"].numel() == max(
        2 * tm * f, s2 * f * dm, s1 * dm * f, (ctas + 1) * (3 * dm + 2))
    assert scratch["sums"].numel() == 3 * dm + 2 + tm * tn
    assert (s2, s1) == (tatt._weight_grad_splits(f, dm, rows, SMS),
                        tatt._weight_grad_splits(dm, f, rows, SMS))
    b, n = (rows // 257, 257) if rows % 197 else (rows // 197, 197)
    heads = dm // 64
    scratch, _ = tatt._sublayer_bwd_scratch(b, n, dm, dm, heads, "meta",
                                            SMS, ln=True)
    assert scratch["part"].numel() >= (ctas + 1) * (3 * dm + 2)
    scratch, _ = tatt._sublayer_bwd_scratch(b, n, dm, dm, heads, "meta",
                                            SMS, ln=False)
    assert scratch["part"].numel() >= max(
        tatt._colsum_split(rows, 3 * dm)[1] * 3 * dm,
        tatt._colsum_split(rows, dm)[1] * dm)


# ---------------------------------------------------------------------------
# the route at ViT-H/14's width
# ---------------------------------------------------------------------------


def _route_args(dm, f=16):
    g = torch.Generator().manual_seed(46)

    def rn(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g)).requires_grad_()

    x = rn(1, 3, dm)
    return x, dict(xin=rn(1, 3, dm), d=torch.tensor([0.4, 0.6]),
                   g=1 + 0.1 * rn(dm), b=rn(dm, std=0.1),
                   wqkv=rn(dm, 48, std=dm ** -0.5), bqkv=rn(48),
                   wproj=rn(16, dm, std=0.25), bproj=rn(dm),
                   amask=torch.ones(16), w1=rn(dm, f, std=dm ** -0.5),
                   b1=rn(f), w2=rn(f, dm, std=0.25), b2=rn(dm),
                   fmask=torch.ones(f))


@pytest.mark.parametrize("dm", [get_config("ViT-H_14").embed_dim,
                                tatt._MAX_DM_BWD + 8])
def test_vit_h_width_takes_the_kernels_and_wider_the_composed_route(dm):
    """ViT-H/14's student block (dm 1280) goes through A2 and A4 (their
    plain versions on the CPU, no composed call); past the LayerNorm
    backward's width each Function takes its composed route once."""
    assert get_config("ViT-H_14").embed_dim == tatt._MAX_DM_BWD == 1280
    x, t = _route_args(dm)
    tops.reset_launch_counts()
    z = tatt.fused_layer_attention_ln(
        x, t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"],
        t["amask"], num_heads=1, scale=0.25, eps=EPS)
    margs = (t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"], t["fmask"])
    y = tmlp.fused_mlp_ln_blend(z, t["xin"], t["d"], *margs, eps=EPS)
    y = tmlp.fused_mlp_ln(y, *margs, eps=EPS)
    y.square().sum().backward()
    wide = int(dm > tatt._MAX_DM_BWD)
    assert tops.composed_counts() == {
        "layer_attention_ln_bwd_composed": wide,
        "mlp_ln_bwd_composed": wide, "mlp_ln_blend_bwd_composed": wide}
    assert all(n == 0 for n in tops.backward_launch_counts().values())
    assert torch.isfinite(x.grad).all()
