"""The port's kernel A8 (uvc_tpu_torch/ops/attention.py: the attention core
backward with the context, ``attention_bwd_ctx``) and the wide-model
backward route around it (``layer_attention_ln_bwd_composed``,
``mlp_ln_bwd_composed``, ``mlp_ln_blend_bwd_composed``) against the JAX
package on the CPU.

* ``attention_bwd_ctx_plain`` in bf16 against ``_call_bwd_ctx(...,
  interpret=True)`` on rows padded to 16 with ``n_valid`` (as the JAX
  sublayer pads them): both round at the same places and differ in f32
  summation order, which now and then flips a bf16 rounding -> 1e-2
  relative Frobenius per output.  In f32 against ``reference_attention``
  and its ``jax.vjp``: the same function, 1e-5 relative Frobenius.
* The LN-fused sublayer, the MLP and the MLP-blend sublayers at ViT-H/14's
  width (dm 1280, 16 heads of 80, F 5120; B = 2, N = 17): the port's
  gradients against ``jax.vjp`` of the Pallas forwards in interpret mode,
  whose custom VJPs take the composed route at this width (the test
  checks that they do: ``_call_bwd_ctx`` runs, the MLP backward kernels do
  not), in bf16 -> 1e-2; and against ``jax.vjp`` of the CPU composition in
  f32 -> 1e-5.  One exception in bf16: the blend's gating gradient ``dd``
  is a sum over all B N dm products, which XLA on the CPU accumulates in
  bf16 (5% off at this size; a TPU and PyTorch accumulate bf16 sums in
  f32), so ``dd`` is held to the f32 autodiff of the same composition at
  the same bf16 values instead, at the same 1e-2.
* The route: the autograd Functions take the composed backward exactly
  when dm > 1280 (past the LayerNorm backward's width; ViT-H/14's 1280
  takes the fused backwards), read from the counters.  The composed
  routes stay held at dm 1280 above by direct calls.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import attention as jattn
from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import attention as tatt
from uvc_tpu_torch.ops import mlp as tmlp

BF16_TOL = 1e-2
F32_TOL = 1e-5
EPS = 1e-6
# (B, H, N, dh): the resnext head dim 12, 64, ViT-H's 80, a ragged N
SHAPES = {"dh12": (2, 3, 13, 12), "dh64": (1, 2, 32, 64),
          "dh80": (2, 2, 17, 80), "ragged": (1, 1, 50, 24)}
# ViT-H/14's widths at a CPU batch
WIDE = dict(b=2, n=17, dm=1280, heads=16, f=5120)

ATTN_ORDER = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "mask")
MLP_ORDER = ("x", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2", "mask")
BLEND_ORDER = ("x", "xin", "d", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2",
               "mask")
F32_KEYS = ("g1", "b1", "g2", "b2", "d")


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def core_inputs(shape, seed, dtype):
    """q, k, v, do as torch tensors in ``dtype`` and the same values as
    JAX arrays."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dtype) for _ in range(4)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]


def assert_close(got, ref, names, tol):
    for name, g, r in zip(names, got, ref):
        assert tuple(g.shape) == tuple(np.shape(r)), name
        err = rel_fro(np_(g), np_(r))
        assert err <= tol, f"{name}: relative Frobenius {err:.2e} > {tol}"


# ---------------------------------------------------------------------------
# kernel A8's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_ctx_plain_matches_pallas_bf16(shape):
    b, h, n, dh = SHAPES[shape]
    (q, k, v, do), jin = core_inputs((b, h, n, dh), 1, torch.bfloat16)
    scale = dh ** -0.5
    np_rows = -(-n // 16) * 16
    pad = ((0, 0), (0, 0), (0, np_rows - n), (0, 0))
    ref = jattn._call_bwd_ctx(*(jnp.pad(t, pad) for t in jin), scale, n,
                              interpret=True)
    got = tatt.attention_bwd_ctx_plain(q, k, v, do, scale)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert_close(got, [r[:, :, :n] for r in ref], ("ctx", "dq", "dk", "dv"),
                 BF16_TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_ctx_plain_matches_reference_attention_f32(shape):
    b, h, n, dh = SHAPES[shape]
    (q, k, v, do), (jq, jk, jv, jdo) = core_inputs((b, h, n, dh), 2,
                                                   torch.float32)
    scale = dh ** -0.5
    ctx, vjp = jax.vjp(lambda *a: jattn.reference_attention(*a, scale),
                       jq, jk, jv)
    got = tatt.attention_bwd_ctx_plain(q, k, v, do, scale)
    assert_close(got, (ctx, *vjp(jdo)), ("ctx", "dq", "dk", "dv"), F32_TOL)
    # A9's plain backward is A8's without ctx, bit for bit
    for a, b_ in zip(tatt.attention_bwd_plain(q, k, v, do, scale), got[1:]):
        assert torch.equal(a, b_)


def tiled_bwd_ctx(q, k, v, do, scale, tile=64):
    """The card kernels' order of the core backward
    (csrc/attention_core_bwd.cuh) in PyTorch: base-2 logits (q . k^T) *
    (scale * log2 e) in f32, (max, s) in one online pass over 64-key
    tiles, the running sum rescaled by 2^(old max - new max); probs =
    2^(logit - max) * (1 / s); then, tile by tile, row = sum(dp * probs)
    and ctx = round(probs) . v, ds = round(probs * (dp - row)) and
    dq = ds . k; dk and dv over 64-query tiles.  Returns (ctx, dq, dk, dv)
    in the input's dtype."""
    dt = q.dtype
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    n = q.shape[2]
    tiles = [slice(j, min(j + tile, n)) for j in range(0, n, tile)]
    logits = (q32 @ k32.transpose(-1, -2)) * (scale * math.log2(math.e))
    m = torch.full((*q.shape[:3], 1), -torch.inf)
    s = torch.zeros_like(m)
    for j in tiles:
        new = torch.maximum(m, logits[..., j].amax(-1, keepdim=True))
        s = s * torch.exp2(m - new) + torch.exp2(logits[..., j] - new).sum(
            -1, keepdim=True)
        m = new
    probs = torch.exp2(logits - m) * (1.0 / s)
    pb = probs.to(dt).float()
    dp = do32 @ v32.transpose(-1, -2)
    row, ctx = torch.zeros_like(m), torch.zeros_like(q32)
    for j in tiles:
        row = row + (dp[..., j] * probs[..., j]).sum(-1, keepdim=True)
        ctx = ctx + pb[..., j] @ v32[..., j, :]
    ds = (probs * (dp - row)).to(dt).float()
    dq = torch.zeros_like(q32)
    dk, dv = torch.zeros_like(q32), torch.zeros_like(q32)
    for j in tiles:
        dq = dq + ds[..., j] @ k32[..., j, :]
        dk = dk + ds[..., j, :].transpose(-1, -2) @ q32[..., j, :]
        dv = dv + pb[..., j, :].transpose(-1, -2) @ do32[..., j, :]
    return tuple(t.to(dt) for t in (ctx, dq * scale, dk * scale, dv))


# (B, H, N, dh): three key tiles with a 2-row tail at an odd head dim,
# ViT-H's N and head dim, one tile
TILED = {"ragged_odd": (2, 2, 130, 41), "vit_h": (1, 2, 257, 80),
         "one_tile": (1, 1, 50, 24)}


def tiled_inputs(shape, seed, dtype):
    """core_inputs with key norms growing along N (up to 3x), so that later
    key tiles raise the running max and the online rescale is taken."""
    (q, k, v, do), _ = core_inputs(shape, seed, torch.float32)
    k = k * torch.linspace(1.0, 3.0, shape[2])[:, None]
    ts = [t.to(dtype) for t in (q, k, v, do)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]


@pytest.mark.parametrize("shape", sorted(TILED))
def test_tiled_order_matches_plain_and_pallas_bf16(shape):
    """The kernels' order, in bf16, against the plain version and the
    Pallas kernel in interpret mode, within the card's tolerance."""
    b, h, n, dh = TILED[shape]
    (q, k, v, do), jin = tiled_inputs((b, h, n, dh), 5, torch.bfloat16)
    scale = dh ** -0.5
    got = tiled_bwd_ctx(q, k, v, do, scale)
    assert all(g.dtype == torch.bfloat16 for g in got)
    names = ("ctx", "dq", "dk", "dv")
    assert_close(got, tatt.attention_bwd_ctx_plain(q, k, v, do, scale),
                 names, BF16_TOL)
    np_rows = -(-n // 16) * 16
    pad = ((0, 0), (0, 0), (0, np_rows - n), (0, 0))
    ref = jattn._call_bwd_ctx(*(jnp.pad(t, pad) for t in jin), scale, n,
                              interpret=True)
    assert_close(got, [r[:, :, :n] for r in ref], names, BF16_TOL)


@pytest.mark.parametrize("shape", sorted(TILED))
def test_tiled_order_is_the_plain_function_f32(shape):
    """In f32 every rounding is the identity: the online (max, s) and the
    tile-by-tile sums are the plain version's function, 1e-5."""
    b, h, n, dh = TILED[shape]
    (q, k, v, do), _ = tiled_inputs((b, h, n, dh), 6, torch.float32)
    scale = dh ** -0.5
    assert_close(tiled_bwd_ctx(q, k, v, do, scale),
                 tatt.attention_bwd_ctx_plain(q, k, v, do, scale),
                 ("ctx", "dq", "dk", "dv"), F32_TOL)


def test_bwd_ctx_wrapper_routes_cpu_to_plain_and_writes_given_layouts():
    """On the CPU the wrapper is the plain version (no launch, no library
    loaded); the composed route's call writes ctx and dq, dk, dv into head
    views of its [B, N, da] and [B, N, 3 da] rows."""
    tops.reset_launch_counts()
    (q, k, v, do), _ = core_inputs((2, 2, 9, 16), 3, torch.bfloat16)
    got = tatt.attention_bwd_ctx(q, k, v, do, 0.25)
    ref = tatt.attention_bwd_ctx_plain(q, k, v, do, 0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    ctx = torch.zeros(2, 9, 32, dtype=torch.bfloat16)
    dqkv = torch.zeros(2, 9, 96, dtype=torch.bfloat16)
    outs = (*tatt._rows_as_heads(ctx, 1, 2), *tatt._rows_as_heads(dqkv, 3, 2))
    tatt._attention_bwd_ctx_into(q, k, v, do, 0.25, outs)
    assert torch.equal(ctx.view(2, 9, 2, 16).transpose(1, 2), ref[0])
    for i in range(3):
        assert torch.equal(dqkv.view(2, 9, 3, 2, 16)[:, :, i].transpose(1, 2),
                           ref[1 + i])
    assert tops.backward_launch_counts()["attention_bwd_ctx"] == 0
    assert "attention_core" not in _cuda._loaded


def test_bwd_ctx_wrapper_refuses_other_devices_and_is_bound():
    q = torch.empty(1, 2, 9, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tatt.attention_bwd_ctx(q, q, q, q, 0.25)
    assert "uvc_attention_bwd_ctx" in _cuda._LIBS["attention_core"][1]
    assert tops.BACKWARD_KERNEL_WRAPPERS["attention_bwd_ctx"] is \
        tatt.attention_bwd_ctx


def test_bwd_ctx_checks_take_the_backward_limits():
    """A8 takes A9's backward operands: head dims up to 80 and, the
    backward streaming 64-row tiles through a two-stage ring, any N: its
    shared memory per CTA is at most 64536 bytes at dh 80 whatever N is
    (three CTAs fit an SM).  The sublayer backwards run the same streamed
    core and take N = 800 at head dim 80 too, past the 624 keys that the
    staged forward core once held; so does A7's forward, now on the
    streamed forward core.  A9's forward streams its tiles too and takes
    N = 800 as well."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    names = ("q", "k", "v", "do", "ctx", "dq", "dk", "dv")
    named = {k: meta(32, 16, 257, 80) for k in names}
    assert tatt._check_core(named, backward=True) == (32, 16, 257, 80)
    assert tatt._core_bwd_smem_bytes(80) == 64536
    assert 3 * tatt._core_bwd_smem_bytes(80) <= tatt._SMEM_LIMIT
    named = {k: meta(1, 1, 800, 80) for k in names}
    assert tatt._check_core(named, backward=True) == (1, 1, 800, 80)
    x = meta(1, 800, 160)
    sub = dict(x=x, wqkv=meta(160, 480), bqkv=meta(480), wproj=meta(160, 160),
               bproj=meta(160), mask=meta(160), do=x)
    assert tatt._check_attention(x, sub, 2) == (1, 800, 160, 160)
    sub.pop("do")
    assert tatt._check_attention(x, sub, 2) == (1, 800, 160, 160)
    assert tatt._check_core({k: named[k] for k in ("q", "k", "v")},
                            backward=False) == (1, 1, 800, 80)


# ---------------------------------------------------------------------------
# the sublayers at ViT-H/14's width
# ---------------------------------------------------------------------------


def wide_inputs(seed, order):
    """The sublayers' operands at ViT-H/14's widths (numpy f32)."""
    rng = np.random.default_rng(seed)
    b, n, dm, f = WIDE["b"], WIDE["n"], WIDE["dm"], WIDE["f"]
    f32 = np.float32

    def rn(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(f32)

    def keep(k):
        m = (rng.random(k) > 0.3).astype(f32)
        m[0] = 0.0
        return m

    inp = dict(x=rn(b, n, dm), xin=rn(b, n, dm), d=np.asarray([0.3, 0.7], f32),
               g1=1 + rn(dm, std=0.1), b1=rn(dm, std=0.1),
               g2=1 + rn(dm, std=0.1), b2=rn(dm, std=0.1),
               wqkv=rn(dm, 3 * dm, std=dm ** -0.5), bqkv=rn(3 * dm, std=0.1),
               wproj=rn(dm, dm, std=dm ** -0.5), bproj=rn(dm, std=0.1),
               wfc1=rn(dm, f, std=dm ** -0.5), bfc1=rn(f, std=0.1),
               wfc2=rn(f, dm, std=f ** -0.5), bfc2=rn(dm, std=0.1),
               do=rn(b, n, dm, std=0.5))
    inp["mask"] = keep(dm if "wqkv" in order else f)
    return inp


def as_jax(inp, order, dtype):
    return [jnp.asarray(inp[k]).astype(jnp.float32 if k in F32_KEYS
                                       else dtype) for k in order]


def as_torch(inp, order, dtype):
    return [torch.from_numpy(inp[k]).to(torch.float32 if k in F32_KEYS
                                        else dtype) for k in order]


def jax_vjp(fn, args, do):
    _, vjp = jax.vjp(fn, *args)
    return vjp(do)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


ATTN_KW = dict(num_heads=WIDE["heads"], scale=80 ** -0.5, eps=EPS)


def _sublayer(kind):
    """(order, JAX Pallas forward, JAX CPU composition, the port's
    composed backward) of one sublayer."""
    if kind == "attention":
        return (ATTN_ORDER,
                lambda *a: jattn.fused_layer_attention_ln(
                    *a, interpret=True, **ATTN_KW),
                lambda *a: jattn.layer_attention_ln(*a, **ATTN_KW),
                lambda *a: tatt.layer_attention_ln_bwd_composed(*a,
                                                               **ATTN_KW))
    if kind == "mlp":
        return (MLP_ORDER,
                lambda *a: jmlp.fused_mlp_ln(*a, eps=EPS, interpret=True),
                lambda *a: jmlp._composed_mlp_ln(*a, EPS),
                lambda *a: tmlp.mlp_ln_bwd_composed(*a, eps=EPS))
    return (BLEND_ORDER,
            lambda *a: jmlp.fused_mlp_ln_blend(*a, eps=EPS, interpret=True),
            lambda *a: jmlp._composed_mlp_ln_blend(*a, EPS),
            lambda *a: tmlp.mlp_ln_blend_bwd_composed(*a, eps=EPS))


@pytest.mark.parametrize("kind", ["attention", "mlp", "blend"])
def test_wide_sublayer_grads_match_pallas_composed_route_bf16(monkeypatch,
                                                              kind):
    order, jfused, jcomposed, composed = _sublayer(kind)
    # at ViT-H/14's stage-1 shape (B = 32, N = 257, padded to 272 rows) the
    # MLP backwards' VMEM budget refuses the whole width and every hidden
    # split; at this CPU size the 8-way split would fit, so the budget is
    # set as it is at the real size
    b, rows, dm, f = 32, 272, WIDE["dm"], WIDE["f"]
    for ng in (1, 2, 4, 8):
        assert jmlp._mlp_bwd_group(b, dm, f // ng, rows) is None
        assert jmlp._mlp_blend_bwd_group(b, dm, f // ng, rows,
                                         full=True) is None
    monkeypatch.setattr(jmlp, "_mlp_bwd_group", lambda *a, **k: None)
    monkeypatch.setattr(jmlp, "_mlp_blend_bwd_group", lambda *a, **k: None)
    calls = []
    _spy(monkeypatch, jattn, "_call_bwd_ctx", calls)
    for name in ("_call_layer_ln_bwd", "_call_layer_bwd", "_call_mlp_bwd",
                 "_call_mlp_blend_bwd"):
        _spy(monkeypatch, jattn if "layer" in name else jmlp, name, calls)
    inp = wide_inputs(4, order)
    args = as_jax(inp, order, jnp.bfloat16)
    do = jnp.asarray(inp["do"]).astype(jnp.bfloat16)
    ref = list(jax_vjp(jfused, args, do))
    # the reference took its composed route: A8 for the attention, plain
    # autodiff for the MLPs, no fused backward kernel
    assert calls == (["_call_bwd_ctx"] if kind == "attention" else [])
    if "d" in order:
        i = order.index("d")
        ref[i] = jax_vjp(jcomposed, [a.astype(jnp.float32) for a in args],
                         do.astype(jnp.float32))[i]
    t = as_torch(inp, order + ("do",), torch.bfloat16)
    got = composed(*t)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_close(got, ref, order, BF16_TOL)


@pytest.mark.parametrize("kind", ["attention", "mlp", "blend"])
def test_wide_sublayer_grads_match_composition_f32(kind):
    order, _, jcomposed, composed = _sublayer(kind)
    inp = wide_inputs(5, order)
    ref = jax_vjp(jcomposed, as_jax(inp, order, jnp.float32),
                  jnp.asarray(inp["do"]))
    got = composed(*as_torch(inp, order + ("do",), torch.float32))
    assert_close(got, ref, order, F32_TOL)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def _route_inputs(dm, f, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape))
                                .astype(np.float32))

    return dict(x=rn(1, 5, dm), xin=rn(1, 5, dm), d=torch.tensor([0.4, 0.6]),
                g=1 + rn(dm, std=0.1), b=rn(dm, std=0.1),
                wqkv=rn(dm, 3 * 64, std=dm ** -0.5), bqkv=rn(3 * 64),
                wproj=rn(64, dm, std=0.125), bproj=rn(dm),
                amask=torch.ones(64), w1=rn(dm, f, std=dm ** -0.5),
                b1=rn(f), w2=rn(f, dm, std=f ** -0.5), b2=rn(dm),
                fmask=torch.ones(f))


@pytest.mark.parametrize("dm", [tatt._MAX_DM_BWD, tatt._MAX_DM_BWD + 8])
def test_autograd_functions_take_the_composed_route_exactly_when_wide(dm):
    """The three autograd Functions route their backward by the model
    width alone, before anything runs: the fused backward's plain version
    at dm <= 1280, the composed route (one call each) above; on the CPU no
    kernel launches either way.  Both routes give the same f32
    gradients."""
    t = _route_inputs(dm, 64, 6)
    wide = dm > tatt._MAX_DM_BWD
    leaves = {k: v.requires_grad_() for k, v in t.items()
              if k not in ("amask", "fmask", "d")}
    tops.reset_launch_counts()
    z = tatt.fused_layer_attention_ln(
        leaves["x"], leaves["g"], leaves["b"], leaves["wqkv"],
        leaves["bqkv"], leaves["wproj"], leaves["bproj"], t["amask"],
        num_heads=1, scale=0.125, eps=EPS)
    margs = (leaves["g"], leaves["b"], leaves["w1"], leaves["b1"],
             leaves["w2"], leaves["b2"], t["fmask"])
    y = tmlp.fused_mlp_ln_blend(z, leaves["xin"], t["d"], *margs, eps=EPS)
    y = tmlp.fused_mlp_ln(y, *margs, eps=EPS)
    grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
    assert tops.composed_counts() == {
        "layer_attention_ln_bwd_composed": int(wide),
        "mlp_ln_bwd_composed": int(wide),
        "mlp_ln_blend_bwd_composed": int(wide)}
    assert all(n == 0 for n in tops.backward_launch_counts().values())

    # the two routes give the same f32 gradients
    with torch.no_grad():
        a = tatt.layer_attention_ln_plain(
            t["x"], t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
            t["bproj"], t["amask"], num_heads=1, scale=0.125, eps=EPS)
    do = torch.randn(a.shape, generator=torch.Generator().manual_seed(7))
    kw = dict(num_heads=1, scale=0.125, eps=EPS)
    args = (t["x"].detach(), t["g"].detach(), t["b"].detach(),
            t["wqkv"].detach(), t["bqkv"].detach(), t["wproj"].detach(),
            t["bproj"].detach(), t["amask"], do)
    fused = tatt.layer_attention_ln_bwd(*args, **kw)
    comp = tatt.layer_attention_ln_bwd_composed(*args, **kw)
    for a_, c_ in zip(fused, comp):
        assert rel_fro(np_(c_), np_(a_)) <= F32_TOL
    assert all(torch.isfinite(g).all() for g in grads)
