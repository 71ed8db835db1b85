"""The port's backward sublayer ops (uvc_tpu_torch/ops) against the JAX
package, on the CPU.

The same numpy inputs and output cotangent go through ``jax.vjp`` of the
JAX function and the port's plain backward:

* bf16 against the Pallas kernels in interpret mode
  (``fused_layer_attention_ln`` / ``fused_mlp_ln`` / ``fused_mlp_ln_blend``
  with ``interpret=True``, whose custom VJPs run the backward kernels
  ``_layer_ln_bwd_kernel`` / ``_mlp_ln_bwd_kernel`` /
  ``_mlp_ln_blend_bwd_kernel``): both round at the same places and differ
  by the f32 summation order and by GELU (the Pallas body's
  Abramowitz-Stegun erf, |err| < 1.5e-7, against the exact erf), i.e. by
  one-ulp flips of single bf16 intermediates carried into the sums after
  them -> relative Frobenius <= 2e-2 per gradient;
* the MLP backwards also against the Pallas hidden-group split (the JAX
  VMEM budget forced to split F into parts): the port computes all hidden
  units in one pass, and must equal the parts' sum to the same 2e-2;
* f32 against the autodiff of the JAX CPU composition: the same
  arithmetic in another summation order -> relative Frobenius <= 2e-4.

The autograd wrappers give ``torch.autograd``'s gradients through the
plain forwards, and on the CPU no kernel launches.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.ops import attention as jattn
from uvc_tpu.ops import mlp as jmlp
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops.attention import (fused_layer_attention_ln,
                                         layer_attention_bwd,
                                         layer_attention_ln_bwd,
                                         layer_attention_ln_bwd_plain,
                                         layer_attention_ln_plain)
from uvc_tpu_torch.ops.mlp import (fused_mlp_ln, fused_mlp_ln_blend,
                                   mlp_ln_blend_bwd, mlp_ln_blend_bwd_plain,
                                   mlp_ln_blend_plain, mlp_ln_bwd,
                                   mlp_ln_bwd_plain, mlp_ln_plain)

BF16_TOL = 2e-2
F32_TOL = 2e-4
EPS = 1e-6
LN_KEYS = ("g1", "b1", "g2", "b2", "d")

ATTN_ORDER = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "mask")
MLP_ORDER = ("x", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2", "mask")
BLEND_ORDER = ("x", "xin", "d", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2",
               "mask")


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def attention_inputs(seed, b, n, dm, da):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        g1=(1 + 0.1 * rng.standard_normal(dm)).astype(f32),
        b1=(0.1 * rng.standard_normal(dm)).astype(f32),
        wqkv=(rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask,
        do=(0.5 * rng.standard_normal((b, n, dm))).astype(f32))


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


# (batch, tokens, model width, attention width, heads): N not a multiple
# of 16, attention widths below the model width (compacted layers)
ATTN_CASES = [(2, 13, 16, 16, 2), (2, 21, 16, 8, 1), (1, 40, 32, 16, 2)]


def _attention_kw(da, heads):
    return dict(num_heads=heads, scale=(da // heads) ** -0.5, eps=EPS)


@pytest.mark.parametrize("b,n,dm,da,heads", ATTN_CASES)
def test_attention_bwd_plain_matches_pallas_bf16(b, n, dm, da, heads):
    inp = attention_inputs(10, b, n, dm, da)
    kw = _attention_kw(da, heads)
    ref = jax_vjp(lambda *a: jattn.fused_layer_attention_ln(
        *a, interpret=True, **kw), as_jax(inp, ATTN_ORDER, jnp.bfloat16),
        jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    t = as_torch(inp, ATTN_ORDER + ("do",), torch.bfloat16)
    got = layer_attention_ln_bwd_plain(*t, **kw)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_grads_close(got, ref, ATTN_ORDER, BF16_TOL)


@pytest.mark.parametrize("b,n,dm,da,heads", ATTN_CASES)
def test_attention_bwd_plain_matches_composition_f32(b, n, dm, da, heads):
    inp = attention_inputs(11, b, n, dm, da)
    kw = _attention_kw(da, heads)
    ref = jax_vjp(lambda *a: jattn.layer_attention_ln(*a, **kw),
                  as_jax(inp, ATTN_ORDER, jnp.float32),
                  jnp.asarray(inp["do"]))
    got = layer_attention_ln_bwd(*as_torch(inp, ATTN_ORDER + ("do",),
                                           torch.float32), **kw)
    assert_grads_close(got, ref, ATTN_ORDER, F32_TOL)


def _mlp_jax(blend, fused):
    if blend:
        fn = jmlp.fused_mlp_ln_blend if fused else jmlp._composed_mlp_ln_blend
    else:
        fn = jmlp.fused_mlp_ln if fused else jmlp._composed_mlp_ln
    if fused:
        return lambda *a: fn(*a, eps=EPS, interpret=True)
    return lambda *a: fn(*a, EPS)


# (batch, tokens, model width, hidden width)
MLP_CASES = [(2, 13, 16, 64), (1, 37, 32, 128)]
BLENDS = [(0.3, 0.7), (0.0, 1.0), (1.0, 0.0)]


@pytest.mark.parametrize("b,n,dm,f", MLP_CASES)
def test_mlp_bwd_plain_matches_pallas_bf16(b, n, dm, f):
    inp = mlp_inputs(12, b, n, dm, f)
    ref = jax_vjp(_mlp_jax(False, True), as_jax(inp, MLP_ORDER, jnp.bfloat16),
                  jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    t = as_torch(inp, MLP_ORDER + ("do",), torch.bfloat16)
    got = mlp_ln_bwd_plain(*t, eps=EPS)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_grads_close(got, ref, MLP_ORDER, BF16_TOL)


@pytest.mark.parametrize("d", BLENDS)
def test_mlp_blend_bwd_plain_matches_pallas_bf16(d):
    inp = mlp_inputs(13, 2, 13, 16, 64, d)
    ref = jax_vjp(_mlp_jax(True, True),
                  as_jax(inp, BLEND_ORDER, jnp.bfloat16),
                  jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    t = as_torch(inp, BLEND_ORDER + ("do",), torch.bfloat16)
    got = mlp_ln_blend_bwd_plain(*t, eps=EPS)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    # a hard distribution zeroes whole gradients (d = (0, 1): dxin; d =
    # (1, 0): every sublayer gradient); both sides must give exact zeros
    for name, g, r in zip(BLEND_ORDER, got, ref):
        if not np.any(np.asarray(jnp.asarray(r).astype(jnp.float32))):
            assert not torch.any(g), name
    nonzero = [i for i, r in enumerate(ref)
               if np.any(np.asarray(jnp.asarray(r).astype(jnp.float32)))]
    assert_grads_close([got[i] for i in nonzero], [ref[i] for i in nonzero],
                       [BLEND_ORDER[i] for i in nonzero], BF16_TOL)


# the JAX backward splits F into parts of 128 units when its VMEM budget
# refuses the whole width; forcing the budget reproduces the split at a
# small size (F = 256 -> 2 parts, F = 512 -> 4)
@pytest.mark.parametrize("f,parts", [(256, 2), (512, 4)])
def test_mlp_bwd_plain_matches_pallas_hidden_split(monkeypatch, f, parts):
    widths = []

    def budget(b, dm, ff, np_):
        widths.append(ff)
        return None if ff > f // parts else 1

    monkeypatch.setattr(jmlp, "_mlp_bwd_group", budget)
    inp = mlp_inputs(14, 2, 13, 16, f)
    ref = jax_vjp(_mlp_jax(False, True), as_jax(inp, MLP_ORDER, jnp.bfloat16),
                  jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    assert widths[0] == f and widths[-1] == f // parts
    got = mlp_ln_bwd_plain(*as_torch(inp, MLP_ORDER + ("do",),
                                     torch.bfloat16), eps=EPS)
    assert_grads_close(got, ref, MLP_ORDER, BF16_TOL)


@pytest.mark.parametrize("f,parts", [(256, 2), (512, 4)])
def test_mlp_blend_bwd_plain_matches_pallas_hidden_split(monkeypatch, f,
                                                         parts):
    widths = []

    def budget(b, dm, ff, np_, full):
        widths.append(ff)
        return None if ff > f // parts else 1

    monkeypatch.setattr(jmlp, "_mlp_blend_bwd_group", budget)
    inp = mlp_inputs(15, 2, 13, 16, f)
    ref = jax_vjp(_mlp_jax(True, True),
                  as_jax(inp, BLEND_ORDER, jnp.bfloat16),
                  jnp.asarray(inp["do"]).astype(jnp.bfloat16))
    assert widths[0] == f and widths[-1] == f // parts
    got = mlp_ln_blend_bwd_plain(*as_torch(inp, BLEND_ORDER + ("do",),
                                           torch.bfloat16), eps=EPS)
    assert_grads_close(got, ref, BLEND_ORDER, BF16_TOL)


@pytest.mark.parametrize("b,n,dm,f", MLP_CASES)
def test_mlp_bwd_plain_matches_composition_f32(b, n, dm, f):
    inp = mlp_inputs(16, b, n, dm, f)
    ref = jax_vjp(_mlp_jax(False, False),
                  as_jax(inp, MLP_ORDER, jnp.float32), jnp.asarray(inp["do"]))
    got = mlp_ln_bwd(*as_torch(inp, MLP_ORDER + ("do",), torch.float32),
                     eps=EPS)
    assert_grads_close(got, ref, MLP_ORDER, F32_TOL)


@pytest.mark.parametrize("d", [(0.3, 0.7), (0.6, 0.4)])
def test_mlp_blend_bwd_plain_matches_composition_f32(d):
    inp = mlp_inputs(17, 1, 37, 32, 128, d)
    ref = jax_vjp(_mlp_jax(True, False),
                  as_jax(inp, BLEND_ORDER, jnp.float32),
                  jnp.asarray(inp["do"]))
    got = mlp_ln_blend_bwd(*as_torch(inp, BLEND_ORDER + ("do",),
                                     torch.float32), eps=EPS)
    assert_grads_close(got, ref, BLEND_ORDER, F32_TOL)


def _autograd(fn, args, do):
    leaves = [a.clone().requires_grad_() for a in args]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_wrappers_match_autograd_of_plain_forwards(dtype):
    """The Functions' backwards (plain on the CPU) against torch.autograd
    through the plain forwards: the same f32 math (exact within 2e-4 in
    f32; in bf16 the hand-written backward rounds where the Pallas body
    does, autograd where the forward's casts sit, hence 2e-2)."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    inp = attention_inputs(18, 2, 13, 16, 16)
    args = as_torch(inp, ATTN_ORDER, dtype)
    do = torch.from_numpy(inp["do"]).to(dtype)
    kw = _attention_kw(16, 2)
    got = _autograd(lambda *a: fused_layer_attention_ln(*a, **kw), args, do)
    ref = _autograd(lambda *a: layer_attention_ln_plain(*a, **kw), args, do)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and rel_fro(g.float(), r.float()) <= tol

    inp = mlp_inputs(19, 2, 13, 16, 64)
    do = torch.from_numpy(inp["do"]).to(dtype)
    for fn, plain, order in (
            (fused_mlp_ln, mlp_ln_plain, MLP_ORDER),
            (fused_mlp_ln_blend, mlp_ln_blend_plain, BLEND_ORDER)):
        args = as_torch(inp, order, dtype)
        got = _autograd(lambda *a: fn(*a, eps=EPS), args, do)
        ref = _autograd(lambda *a: plain(*a, eps=EPS), args, do)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            assert rel_fro(g.float(), r.float()) <= tol


def test_autograd_wrappers_skip_the_graph_under_no_grad():
    inp = mlp_inputs(20, 1, 5, 16, 64)
    args = [a.requires_grad_() for a in as_torch(inp, MLP_ORDER,
                                                  torch.float32)]
    with torch.no_grad():
        out = fused_mlp_ln(*args, eps=EPS)
    assert out.grad_fn is None
    assert fused_mlp_ln(*args, eps=EPS).grad_fn is not None


def test_cpu_backward_calls_leave_launch_counters_at_zero():
    tops.reset_launch_counts()
    a = attention_inputs(21, 2, 13, 16, 16)
    layer_attention_ln_bwd(*as_torch(a, ATTN_ORDER + ("do",),
                                     torch.bfloat16), **_attention_kw(16, 2))
    layer_attention_bwd(*as_torch(a, ("x", "wqkv", "bqkv", "wproj", "bproj",
                                      "mask", "do"), torch.bfloat16),
                        num_heads=2, scale=0.25)
    m = mlp_inputs(22, 2, 13, 16, 64)
    mlp_ln_bwd(*as_torch(m, MLP_ORDER + ("do",), torch.bfloat16), eps=EPS)
    mlp_ln_blend_bwd(*as_torch(m, BLEND_ORDER + ("do",), torch.bfloat16),
                     eps=EPS)
    assert tops.backward_launch_counts() == {
        "layer_attention_ln_bwd": 0, "mlp_ln_bwd": 0, "mlp_ln_blend_bwd": 0,
        "layer_attention_bwd": 0, "performer_bwd": 0, "attention_bwd": 0,
        "attention_bwd_ctx": 0}
    assert tops.launch_counts() == {"layer_attention_ln": 0, "mlp_ln": 0,
                                    "mlp_ln_blend": 0, "layer_attention": 0,
                                    "performer": 0, "attention": 0}
    assert _cuda._loaded == {}


def test_backward_wrappers_refuse_other_devices():
    x = torch.empty(2, 13, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        layer_attention_ln_bwd(x, x[0, 0], x[0, 0], w[:, :48], w[0, :48],
                               w[:, :16], x[0, 0], x[0, 0], x, num_heads=2,
                               scale=0.35, eps=EPS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_ln_bwd(x, x[0, 0], x[0, 0], w, w[0], w.T, x[0, 0], w[0], x,
                   eps=EPS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_ln_blend_bwd(x, x, x[0, 0, :2], x[0, 0], x[0, 0], w, w[0], w.T,
                         x[0, 0], w[0], x, eps=EPS)


def test_backward_checks_refuse_what_the_kernels_cannot_take():
    """The LayerNorm backward holds at most 1280 columns of a row: a wider
    operand is refused before any launch.  The attention backward streams
    its core, so its shared memory does not grow with N: N = 705, past the
    704 that its old staged core held at head dim 64, is taken (meta
    tensors carry the shapes without data)."""
    from uvc_tpu_torch.ops.attention import _MAX_DM_BWD, _check_attention
    from uvc_tpu_torch.ops.mlp import _check_mlp

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32 = torch.float32

    def attention_named(n, dm):
        x = meta(1, n, dm)
        return x, dict(x=x, g1=meta(dm, dtype=f32), b1=meta(dm, dtype=f32),
                       wqkv=meta(dm, 192), bqkv=meta(192), wproj=meta(64, dm),
                       bproj=meta(dm), mask=meta(64), do=x)

    x, named = attention_named(13, _MAX_DM_BWD + 8)
    with pytest.raises(ValueError, match="unsupported x shape"):
        _check_attention(x, named, 1, max_dm=_MAX_DM_BWD)
    for n in (704, 705):
        x, named = attention_named(n, 64)
        assert _check_attention(x, named, 1,
                                max_dm=_MAX_DM_BWD) == (1, n, 64, 64)
    dm = _MAX_DM_BWD + 8
    x = meta(1, 13, dm)
    named = dict(g2=meta(dm, dtype=f32), b2=meta(dm, dtype=f32),
                 wfc1=meta(dm, 64), bfc1=meta(64), wfc2=meta(64, dm),
                 bfc2=meta(dm), mask=meta(64), do=x)
    with pytest.raises(ValueError, match="unsupported widths"):
        _check_mlp(x, None, None, named, max_dm=_MAX_DM_BWD)
    named.pop("do")
    assert _check_mlp(x, None, None, named) == (1, 13, dm, 64)


def test_backward_entry_points_are_bound():
    assert {"uvc_layer_attention_ln_bwd"} <= set(_cuda._LIBS["attention"][1])
    assert {"uvc_mlp_ln_bwd", "uvc_mlp_ln_blend_bwd"} <= set(
        _cuda._LIBS["mlp"][1])
