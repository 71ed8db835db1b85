"""The port's token-performer stage (uvc_tpu_torch/ops/performer.py: the
plain versions of kernels A10 / A11) against the JAX package, on the CPU.

Three feature layouts of the stage input: dense, the space-to-depth
stage-1 layout of ``s2d_stage1_inputs`` (dead slots, masked LN1), and the
``_klast_perm`` permutation of stages 2 and 3.

Tolerances:

* against the Pallas kernels in interpret mode (``fused_performer(...,
  interpret=True)``, both the merged and the split form, and ``jax.grad``
  through them): in bf16 both round at the same places and differ by the
  f32 summation order, i.e. by one-ulp flips of single bf16 intermediates
  carried into the sums after them -> relative Frobenius <= 2e-2 per
  output; in f32 they differ by summation order and the Pallas bodies'
  Abramowitz-Stegun erf (|err| < 1.5e-7) -> 1e-5;
* in f32 against the JAX CPU composition (``apply_performer`` on the
  nn.Unfold layout) and ``jax.grad`` of it, at N not a multiple of 8 (the
  Pallas path does not take it): the same arithmetic in another order ->
  1e-5.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvc_tpu.models.t2t_vit import (_klast_perm, _unfold, _unfold_klast,
                                    apply_performer, init_performer)
from uvc_tpu.ops import performer as jperf
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.interop import params_from_numpy
from uvc_tpu_torch.ops import _cuda
from uvc_tpu_torch.ops import performer as tperf
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

BF16_TOL = 2e-2
F32_TOL = 1e-5
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def layout(name, seed=0):
    """(performer params, stage input, feat_idx, the nn.Unfold-layout input
    or None) of one layout, small."""
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    if name == "dense":
        p = init_performer(k1, 24, 16)
        x = jax.random.normal(k2, (2, 48, 24)) * 0.5
        return p, x, None, None
    if name == "s2d":
        p = init_performer(k1, 3 * 49, 16)
        img = jax.random.normal(k2, (2, 16, 16, 3)) * 0.5
        xs, idx = jperf.s2d_stage1_inputs(img)
        return p, xs, idx, _unfold(img, 7, 4, 2)
    p = init_performer(k1, 8 * 9, 16)
    img = jax.random.normal(k2, (2, 8, 8, 8)) * 0.5
    return p, _unfold_klast(img, 3, 2, 1), _klast_perm(3, 8), \
        _unfold(img, 3, 2, 1)


def torch_params(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def t_(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


LAYOUTS = ("dense", "s2d", "klast")


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", LAYOUTS)
def test_forward_plain_matches_pallas(name, dt, merged):
    jdt, tdt = DTYPES[dt]
    p, x, idx, _ = layout(name)
    ref = jperf.fused_performer(p, x, dtype=jdt, interpret=True,
                                feat_idx=idx, merged=merged)
    out = tperf.fused_performer(torch_params(p), t_(x), dtype=tdt,
                                feat_idx=idx)
    assert out.dtype == tdt and out.shape == ref.shape
    assert rel_fro(np_(out), np_(ref)) <= (F32_TOL if dt == "f32"
                                           else BF16_TOL)


def _grads_close(tp, tx, gp, gx, tol):
    assert rel_fro(np_(tx.grad), np_(gx)) <= tol, "dx"
    jg = {jax.tree_util.keystr(path): v for path, v in
          jax.tree_util.tree_leaves_with_path(gp)}
    for path, leaf in tree_leaves_with_path(tp):
        ref = np_(jg["".join(f"['{k}']" for k in path)])
        got = np.zeros_like(ref) if leaf.grad is None else np_(leaf.grad)
        if path[-1] == "prm_w":
            # frozen random features: no gradient in either package
            assert not np.any(ref) and not np.any(got)
            continue
        assert rel_fro(got, ref) <= tol, path


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", LAYOUTS)
def test_backward_plain_matches_pallas(name, dt, merged):
    """Every gradient (x and each parameter leaf, through the feat_idx
    gather) against jax.grad through the Pallas custom VJP."""
    jdt, tdt = DTYPES[dt]
    p, x, idx, _ = layout(name, seed=1)
    w = np.random.default_rng(1).standard_normal(
        (x.shape[0], x.shape[1], 16)).astype(np.float32)

    def jloss(p, x):
        out = jperf.fused_performer(p, x, dtype=jdt, interpret=True,
                                    feat_idx=idx, merged=merged)
        return jnp.sum(out.astype(jnp.float32) * w)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = torch_params(p)
    for _, leaf in tree_leaves_with_path(tp):
        leaf.requires_grad_()
    tx = t_(x).requires_grad_()
    out = tperf.fused_performer(tp, tx, dtype=tdt, feat_idx=idx)
    (out.float() * torch.from_numpy(w)).sum().backward()
    _grads_close(tp, tx, gp, gx, F32_TOL if dt == "f32" else BF16_TOL)


@pytest.mark.parametrize("n", [50, 13])
def test_dense_stage_matches_composition_f32(n):
    """A token count that is not a multiple of 8, against the composed
    stage and its autodiff."""
    key = jax.random.PRNGKey(n)
    p = init_performer(key, 64, 64)
    x = jax.random.normal(jax.random.fold_in(key, 1), (3, n, 64)) * 0.5
    w = np.random.default_rng(n).standard_normal((3, n, 64)).astype(
        np.float32)
    assert jperf.fused_performer(p, x, dtype=jnp.float32,
                                 interpret=True) is None

    def jloss(p, x):
        return jnp.sum(apply_performer(p, x, dtype=jnp.float32) * w)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = torch_params(p)
    for _, leaf in tree_leaves_with_path(tp):
        leaf.requires_grad_()
    tx = t_(x).requires_grad_()
    out = tperf.fused_performer(tp, tx, dtype=torch.float32)
    ref = apply_performer(p, x, dtype=jnp.float32)
    assert rel_fro(np_(out), np_(ref)) <= F32_TOL
    (out * torch.from_numpy(w)).sum().backward()
    _grads_close(tp, tx, gp, gx, F32_TOL)


@pytest.mark.parametrize("name", ["s2d", "klast"])
def test_expanded_layouts_match_the_unfold_route_f32(name):
    """The expanded layout with gathered weights equals nn.Unfold order and
    the composed stage (the JAX CPU route), forward and gradients."""
    p, x, idx, x_unfold = layout(name, seed=2)
    w = np.random.default_rng(2).standard_normal(
        (x.shape[0], x.shape[1], 16)).astype(np.float32)
    gp = jax.grad(lambda p: jnp.sum(apply_performer(
        p, x_unfold, dtype=jnp.float32) * w))(p)
    tp = torch_params(p)
    for _, leaf in tree_leaves_with_path(tp):
        leaf.requires_grad_()
    tx = t_(x).requires_grad_()
    out = tperf.fused_performer(tp, tx, dtype=torch.float32, feat_idx=idx)
    ref = apply_performer(p, x_unfold, dtype=jnp.float32)
    assert rel_fro(np_(out), np_(ref)) <= F32_TOL
    (out * torch.from_numpy(w)).sum().backward()
    jg = {jax.tree_util.keystr(path): v for path, v in
          jax.tree_util.tree_leaves_with_path(gp)}
    for path, leaf in tree_leaves_with_path(tp):
        if path[-1] != "prm_w":
            ref = np_(jg["".join(f"['{k}']" for k in path)])
            assert rel_fro(np_(leaf.grad), ref) <= F32_TOL, path


def test_s2d_stage1_inputs_matches_jax():
    img = np.random.default_rng(3).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    jx, jidx = jperf.s2d_stage1_inputs(jnp.asarray(img))
    tx, tidx = tperf.s2d_stage1_inputs(torch.from_numpy(img))
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(np_(tx), np_(jx))
    assert int((tidx >= 0).sum()) == 147
    assert tperf.s2d_stage1_inputs(torch.zeros(1, 10, 10, 3)) == (None, None)


def test_plain_kernels_match_the_autograd_wrapper():
    """``performer_bwd`` is the VJP of ``performer``: the wrapper's
    gradients equal autograd through the plain forward, in f32."""
    p, x, idx, _ = layout("s2d", seed=4)
    tp = torch_params(p)
    f32 = torch.float32
    valid = idx >= 0
    safe = torch.as_tensor(np.where(valid, idx, 0))
    fmask = torch.as_tensor(valid, dtype=f32)
    ops = [t_(x), tp["norm1"]["scale"][safe] * fmask,
           tp["norm1"]["bias"][safe] * fmask,
           tp["kqv"]["kernel"][safe] * fmask[:, None], tp["kqv"]["bias"],
           tp["prm_w"], fmask, tp["proj"]["kernel"], tp["proj"]["bias"],
           tp["norm2"]["scale"], tp["norm2"]["bias"],
           tp["mlp_fc1"]["kernel"], tp["mlp_fc1"]["bias"],
           tp["mlp_fc2"]["kernel"], tp["mlp_fc2"]["bias"]]
    fc = float(valid.sum())
    do = torch.randn(2, x.shape[1], 16, generator=torch.Generator()
                     .manual_seed(0))
    out, kptv, kpsum = tperf.performer(*ops, fcount=fc)
    grads = tperf.performer_bwd(*ops, kptv, kpsum, do, fcount=fc)
    leaves = [t.detach().requires_grad_() for t in ops]
    ref = torch.autograd.grad(
        tperf.performer_plain(*leaves, fcount=fc)[0], leaves, do,
        allow_unused=True)
    names = [n for n in tperf.OPERANDS if n not in ("w", "fmask")]
    assert tperf.GRADS == tuple("d" + n for n in names)
    for name, g in zip(names, grads):
        i = tperf.OPERANDS.index(name)
        assert g.dtype == ops[i].dtype
        assert rel_fro(np_(g), np_(ref[i])) <= F32_TOL, name
    assert ref[tperf.OPERANDS.index("fmask")] is not None   # no kernel grad


def test_cpu_calls_leave_the_counters_at_zero_and_build_nothing():
    tops.reset_launch_counts()
    p, x, idx, _ = layout("s2d")
    tx = t_(x).requires_grad_()
    tperf.fused_performer(torch_params(p), tx, dtype=torch.bfloat16,
                          feat_idx=idx).float().sum().backward()
    assert tops.launch_counts()["performer"] == 0
    assert tops.backward_launch_counts()["performer_bwd"] == 0
    assert "performer" not in _cuda._loaded


def test_wrappers_refuse_other_devices():
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32 = torch.float32
    ops = [meta(2, 5, 64), meta(64, dtype=f32), meta(64, dtype=f32),
           meta(64, 192), meta(192), meta(32, 64, dtype=f32),
           meta(64, dtype=f32), meta(64, 64), meta(64), meta(64, dtype=f32),
           meta(64, dtype=f32), meta(64, 64), meta(64), meta(64, 64),
           meta(64)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tperf.performer(*ops, fcount=64.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tperf.performer_bwd(*ops, meta(2, 64, 32, dtype=f32),
                            meta(2, 1, 32, dtype=f32), meta(2, 5, 64),
                            fcount=64.0)


def test_kernel_checks_refuse_what_the_kernels_cannot_take():
    """emb 64, m 32, dim a multiple of 8 up to 1024: anything else is
    refused before a launch (meta tensors carry the shapes)."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32 = torch.float32

    def named(dim, emb=64, m=32):
        return dict(g1=meta(dim, dtype=f32), b1=meta(dim, dtype=f32),
                    wkqv=meta(dim, 3 * emb), bkqv=meta(3 * emb),
                    w=meta(m, emb, dtype=f32), fmask=meta(dim, dtype=f32),
                    wproj=meta(emb, emb), bproj=meta(emb),
                    g2=meta(emb, dtype=f32), b2=meta(emb, dtype=f32),
                    wfc1=meta(emb, emb), bfc1=meta(emb), wfc2=meta(emb, emb),
                    bfc2=meta(emb))

    assert tperf._check_performer(meta(2, 5, 192), named(192)) == (2, 5, 192)
    with pytest.raises(ValueError, match="token dim 64"):
        tperf._check_performer(meta(2, 5, 48), named(48, emb=16, m=8))
    for dim in (147, 1032):
        with pytest.raises(ValueError, match="unsupported x shape"):
            tperf._check_performer(meta(2, 5, dim), named(dim))
    bad = dict(named(64), wkqv=meta(64, 192, dtype=f32))
    with pytest.raises(ValueError, match="wkqv must be"):
        tperf._check_performer(meta(2, 5, 64), bad)


def test_fused_performer_off_the_cpu_never_runs_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel route, which refuses what is not a CUDA tensor."""
    p, _, _, _ = layout("dense")
    tp = jax.tree.map(lambda t: t.to("meta"), torch_params(p))
    x = torch.empty(2, 48, 24, device="meta")
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            with pytest.raises(ValueError, match="cpu or cuda"):
                tperf.fused_performer(tp, x, dtype=torch.bfloat16)


def test_entry_points_are_bound():
    assert {"uvc_performer", "uvc_performer_bwd"} == set(
        _cuda._LIBS["performer"][1])
