"""The port's branch-scaled block (uvc_tpu_torch) against the JAX package,
on the CPU: the bare attention sublayer (kernel A7), the model with part
gating and drop-path, and the part-gated stage-1 step.

Tolerances:

* the plain A7 forward and backward in bf16 against the Pallas kernels in
  interpret mode (``fused_layer_attention(..., interpret=True)`` and
  ``jax.vjp`` of it): both round at the same places (qkv, probabilities,
  ctx, dctx, ds, dqkv in bf16) and differ by the f32 summation order, i.e.
  by one-ulp flips of single bf16 intermediates carried into the sums
  after them -> relative Frobenius <= 2e-2 per output;
* in f32 against the same Pallas kernels, which still round qkv, the
  probabilities and dqkv to bf16 where the plain f32 version does not ->
  the same 2e-2;
* in f32 against the JAX CPU composition (``layer_attention``) and
  ``jax.vjp`` of it: the same arithmetic in another summation order ->
  relative Frobenius <= 2e-4;
* the whole model in f32 against ``vit.apply``: logits within 1e-5
  (relative and absolute), parameter gradients within 1e-4 relative
  Frobenius per leaf; in bf16 (the compute dtype of a run) only loosely,
  5e-2 on the logits, since the bare sublayer's JAX CPU reference is the
  composition, whose bf16 roundings XLA places elsewhere;
* the 3-step part-gated stage-1 trajectory as the stage-1 trajectory of
  ``test_torch_port_train.py``: 1e-5 on the metrics and the minimax
  state, 1e-4 relative Frobenius per weight leaf, the key bias to the
  learning rate times the steps.

Random numbers cross over as values: drop-path's keep decisions are drawn
along the JAX forward's key chain (``fold_in(rng, 7)`` -> ``split(., L)``
-> ``fold_in(., branch)`` -> ``bernoulli(keep, (B, 1, 1))``) and handed to
the port as ``drop_path``; the stage-1 step's part-gating noise comes from
its ``k_part1`` / ``k_part2`` keys.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import minimax as jminimax
from uvc_tpu.compress import resource as jresource
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.models import vit as jvit
from uvc_tpu.ops import attention as jattn
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_stage1_step as j_build_stage1_step
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch import ops as tops
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.interop import cstate_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.ops.attention import (fused_layer_attention,
                                         layer_attention,
                                         layer_attention_bwd,
                                         layer_attention_bwd_plain,
                                         layer_attention_plain)
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import Stage1Noise, build_stage1_step
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

BF16_TOL = 2e-2
F32_TOL = 2e-4
MODEL_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_MODEL_TOL = 5e-2
ORDER = ("x", "wqkv", "bqkv", "wproj", "bproj", "mask")

JCFG = jconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)
TCFG = tconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)


def rel_fro(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# kernel A7: the plain versions against the Pallas kernels and the
# composition
# ---------------------------------------------------------------------------


def sublayer_inputs(seed, b, n, dm, da):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random(da) > 0.3).astype(f32)
    mask[0] = 0.0
    return dict(
        x=rng.standard_normal((b, n, dm)).astype(f32),
        wqkv=(rng.standard_normal((dm, 3 * da)) / np.sqrt(dm)).astype(f32),
        bqkv=(0.1 * rng.standard_normal(3 * da)).astype(f32),
        wproj=(rng.standard_normal((da, dm)) / np.sqrt(da)).astype(f32),
        bproj=(0.1 * rng.standard_normal(dm)).astype(f32),
        mask=mask,
        do=(0.5 * rng.standard_normal((b, n, dm))).astype(f32))


def as_jax(inp, dtype, order=ORDER):
    return [jnp.asarray(inp[k]).astype(dtype) for k in order]


def as_torch(inp, dtype, order=ORDER):
    return [torch.from_numpy(inp[k]).to(dtype) for k in order]


# (batch, tokens, model width, attention width, heads): N not a multiple
# of 16, attention widths below the model width (compacted layers)
CASES = [(2, 13, 16, 16, 2), (2, 21, 16, 8, 1), (1, 40, 32, 16, 2)]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _kw(da, heads):
    return dict(num_heads=heads, scale=(da // heads) ** -0.5)


def assert_close(got, ref, names, tol):
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        r = np_(r)
        assert tuple(g.shape) == r.shape, name
        err = rel_fro(np_(g), r)
        assert err <= tol, f"{name}: relative Frobenius {err:.2e} > {tol}"


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,n,dm,da,heads", CASES)
def test_sublayer_fwd_plain_matches_pallas(dt, b, n, dm, da, heads):
    jdt, tdt = DTYPES[dt]
    inp = sublayer_inputs(30, b, n, dm, da)
    kw = _kw(da, heads)
    ref = jattn.fused_layer_attention(*as_jax(inp, jdt), interpret=True,
                                      **kw)
    got = layer_attention_plain(*as_torch(inp, tdt), **kw)
    assert got.dtype == tdt
    assert_close([got], [ref], ["out"], BF16_TOL)


@pytest.mark.parametrize("b,n,dm,da,heads", CASES)
def test_sublayer_fwd_matches_composition_f32(b, n, dm, da, heads):
    inp = sublayer_inputs(31, b, n, dm, da)
    kw = _kw(da, heads)
    ref = jattn.layer_attention(*as_jax(inp, jnp.float32), **kw)
    got = layer_attention(*as_torch(inp, torch.float32), **kw)
    assert_close([got], [ref], ["out"], F32_TOL)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,n,dm,da,heads", CASES)
def test_sublayer_bwd_plain_matches_pallas(dt, b, n, dm, da, heads):
    """Every output of ``_layer_bwd_kernel`` (through ``_fused_layer_bwd``,
    its whole-sublayer branch): dx, dWqkv, dbqkv, dWproj, dbproj, dmask,
    each in its input's dtype."""
    jdt, tdt = DTYPES[dt]
    inp = sublayer_inputs(32, b, n, dm, da)
    kw = _kw(da, heads)
    _, vjp = jax.vjp(lambda *a: jattn.fused_layer_attention(
        *a, interpret=True, **kw), *as_jax(inp, jdt))
    ref = vjp(jnp.asarray(inp["do"]).astype(jdt))
    t = as_torch(inp, tdt, ORDER + ("do",))
    got = layer_attention_bwd_plain(*t, **kw)
    assert [g.dtype for g in got] == [a.dtype for a in t[:-1]]
    assert_close(got, ref, ORDER, BF16_TOL)


@pytest.mark.parametrize("b,n,dm,da,heads", CASES)
def test_sublayer_bwd_matches_composition_f32(b, n, dm, da, heads):
    inp = sublayer_inputs(33, b, n, dm, da)
    kw = _kw(da, heads)
    _, vjp = jax.vjp(lambda *a: jattn.layer_attention(*a, **kw),
                     *as_jax(inp, jnp.float32))
    ref = vjp(jnp.asarray(inp["do"]))
    got = layer_attention_bwd(*as_torch(inp, torch.float32,
                                        ORDER + ("do",)), **kw)
    assert_close(got, ref, ORDER, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_wrapper_matches_autograd_of_plain_forward(dtype):
    """The Function's backward (plain on the CPU) against torch.autograd
    through the plain forward: the same math (2e-4 in f32; in bf16 the
    hand-written backward rounds where the Pallas body does, autograd
    where the forward's casts sit, hence 2e-2)."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    inp = sublayer_inputs(34, 2, 13, 16, 16)
    kw = _kw(16, 2)
    do = torch.from_numpy(inp["do"]).to(dtype)

    def grads(fn):
        leaves = [a.requires_grad_() for a in as_torch(inp, dtype)]
        return torch.autograd.grad(fn(*leaves, **kw), leaves, do)

    got = grads(fused_layer_attention)
    ref = grads(layer_attention_plain)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and rel_fro(np_(g), np_(r)) <= tol


def test_autograd_wrapper_skips_the_graph_under_no_grad():
    inp = sublayer_inputs(35, 1, 5, 16, 16)
    args = [a.requires_grad_() for a in as_torch(inp, torch.float32)]
    with torch.no_grad():
        assert fused_layer_attention(*args, **_kw(16, 2)).grad_fn is None
    assert fused_layer_attention(*args, **_kw(16, 2)).grad_fn is not None


def test_sublayer_wrappers_refuse_other_devices():
    x = torch.empty(2, 13, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, 48, dtype=torch.bfloat16, device="meta")
    args = (x, w, w[0], w[:, :16], x[0, 0], x[0, 0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        layer_attention(*args, num_heads=2, scale=0.35)
    with pytest.raises(ValueError, match="cpu or cuda"):
        layer_attention_bwd(*args, x, num_heads=2, scale=0.35)
    assert tops.launch_counts()["layer_attention"] == 0


# ---------------------------------------------------------------------------
# the model: part gating, drop-path, block gating with the separate blend
# ---------------------------------------------------------------------------


def jax_params(seed, cfg=JCFG):
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_drop_path_keep(rng, depth, rate, batch):
    """``[L, 2, B]`` keep decisions along the JAX forward's key chain."""
    keys = jax.random.split(jax.random.fold_in(rng, 7), depth)
    rates = jnp.linspace(0.0, rate, depth)
    keep = np.zeros((depth, 2, batch), bool)
    for i in range(depth):
        p = 1.0 - rates[i].astype(jnp.float32)
        for j in range(2):
            keep[i, j] = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(keys[i], j), p, (batch, 1, 1)))[:, 0, 0]
    return keep


DISTRIBS = {"attn": np.array([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5]],
                             np.float32),
            "mlp": np.array([[0.6, 0.4], [0.1, 0.9], [0.0, 1.0]], np.float32),
            "gate": np.array([[0.25, 0.75], [0.9, 0.1], [0.4, 0.6]],
                             np.float32)}
MODEL_CASES = {
    # part gating on both sublayers, ungated blocks
    "part": dict(attn=True, mlp=True),
    # attention part gating only: the MLP keeps its fused kernel
    "part_attn": dict(attn=True),
    # drop-path on every block (layer 0 at rate 0)
    "drop_path": dict(drop_path=0.5),
    # block gating + part gating: the separate blend after the block
    "gated_part": dict(attn=True, mlp=True, gate=True),
    # block gating + drop-path, structural masks
    "gated_drop_path": dict(gate=True, drop_path=0.5, masks=True),
}


def _model_args(case, batch, seed=40):
    kw = MODEL_CASES[case]
    x = np.random.default_rng(seed).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)
    jargs, targs = {}, {}
    for name, arg in (("attn", "attn_distrib"), ("mlp", "mlp_distrib"),
                      ("gate", "gating_distrib")):
        if kw.get(name):
            jargs[arg] = jnp.asarray(DISTRIBS[name])
            targs[arg] = t_(DISTRIBS[name])
    if kw.get("masks"):
        rng = np.random.default_rng(seed)
        masks = {"attn": (rng.random((3, 8)) > 0.3).astype(np.float32),
                 "mlp": (rng.random((3, 16)) > 0.3).astype(np.float32)}
        jargs["masks"] = {k: jnp.asarray(v) for k, v in masks.items()}
        targs["masks"] = {k: t_(v) for k, v in masks.items()}
    if kw.get("drop_path"):
        key = jax.random.PRNGKey(seed)
        jargs.update(train=True, drop_path_rate=kw["drop_path"], rng=key)
        keep = jax_drop_path_keep(key, 3, kw["drop_path"], batch)
        assert not keep.all()           # the draw drops some branches
        targs.update(train=True, drop_path_rate=kw["drop_path"],
                     drop_path=torch.from_numpy(keep))
    return x, jargs, targs


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_apply_matches_f32(case):
    params = jax_params(1)
    x, jargs, targs = _model_args(case, 4)
    ref = jvit.apply(params, jnp.asarray(x), JCFG, **jargs)
    tp = params_from_numpy(np_tree(params), device="cpu")
    tops.reset_launch_counts()
    out = tvit.apply(tp, t_(x), TCFG, **targs)
    np.testing.assert_allclose(np_(out.logits), np_(ref.logits),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    assert all(v == 0 for v in tops.launch_counts().values())


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_apply_param_grads_match_f32(case):
    """Gradients of a loss of the logits with respect to every parameter
    leaf, against jax.grad of the same loss."""
    params = jax_params(2)
    x, jargs, targs = _model_args(case, 3, seed=41)
    w = np.random.default_rng(3).standard_normal((3, 10)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jvit.apply(p, jnp.asarray(x), JCFG, **jargs).logits
                       * w)

    jg = np_tree(jax.grad(jloss)(params))
    tp = params_from_numpy(np_tree(params), device="cpu")
    leaves = [(path, leaf.requires_grad_())
              for path, leaf in tree_leaves_with_path(tp)]
    loss = (tvit.apply(tp, t_(x), TCFG, **targs).logits * t_(w)).sum()
    grads = torch.autograd.grad(loss, [v for _, v in leaves],
                                allow_unused=True)
    for (path, leaf), g in zip(leaves, grads):
        ref = jg
        for k in path:
            ref = ref[k]
        got = np.zeros_like(ref) if g is None else np_(g)
        if np.any(ref):
            err = rel_fro(got, ref)
            assert err <= GRAD_TOL, f"{path}: {err:.2e}"
        else:
            np.testing.assert_allclose(got, ref, atol=1e-7)


def test_apply_matches_bf16_loosely():
    params = jax_params(4)
    x, jargs, targs = _model_args("gated_part", 2, seed=42)
    ref = jvit.apply(params, jnp.asarray(x), JCFG, dtype=jnp.bfloat16,
                     **jargs)
    out = tvit.apply(params_from_numpy(np_tree(params), device="cpu"),
                     t_(x), TCFG, dtype=torch.bfloat16, **targs)
    assert rel_fro(np_(out.logits), np_(ref.logits)) <= BF16_MODEL_TOL


def test_sample_drop_path_rates():
    """Layer 0 (rate 0) always keeps; the last layer keeps at 1 - rate."""
    keep = tvit.sample_drop_path(torch.Generator().manual_seed(0), 4, 0.4,
                                 20000)
    assert keep.shape == (4, 2, 20000) and keep.dtype == torch.bool
    assert keep[0].all()
    frac = keep.float().mean(dim=(1, 2)).numpy()
    np.testing.assert_allclose(frac, [1.0, 0.8667, 0.7333, 0.6], atol=0.015)


# ---------------------------------------------------------------------------
# the part-gated stage-1 step against build_stage1_step
# ---------------------------------------------------------------------------

HP_FIELDS = dict(
    budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
    zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5, gating_weight=0.5,
    gating_interval=2, soptim="sgd", roptim="sgd", flops_with_mhsa=True,
    use_gumbel=True, eps=0.05, enable_block_gating=True,
    enable_part_gating=True, enable_patch_gating=0, enable_pruning=True)
THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, num_classes=10)


def _jax_stage1_noise(key, batch):
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)

    def g(k, shape):
        return t_(jax.random.gumbel(k, shape, jnp.float32))

    l2 = (JCFG.depth, 2)
    return Stage1Noise(mixup=None, gate=g(k_gate, l2),
                       token=g(k_tok, (batch, JCFG.num_patches)),
                       res1=g(k_res1, l2), res2=g(k_res2, l2),
                       part_attn=g(k_part1, l2), part_mlp=g(k_part2, l2))


def _compare(tst, jst, lr):
    for f in ("s", "r", "y", "p", "z", "gating_accum"):
        np.testing.assert_allclose(np_(getattr(tst.cstate, f)),
                                   np_(getattr(jst.cstate, f)), rtol=1e-5,
                                   atol=1e-5)
    jleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_leaves_with_path(jst.params)}
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(tst.params):
        ref = np.asarray(jleaves["".join(f"['{k}']" for k in path)])
        leaf = np_(leaf)
        if path == ("blocks", "qkv", "bias"):
            # the key bias has a zero gradient up to rounding, which AdamW
            # divides by its own magnitude (see test_torch_port_train.py)
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=lr * max(1, tst.step), rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if np.any(ref):
            assert rel_fro(leaf, ref) <= GRAD_TOL, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=GRAD_TOL)


@pytest.mark.parametrize("warmup", [False, True])
def test_part_gated_stage1_trajectory_matches_jax(warmup):
    """3 part-gated stage-1 steps with JAX's draws, the part-gating noise
    included: metrics, minimax state and every weight leaf after each
    step.  The part-gating logits train in both phases; the warmup leaves
    only block_gating alone."""
    jhp, thp_ = JHParams(**HP_FIELDS), THParams(**HP_FIELDS)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP_FIELDS)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP_FIELDS)
    params, teacher = jax_params(5), jax_params(105)
    params["attn_gating"] = jnp.array([[-0.2, 0.4], [0.1, 0.3], [0.5, -0.1]])
    params["mlp_gating"] = jnp.array([[0.3, 0.2], [-0.4, 0.6], [0.2, 0.2]])
    cstate = jminimax.init_compression_state(JCFG, jhp)
    jst = jstate.create_train_state(params, jthp, cstate)
    tst = tstate.create_train_state(
        params_from_numpy(np_tree(params), device="cpu"), tthp,
        cstate_from_numpy(np_tree(cstate), device="cpu"))
    tteacher = params_from_numpy(np_tree(teacher), device="cpu")
    table_j = jresource.build_macs_table(JCFG)
    jstep = j_build_stage1_step(JCFG, table_j, jhp, jthp, warmup=warmup,
                                donate=False)
    tstep = build_stage1_step(TCFG, tresource.build_macs_table(TCFG), thp_,
                              tthp, warmup=warmup)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    start = tst.params
    for i in range(3):
        key = jax.random.PRNGKey(50 + i)
        jst, jm = jstep(jst, teacher, jnp.asarray(x), jnp.asarray(labels),
                        key, jnp.float32(5.0))
        tst, tm = tstep(tst, tteacher, t_(x), torch.from_numpy(labels).long(),
                        _jax_stage1_noise(key, 4), 5.0)
        for k in ("loss", "grad_norm", "lr", "resource"):
            np.testing.assert_allclose(np_(tm[k]), np_(jm[k]), rtol=1e-5,
                                       atol=1e-5)
        _compare(tst, jst, THP_FIELDS["learning_rate"])
    for name in ("attn_gating", "mlp_gating"):
        assert not torch.equal(tst.params[name], start[name]), name
    assert torch.equal(tst.params["block_gating"],
                       start["block_gating"]) == warmup

