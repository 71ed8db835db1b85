"""The port's compact stage-2 fine-tuning (uvc_tpu_torch/train/
compact_ft.py) against the JAX package's and against the port's own dense
stage-2 step, on the CPU, in f32.

The configuration and its discovered architecture are
``tests/test_compact_ft.py``'s: the testing ViT with a token scorer and a
distillation head, one head of layer 0 pruned, within-head dims pruned in
layer 1, half the MLP units pruned everywhere, block 2 gated off.  Both
packages build their compact trees from the same dense numpy tree.

Tolerances: the compact trees are numpy-style gathers of the same values,
so they must be equal.  Forwards agree to 2e-4 (the f32 arithmetic in
another summation order, as in ``tests/test_compact_ft.py``).  One compact
step against the dense step on the kept coordinates: loss and grad_norm
1e-5, leaves 1e-4 relative (the masked coordinates' gradients are exact
zeros, so only the order of the sums differs).  The 3-step trajectory
against JAX: 1e-5 on the metrics, 1e-4 relative Frobenius per leaf
(``TRAJ_TOL``), the key bias to the learning rate times the steps (its
gradient is zero in exact arithmetic; see ``test_torch_port_train.py``).
The padding slots and the v-masked rows' moments are held to exact zero.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.models import t2t_vit as jt2t
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import compact_ft as jcft
from uvc_tpu.train import state as jstate
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.train import compact_ft as tcft
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import Stage2Noise, build_stage2_step
from uvc_tpu_torch.utils.tree import tree_leaves_with_path, tree_map

TOL = 1e-5
FWD_TOL = 2e-4
TRAJ_TOL = 1e-4
LR = 1e-2

JCFG = jconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
TCFG = tconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
T2T_CUT = dict(img_size=32, depth=2, num_classes=10)


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def jax_leaves(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(seed=0):
    """tests/test_compact_ft.py's ``_setup`` (random heads, the pruning and
    the gating), with the port's copies of the parameters and masks."""
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    params["head"]["kernel"] = jax.random.normal(
        jax.random.PRNGKey(5), params["head"]["kernel"].shape) * 0.1
    params["head_dist"]["kernel"] = jax.random.normal(
        jax.random.PRNGKey(6), params["head_dist"]["kernel"].shape) * 0.1
    s = jnp.array([[1.0, 32.0], [0.0, 32.0], [0.0, 32.0]])
    r = jnp.array([[0.0, 0.0], [2.0, 0.0], [0.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, JCFG)
    params["block_gating"] = jnp.array(
        [[-1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]])
    return (params, masks, params_from_numpy(np_tree(params), device="cpu"),
            masks_from_numpy(np_tree(masks), device="cpu"))


def _hard_gating(tparams):
    g = tparams["block_gating"]
    keep = (g[:, 1] > g[:, 0]).float()
    return torch.stack([1.0 - keep, keep], dim=-1)


def _fields(**kw):
    return dict(dict(num_classes=JCFG.num_classes, learning_rate=LR,
                     warmup_steps=1, t_total=10, mixup=0.0, cutmix=0.0,
                     smoothing=0.1), **kw)


def _thps(**kw):
    f = _fields(**kw)
    return (jstate.TrainHParams(compute_dtype=jnp.float32, **f),
            tstate.TrainHParams(compute_dtype=torch.float32, **f))


def _images(seed, b, size=32):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _jax_noise(key, jthp):
    if not (jthp.mixup > 0 or jthp.cutmix > 0):
        return Stage2Noise(mixup=None)
    k_mix, _ = jax.random.split(key)
    lam, blend, box = jmixup._sample_one(
        k_mix, 32, 32, jthp.mixup, jthp.cutmix, jthp.mixup_prob,
        jthp.mixup_switch_prob, jthp.cutmix_minmax)
    return Stage2Noise(mixup=MixupDraw(t_(lam), torch.tensor(bool(blend)),
                                       torch.from_numpy(np.array(box))))


def compare_trees(tree, jtree, *, exact=False, tol=TRAJ_TOL, key_bias=None):
    """Every leaf of the port's tree against the JAX tree's at the same
    path; ``key_bias``: the absolute bound of the qkv biases' middle
    thirds."""
    jl = jax_leaves(jtree)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    assert sorted(paths) == sorted(jl), (sorted(paths), sorted(jl))
    for path, leaf in tree_leaves_with_path(tree):
        ref, leaf = jl[path], np_(leaf)
        assert leaf.shape == ref.shape, path
        if exact:
            np.testing.assert_array_equal(leaf, ref, err_msg=str(path))
            continue
        if key_bias is not None and path[-2:] == ("qkv", "bias"):
            third = leaf.shape[-1] // 3
            mid = slice(third, 2 * third)
            np.testing.assert_allclose(leaf[..., mid], ref[..., mid],
                                       atol=key_bias, rtol=0)
            leaf, ref = (np.concatenate([a[..., :third], a[..., 2 * third:]],
                                        axis=-1) for a in (leaf, ref))
        if np.any(ref):
            assert rel_fro(leaf, ref) <= tol, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=tol, err_msg=str(path))


# ---------------------------------------------------------------------------
# the compact tree
# ---------------------------------------------------------------------------


def test_compact_train_tree_matches_jax_exactly():
    params, masks, tp, tm = _setup()
    jtree, jmeta = jcft.compact_train_tree(params, masks, JCFG)
    ttree, tmeta = tcft.compact_train_tree(tp, tm, TCFG)
    assert len(ttree["layers"]) == 2                  # block 2 dropped
    compare_trees(ttree, jtree, exact=True)
    for path, leaf in tree_leaves_with_path(ttree):
        assert leaf.dtype == torch.float32, path
    assert tmeta.block_keep == jmeta.block_keep == (True, True, False)
    assert tmeta.dims == jmeta.dims
    for tpl, jpl in zip(tmeta.plans, jmeta.plans):
        assert set(tpl) == set(jpl)
        for k in jpl:
            assert tuple(np.atleast_1d(tpl[k])) == tuple(
                np.atleast_1d(jpl[k])), k
    fks = [p["fk"] for p in tmeta.plans]
    # 32 of 64 units kept: padded toward 128, never beyond dense
    assert fks == [64, 64]
    assert tcft.compact_param_count(ttree) == jcft.compact_param_count(jtree)


def test_compact_train_tree_leaves_the_params_alone():
    """The compact tree shares no storage with the dense parameters."""
    _, _, tp, tm = _setup()
    ttree, _ = tcft.compact_train_tree(tp, tm, TCFG)
    dense = {leaf.untyped_storage().data_ptr()
             for _, leaf in tree_leaves_with_path(tp)}
    for path, leaf in tree_leaves_with_path(ttree):
        assert leaf.untyped_storage().data_ptr() not in dense, path


def test_compact_train_tree_raises_for_an_ablation():
    cfg = tconfigs.get_config("t2t_vit_14_se").replace(**T2T_CUT)
    with pytest.raises(NotImplementedError, match="ablations"):
        tcft.compact_train_tree({}, {}, cfg)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [None, 0.7], ids=["tokens_all",
                                                    "token_drop"])
def test_apply_compact_ft_matches_jax_and_masked_dense(ratio):
    params, masks, tp, tm = _setup()
    x = _images(7, 4)
    jtree, jmeta = jcft.compact_train_tree(params, masks, JCFG)
    ref = jax.jit(lambda tree, xb: jcft.apply_compact_ft(
        tree, jmeta, xb, JCFG, dtype=jnp.float32, token_ratio=ratio))(
        jtree, jnp.asarray(x))
    ttree, tmeta = tcft.compact_train_tree(tp, tm, TCFG)
    out = tcft.apply_compact_ft(ttree, tmeta, t_(x), TCFG,
                                dtype=torch.float32, token_ratio=ratio)
    dense = tvit.apply(tp, t_(x), TCFG, gating_distrib=_hard_gating(tp),
                       masks=tm, patch_gate_mode=0 if ratio is None else 2,
                       patch_ratio=0.7, patch_physical=True, train=True,
                       dtype=torch.float32)
    for got, want in ((out.logits, ref.logits), (out.logits_kd, ref.logits_kd),
                      (out.logits, dense.logits),
                      (out.logits_kd, dense.logits_kd)):
        np.testing.assert_allclose(np_(got), np_(want), rtol=FWD_TOL,
                                   atol=FWD_TOL)
    assert out.token_mask is None


# ---------------------------------------------------------------------------
# the compact step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [None, 0.7], ids=["tokens_all",
                                                    "token_drop"])
def test_compact_step_matches_the_dense_step_on_kept_coords(ratio):
    """One step: ``compact(dense_step(params))`` against
    ``compact_step(compact(params))``, both the port's."""
    _, _, tp, tm = _setup()
    hp = THParams(enable_patch_gating=0 if ratio is None else 2,
                  patch_ratio=0.7)
    _, thp = _thps()
    x = t_(_images(2, 8))
    y = torch.arange(8) % TCFG.num_classes
    teacher = params_from_numpy(np_tree(jvit.init_params(
        jax.random.PRNGKey(9), JCFG)), device="cpu")
    noise = Stage2Noise(mixup=None)

    state_d = tstate.create_train_state(tree_map(torch.clone, tp), thp)
    state_d, md = build_stage2_step(TCFG, hp, thp)(state_d, teacher, tm, x, y,
                                                  noise)
    ctree, meta = tcft.compact_train_tree(tp, tm, TCFG)
    state_c = tstate.create_train_state(ctree, thp)
    state_c, mc = tcft.build_compact_stage2_step(TCFG, hp, thp, meta)(
        state_c, teacher, tm, x, y, noise)

    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mc[k]), float(md[k]), rtol=TOL,
                                   err_msg=k)
    from_dense, _ = tcft.compact_train_tree(state_d.params, tm, TCFG)
    flat_d = dict(tree_leaves_with_path(from_dense))
    for path, leaf in tree_leaves_with_path(state_c.params):
        np.testing.assert_allclose(np_(leaf), np_(flat_d[path]), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_compact_trajectory_matches_jax_three_steps():
    """3 compact steps with the token drop and mixup / cutmix (JAX's draws
    fed in): the metrics after every step and every leaf of the compact
    tree."""
    params, masks, tp, tm = _setup()
    jthp, tthp = _thps(mixup=0.8, cutmix=1.0)
    jhp = JHParams(enable_patch_gating=2, patch_ratio=0.7)
    thp = THParams(enable_patch_gating=2, patch_ratio=0.7)
    jtree, jmeta = jcft.compact_train_tree(params, masks, JCFG)
    ttree, tmeta = tcft.compact_train_tree(tp, tm, TCFG)
    jst = jstate.create_train_state(jtree, jthp, None)
    tst = tstate.create_train_state(ttree, tthp)
    jstep = jcft.build_compact_stage2_step(JCFG, jhp, jthp, jmeta,
                                           donate=False)
    tstep = tcft.build_compact_stage2_step(TCFG, thp, tthp, tmeta)
    teacher = jvit.init_params(jax.random.PRNGKey(9), JCFG)
    tteacher = params_from_numpy(np_tree(teacher), device="cpu")
    x = _images(3, 4)
    y = (np.arange(4) % JCFG.num_classes).astype(np.int32)
    scorer = tree_map(torch.clone, tst.params["top"]["token_scorer"])
    for n in range(1, 4):
        key = jax.random.PRNGKey(20 + n)
        jst, jm = jstep(jst, teacher, masks, jnp.asarray(x), jnp.asarray(y),
                        key)
        tst, tm_ = tstep(tst, tteacher, tm, t_(x), torch.from_numpy(y).long(),
                         _jax_noise(key, jthp))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(np_(tm_[k]), np_(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
        compare_trees(tst.params, jst.params, key_bias=LR * n)
    for k in ("kernel", "bias"):
        assert torch.equal(tst.params["top"]["token_scorer"][k], scorer[k])


def test_compact_step_padding_and_vmask_stay_zero():
    """Two steps: the fc1 / fc2 padding slots stay exactly zero, with zero
    first moments, as do the v-masked proj rows' moments; those rows move
    by the decay alone."""
    _, _, tp, tm = _setup()
    _, thp = _thps()
    ctree, meta = tcft.compact_train_tree(tp, tm, TCFG)
    step = tcft.build_compact_stage2_step(TCFG, THParams(), thp, meta)
    state = tstate.create_train_state(ctree, thp)
    x = t_(_images(4, 8))
    y = torch.arange(8) % TCFG.num_classes
    for _ in range(2):
        state, _ = step(state, tp, tm, x, y, Stage2Noise(mixup=None))

    orig, _ = tcft.compact_train_tree(tp, tm, TCFG)
    saw_vmasked = saw_padding = False
    for idx, (blk, mu, plan) in enumerate(zip(
            state.params["layers"], state.opt_state.mu["layers"],
            meta.plans)):
        nk = len(plan["kept_units"])
        saw_padding |= nk < plan["fk"]
        for tree in (blk, mu):
            assert not torch.any(tree["fc1"]["kernel"][:, nk:])
            assert not torch.any(tree["fc1"]["bias"][nk:])
            assert not torch.any(tree["fc2"]["kernel"][nk:, :])
        rows = torch.as_tensor(plan["vmask"]) == 0
        if torch.any(rows):
            saw_vmasked = True
            assert not torch.any(mu["proj"]["kernel"][rows])
            got = blk["proj"]["kernel"][rows]
            want = orig["layers"][idx]["proj"]["kernel"][rows]
            assert (got - want).abs().max() < 1e-4
    assert saw_vmasked and saw_padding


def test_scatter_to_dense_round_trip():
    """``scatter(compact(params))`` is the dense tree bit for bit; a moved
    compact tree scatters onto its kept coordinates, re-compacts to itself,
    and leaves the template untouched."""
    params, masks, tp, tm = _setup()
    ctree, meta = tcft.compact_train_tree(tp, tm, TCFG)
    dense = tcft.scatter_to_dense(ctree, meta, tp)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(tp),
                                tree_leaves_with_path(dense)):
        assert pa == pb
        assert torch.equal(a, b), pa
        assert a.data_ptr() != b.data_ptr(), pa

    before = tree_map(torch.clone, tp)
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(lambda t: t + torch.randn(t.shape, generator=gen), ctree)
    for blk, plan in zip(moved["layers"], meta.plans):
        nk = len(plan["kept_units"])         # the padding stays zero
        blk["fc1"]["kernel"][:, nk:] = 0
        blk["fc1"]["bias"][nk:] = 0
        blk["fc2"]["kernel"][nk:] = 0
    dense = tcft.scatter_to_dense(moved, meta, tp)
    again, _ = tcft.compact_train_tree(dense, tm, TCFG)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(moved),
                                tree_leaves_with_path(again)):
        assert torch.equal(a, b), pa
    for (pa, a), (_, b) in zip(tree_leaves_with_path(before),
                               tree_leaves_with_path(tp)):
        assert torch.equal(a, b), pa
    # the dropped block keeps the template's values
    for path, leaf in tree_leaves_with_path(dense["blocks"]):
        tmpl = tp["blocks"]
        for k in path:
            tmpl = tmpl[k]
        assert torch.equal(leaf[2], tmpl[2]), path
    # JAX's scatter of the same moved tree
    jdense = jcft.scatter_to_dense(
        tree_map(lambda t: t.numpy(), moved),
        jcft.compact_train_tree(params, masks, JCFG)[1], np_tree(params),
        masks)
    compare_trees(dense, jdense, exact=True)


# ---------------------------------------------------------------------------
# the T2T branch
# ---------------------------------------------------------------------------


def test_t2t_compact_ft_matches_jax():
    """T2T-ViT-14 cut to 32 px and 2 blocks (block 1 gated off, 3 of 6
    heads and 576 of 1152 units kept, within-head dims pruned): the compact
    tree exactly, the forward (the trainable stem, the class token, the
    sinusoid positions) and one compact step against JAX's."""
    jcfg = jconfigs.get_config("t2t_vit_14").replace(**T2T_CUT)
    tcfg = tconfigs.get_config("t2t_vit_14").replace(**T2T_CUT)
    params = jt2t.init_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(4)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    masks = jmasks.build_masks(params, jnp.array([[3.0, 576.0]] * 2),
                               jnp.array([[0.0, 2.0, 0.0, 5.0, 0.0, 1.0]]
                                         * 2), jcfg)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [1.0, -1.0]])
    tp = params_from_numpy(np_tree(params), device="cpu")
    tm = masks_from_numpy(np_tree(masks), device="cpu")
    jtree, jmeta = jcft.compact_train_tree(params, masks, jcfg)
    ttree, tmeta = tcft.compact_train_tree(tp, tm, tcfg)
    assert len(ttree["layers"]) == 1 and "t2t" in ttree["top"]
    assert tmeta.plans[0]["hk"] == 3 and tmeta.plans[0]["fk"] == 640
    compare_trees(ttree, jtree, exact=True)

    x = _images(5, 3)
    ref = jax.jit(lambda tree, xb: jcft.apply_compact_ft(
        tree, jmeta, xb, jcfg, dtype=jnp.float32))(jtree, jnp.asarray(x))
    out = tcft.apply_compact_ft(ttree, tmeta, t_(x), tcfg,
                                dtype=torch.float32)
    np.testing.assert_allclose(np_(out.logits), np_(ref.logits), rtol=TOL,
                               atol=TOL)

    jthp, tthp = _thps(num_classes=10)
    jst, jm = jcft.build_compact_stage2_step(
        jcfg, JHParams(), jthp, jmeta, donate=False)(
        jstate.create_train_state(jtree, jthp, None), params, masks,
        jnp.asarray(x), jnp.arange(3), jax.random.PRNGKey(0))
    tst, tm_ = tcft.build_compact_stage2_step(tcfg, THParams(), tthp, tmeta)(
        tstate.create_train_state(ttree, tthp), tp, tm, t_(x),
        torch.arange(3), Stage2Noise(mixup=None))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(np_(tm_[k]), np_(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    compare_trees(tst.params, jst.params, key_bias=LR)
    w0 = tp["t2t"]["attention1"]["prm_w"]
    assert torch.equal(tst.params["top"]["t2t"]["attention1"]["prm_w"], w0)
