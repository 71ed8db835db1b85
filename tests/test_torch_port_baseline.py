"""The port's pruning baselines (uvc_tpu_torch: weight masks, GMP, random
erasing and the baseline fine-tune step) against the JAX package, on the
CPU, in f32.

Masks, thresholds and schedules are exact: the same 0/1 masks, the same
event steps.  Random erasing with the JAX package's own rectangles and
fill is bit-equal; the port's own draws are held to their statistics.
The 3-step baseline trajectory gets JAX's draws along the JAX step's key
chain (``split(key, 3)`` -> mixup, token / drop-path, erasing) and agrees
as the stage-1 trajectory does: 1e-5 on the metrics, 1e-4 relative
Frobenius per weight leaf (and per EMA leaf), the key bias and the token
scorer's bias (gradients zero up to rounding) to the learning rate times
the steps.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.baselines import finetune as jfinetune
from uvc_tpu.baselines import gmp as jgmp
from uvc_tpu.baselines import pruning as jpruning
from uvc_tpu.data import augment as jaugment
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.baselines import finetune as tfinetune
from uvc_tpu_torch.baselines import gmp as tgmp
from uvc_tpu_torch.baselines import pruning as tpruning
from uvc_tpu_torch.data import augment as taugment
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import params_from_numpy, wmasks_from_numpy
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4

JCFG = jconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)
TCFG = tconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)


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


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(seed, cfg=JCFG):
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# weight masks and GMP
# ---------------------------------------------------------------------------


def test_maskable_paths_and_identity_masks_match():
    params = jax_params(0)
    tp = params_from_numpy(np_tree(params), device="cpu")
    assert sorted(tpruning.maskable_paths(tp)) == sorted(
        jpruning.maskable_paths(params))
    ident = tpruning.identity_masks(tp)
    for path, leaf in tree_leaves_with_path(tp):
        m = leaf_at(ident, path)
        if ".".join(path) in tpruning.maskable_paths(tp):
            assert torch.equal(m, torch.ones_like(leaf))
        else:
            assert m is None
    out = tpruning.apply_weight_masks(tp, ident)
    for path, leaf in tree_leaves_with_path(tp):
        assert torch.equal(leaf_at(out, path), leaf)
    # density 1 prunes nothing: the identity masks, None leaves kept
    scores = tpruning.magnitude_scores(tp)
    for kind in ("global", "local"):
        full = getattr(tpruning, f"{kind}_threshold_mask")(scores, 1.0)
        for a, b in zip(tree_leaves(full), tree_leaves(ident)):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("density", [0.7, 0.5, 0.1])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_magnitude_threshold_masks_match(kind, density):
    params = jax_params(1)
    tp = params_from_numpy(np_tree(params), device="cpu")
    jfn = getattr(jpruning, f"{kind}_threshold_mask")
    tfn = getattr(tpruning, f"{kind}_threshold_mask")
    jm = jfn(jpruning.magnitude_scores(params), density)
    tm = tfn(tpruning.magnitude_scores(tp), density)
    jflat = jpruning.masks_to_flat(jm, params)
    tflat = tpruning.masks_to_flat(tm)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    assert tpruning.mask_sparsity(tm) == pytest.approx(
        jpruning.mask_sparsity(jm), abs=1e-12)
    # the masks multiply into the weights as the JAX masks do
    jw = jpruning.apply_weight_masks(params, jm)
    tw = tpruning.apply_weight_masks(tp, tm)
    for path, leaf in tree_leaves_with_path(tw):
        np.testing.assert_array_equal(np_(leaf),
                                      np.asarray(leaf_at(jw, path)))


def test_flat_round_trip_and_jax_masks_carry_across():
    params = jax_params(2)
    tp = params_from_numpy(np_tree(params), device="cpu")
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.4)
    # a JAX checkpoint's flat masks rebuild the port's tree
    tm = tpruning.masks_from_flat(jpruning.masks_to_flat(jm, params), tp)
    carried = wmasks_from_numpy(np_tree(jm), device="cpu")
    for path, leaf in tree_leaves_with_path(tp):
        a, b = leaf_at(tm, path), leaf_at(carried, path)
        ref = leaf_at(jm, path)
        if ref is None:
            assert a is None and b is None, path
        else:
            assert a.dtype == b.dtype == torch.float32
            np.testing.assert_array_equal(np_(a), np.asarray(ref))
            np.testing.assert_array_equal(np_(b), np.asarray(ref))
    back = tpruning.masks_from_flat(tpruning.masks_to_flat(tm), tp)
    for a, b in zip(tree_leaves(back), tree_leaves(tm)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert wmasks_from_numpy(None, device="cpu") is None


@pytest.mark.parametrize("t", [0, 1000, 1001, 1500, 3000, 5000, 6000, 9000])
def test_cubic_sparsity_matches(t):
    args = (0.0, 0.8, t, 1000, 10, 500)
    assert tgmp.cubic_sparsity(*args) == jgmp.cubic_sparsity(*args)


def test_gmp_schedule_event_steps_and_masks_match():
    params = jax_params(3)
    tp = params_from_numpy(np_tree(params), device="cpu")
    js = jgmp.GMPSchedule(sparsity=0.6, t_start=4, delta_t=3,
                          pruning_times=3)
    ts = tgmp.GMPSchedule(sparsity=0.6, t_start=4, delta_t=3,
                          pruning_times=3)
    events = []
    for step in range(30):
        jm = js.maybe_prune(step, params)
        tm = ts.maybe_prune(step, tp)
        assert (jm is None) == (tm is None), step
        if tm is not None:
            events.append(step)
            assert tpruning.mask_sparsity(tm) == pytest.approx(
                jpruning.mask_sparsity(jm), abs=1e-12)
    assert events == [7, 10, 13] and ts.events == js.events == 3


# ---------------------------------------------------------------------------
# random erasing
# ---------------------------------------------------------------------------


def jax_erasing_draw(key, b, h, w, c, prob, count, mode,
                     scale=(0.02, 1 / 3), ratio=(0.3, 10 / 3)):
    """The rectangles and fill ``uvc_tpu/data/augment.py::random_erasing``
    draws from ``key``, as an ``ErasingDraw``."""
    keys = jax.random.split(key, 5)
    parts = {k: [] for k in ("y0", "x0", "eh", "ew", "do", "fill")}
    for i in range(count):
        ka, kr, ky, kx, kp, kn = jax.random.split(
            jax.random.fold_in(keys[0], i), 6)
        target = h * w * jax.random.uniform(ka, (b,), minval=scale[0],
                                            maxval=scale[1])
        ar = jnp.exp(jax.random.uniform(kr, (b,), minval=jnp.log(ratio[0]),
                                        maxval=jnp.log(ratio[1])))
        eh = jnp.clip(jnp.round(jnp.sqrt(target * ar)), 1, h)
        ew = jnp.clip(jnp.round(jnp.sqrt(target / ar)), 1, w)
        parts["y0"].append(jnp.floor(jax.random.uniform(ky, (b,))
                                     * (h - eh + 1)))
        parts["x0"].append(jnp.floor(jax.random.uniform(kx, (b,))
                                     * (w - ew + 1)))
        parts["eh"].append(eh)
        parts["ew"].append(ew)
        parts["do"].append(jax.random.uniform(kp, (b,)) < prob)
        shape = (b, h, w, c) if mode == "pixel" else (b, 1, 1, c)
        parts["fill"].append(jax.random.normal(kn, shape, jnp.float32))
    stack = {k: np.stack([np.asarray(v) for v in vs])
             for k, vs in parts.items()}
    return taugment.ErasingDraw(
        *(torch.from_numpy(stack[k]).long() for k in ("y0", "x0", "eh",
                                                       "ew")),
        torch.from_numpy(stack["do"]),
        None if mode == "const" else torch.from_numpy(stack["fill"]))


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("pixel", 2),
                                        ("rand", 1), ("const", 2)])
def test_random_erasing_matches_with_jax_draws(mode, count):
    key = jax.random.PRNGKey(11)
    x = np.random.default_rng(11).standard_normal((6, 16, 12, 3)).astype(
        np.float32)
    ref = jaugment.random_erasing(key, jnp.asarray(x), prob=0.6, count=count,
                                  mode=mode)
    draw = jax_erasing_draw(key, 6, 16, 12, 3, 0.6, count, mode)
    assert draw.do.any()
    out = taugment.random_erasing(t_(x), draw)
    np.testing.assert_array_equal(np_(out), np.asarray(ref))
    assert not np.array_equal(np_(out), x)


def test_random_erasing_own_draws_statistics():
    """The port's own draws: an image is erased with probability ``prob``,
    its rectangle inside the image and of area about the mean of the
    target-area range (the clip to the image trims the larger ones)."""
    gen = torch.Generator().manual_seed(12)
    b, h, w = 4000, 32, 32
    draw = taugment.sample_erasing(gen, b, h, w, 3, prob=0.25, count=1,
                                   mode="const", device="cpu")
    assert draw.fill is None and draw.do.shape == (1, b)
    assert abs(float(draw.do.float().mean()) - 0.25) < 4 * np.sqrt(
        0.25 * 0.75 / b)
    assert (draw.y0 >= 0).all() and (draw.y0 + draw.eh <= h).all()
    assert (draw.x0 >= 0).all() and (draw.x0 + draw.ew <= w).all()
    area = (draw.eh * draw.ew).float().mean() / (h * w)
    assert 0.10 < float(area) < 0.20
    x = torch.ones(b, h, w, 3)
    out = taugment.random_erasing(x, draw)
    erased = (out == 0).all(dim=-1).any(dim=(1, 2))
    assert torch.equal(erased, draw.do[0])
    pix = taugment.sample_erasing(gen, 8, h, w, 3, count=2, mode="pixel",
                                 device="cpu")
    assert pix.fill.shape == (2, 8, h, w, 3)
    assert abs(float(pix.fill.std()) - 1.0) < 0.02
    rnd = taugment.sample_erasing(gen, 8, h, w, 3, mode="rand",
                                 device="cpu")
    assert rnd.fill.shape == (1, 8, 1, 1, 3)


# ---------------------------------------------------------------------------
# the baseline step against build_baseline_step
# ---------------------------------------------------------------------------

THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, smoothing=0.1, num_classes=10)
RECIPE = dict(mask=True, drop_path=0.3, re_prob=0.5, mixup=True, ema=0.9)
STEP_CASES = {
    "mask": dict(mask=True),
    "drop_path": dict(drop_path=0.3),
    "erasing": dict(re_prob=0.5),
    "mixup": dict(mixup=True),
    "ema": dict(ema=0.9),
    "tokens": dict(tokens=True),
    "recipe_no_teacher": dict(RECIPE),
    "recipe_teacher": dict(RECIPE, teacher=True),
}


def _jax_baseline_noise(key, case, batch, jthp):
    """The draws of one JAX baseline step, along its key chain."""
    k_mix, k_tok, k_re = jax.random.split(key, 3)
    mix = erasing = token = keep = None
    if case.get("mixup"):
        lam, blend, box = jmixup._sample_one(
            k_mix, JCFG.img_size, JCFG.img_size, jthp.mixup, jthp.cutmix,
            jthp.mixup_prob, jthp.mixup_switch_prob, jthp.cutmix_minmax)
        mix = MixupDraw(t_(lam), torch.tensor(bool(blend)),
                        torch.from_numpy(np.array(box)))
    if case.get("re_prob"):
        erasing = jax_erasing_draw(k_re, batch, JCFG.img_size, JCFG.img_size,
                                   3, case["re_prob"], 1, "pixel")
    if case.get("tokens"):
        token = t_(jax.random.gumbel(k_tok, (batch, JCFG.num_patches),
                                     jnp.float32))
    if case.get("drop_path"):
        keys = jax.random.split(jax.random.fold_in(k_tok, 7), JCFG.depth)
        rates = jnp.linspace(0.0, case["drop_path"], JCFG.depth)
        keep = np.zeros((JCFG.depth, 2, batch), bool)
        for i in range(JCFG.depth):
            p = 1.0 - rates[i].astype(jnp.float32)
            for j in range(2):
                keep[i, j] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(keys[i], j), p, (batch, 1, 1)))[:, 0, 0]
        keep = torch.from_numpy(keep)
    return tfinetune.BaselineNoise(mixup=mix, erasing=erasing, token=token,
                                   drop_path=keep)


def _compare_trees(ttree, jtree, step, lr):
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(ttree):
        ref = np.asarray(leaf_at(jtree, path))
        leaf = np_(leaf)
        if path == ("blocks", "qkv", "bias"):
            # the key bias: a zero gradient up to rounding, which AdamW
            # divides by its own magnitude (see test_torch_port_train.py)
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=lr * max(1, step), rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if path == ("token_scorer", "bias"):
            # one shift of every token's score: the token top-k does not
            # see it, so its gradient too is zero up to rounding
            np.testing.assert_allclose(leaf, ref, atol=lr * max(1, step),
                                       rtol=0)
            continue
        if np.any(ref):
            assert rel_fro(leaf, ref) <= TRAJ_TOL, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=TRAJ_TOL)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_baseline_trajectory_matches_jax(name):
    case = STEP_CASES[name]
    fields = dict(THP_FIELDS)
    if case.get("mixup"):
        fields.update(mixup=0.8, cutmix=1.0)
    if not case.get("teacher"):
        fields["distillation_type"] = "none"
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **fields)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **fields)
    params, teacher = jax_params(4), jax_params(104)
    ema = case.get("ema", 0.0)
    kw = dict(ema_decay=ema, drop_path_rate=case.get("drop_path", 0.0),
              re_prob=case.get("re_prob", 0.0),
              token_selection=case.get("tokens", False))
    tau = 5.0 if case.get("tokens") else -1.0
    jstep = jfinetune.build_baseline_step(JCFG, jthp, donate=False, **kw)
    tstep = tfinetune.build_baseline_step(TCFG, tthp, **kw)
    jmasks = tmasks = None
    if case.get("mask"):
        jmasks = jpruning.global_threshold_mask(
            jpruning.magnitude_scores(params), 0.5)
        tmasks = wmasks_from_numpy(np_tree(jmasks), device="cpu")
    jst = jfinetune.create_baseline_state(params, jthp, ema)
    tst = tfinetune.create_baseline_state(
        params_from_numpy(np_tree(params), device="cpu"), tthp, ema)
    jteacher = teacher if case.get("teacher") else None
    tteacher = (params_from_numpy(np_tree(teacher), device="cpu")
                if case.get("teacher") else None)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    for i in range(3):
        key = jax.random.PRNGKey(60 + i)
        jst, jm = jstep(jst, jteacher, jmasks, jnp.asarray(x),
                        jnp.asarray(labels), key, jnp.float32(tau))
        noise = _jax_baseline_noise(key, case, 4, jthp)
        tst, tm = tstep(tst, tteacher, tmasks, t_(x),
                        torch.from_numpy(labels).long(), noise, tau)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(np_(tm[k]), np.asarray(jm[k]),
                                       rtol=TOL, atol=TOL)
        assert tst.step == int(jst.step)
        _compare_trees(tst.params, jst.params, tst.step,
                       THP_FIELDS["learning_rate"])
        if ema:
            _compare_trees(tst.ema_params, jst.ema_params, tst.step,
                           THP_FIELDS["learning_rate"])
        else:
            assert tst.ema_params is None
    if tmasks is not None:
        # the gradient never reached a masked coordinate: its AdamW first
        # moment is still exactly zero
        for path, m in tree_leaves_with_path(tmasks):
            if m is not None:
                mu = leaf_at(tst.opt_state.mu, path)
                assert not torch.any(mu[m == 0]), path


def test_baseline_eval_step_matches_jax():
    params = jax_params(5)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, num_classes=10)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, num_classes=10)
    jm = jpruning.global_threshold_mask(jpruning.magnitude_scores(params),
                                        0.5)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 5).astype(np.int32)
    labels[-1] = -1                         # a padding row
    ref = jfinetune.build_baseline_eval_step(JCFG, jthp)(
        params, jm, jnp.asarray(x), jnp.asarray(labels))
    out = tfinetune.build_baseline_eval_step(TCFG, tthp)(
        params_from_numpy(np_tree(params), device="cpu"),
        wmasks_from_numpy(np_tree(jm), device="cpu"), t_(x),
        torch.from_numpy(labels).long())
    assert int(out["correct"]) == int(ref["correct"])
    assert int(out["count"]) == int(ref["count"]) == 4
    np.testing.assert_allclose(float(out["loss_sum"]), float(ref["loss_sum"]),
                               rtol=TOL)


def test_draw_baseline_noise_shapes_and_default_device(monkeypatch):
    thp = tstate.TrainHParams(num_classes=10)
    kw = dict(token_selection=True, drop_path_rate=0.1, re_prob=0.25,
              re_count=2)
    a = tfinetune.draw_baseline_noise(torch.Generator().manual_seed(9), TCFG,
                                      thp, 5, device="cpu", **kw)
    b = tfinetune.draw_baseline_noise(torch.Generator().manual_seed(9), TCFG,
                                      thp, 5, device="cpu", **kw)
    assert a.mixup.box.shape == (32, 32)
    assert a.erasing.fill.shape == (2, 5, 32, 32, 3)
    assert a.token.shape == (5, TCFG.num_patches)
    assert a.drop_path.shape == (3, 2, 5) and a.drop_path[0].all()
    for u, v in zip(tree_leaves(a._asdict()), tree_leaves(b._asdict())):
        for p, q in zip(u if isinstance(u, tuple) else (u,),
                        v if isinstance(v, tuple) else (v,)):
            assert torch.equal(p, q)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfinetune.draw_baseline_noise(torch.Generator(), TCFG, thp, 5)
