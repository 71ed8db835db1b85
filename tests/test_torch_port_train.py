"""The port's training path (uvc_tpu_torch: STEs, samplers, mixup, losses,
schedules, the resource functions, prox, the minimax update, AdamW and the
stage-1 step) against the JAX package, on the CPU, in f32.

Random numbers cross over as values: the port's samplers take their
Gumbel noise as tensors and its mixup takes a drawn decision, so the
tests draw with ``jax.random`` along the JAX step's own key chain
(``split(key, 6)`` in ``build_stage1_step``, ``split(k_arch, 3)`` in
``arch_update``) and hand the draws to the port.

Tolerances: elementwise functions and a single f32 step agree to 1e-5
relative (the same arithmetic, summed in another order).  The trajectory
agrees to 1e-4 relative Frobenius per weight leaf and 1e-5 on the minimax
state, with one exception: the key bias (the middle third of the qkv
bias).  Its gradient is zero in exact arithmetic, since the softmax over
keys is invariant to a shift shared by all keys, so its f32 value is
rounding noise, which AdamW divides by its own magnitude: the two
packages move it by different fractions of the learning rate.  It is
held to an absolute bound of the learning rate times the steps taken.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress import minimax as jminimax
from uvc_tpu.compress import optim as joptim
from uvc_tpu.compress import resource as jresource
from uvc_tpu.compress.scores import group_scores as j_group_scores
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.distill import losses as jlosses
from uvc_tpu.models import vit as jvit
from uvc_tpu.ops import gumbel as jgumbel
from uvc_tpu.ops import stes as jstes
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_stage1_step as j_build_stage1_step
from uvc_tpu.utils import schedules as jsched
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress import masks as tmasks
from uvc_tpu_torch.compress import minimax as tminimax
from uvc_tpu_torch.compress import optim as toptim
from uvc_tpu_torch.compress import resource as tresource
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.compress.state import OptState
from uvc_tpu_torch.data import mixup as tmixup
from uvc_tpu_torch.distill import losses as tlosses
from uvc_tpu_torch.interop import cstate_from_numpy, params_from_numpy
from uvc_tpu_torch.models import vit as tvit
from uvc_tpu_torch.ops import gumbel as tgumbel
from uvc_tpu_torch.ops import stes as tstes
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import (Stage1Noise, build_stage1_step,
                                      draw_stage1_noise)
from uvc_tpu_torch.utils import schedules as tsched
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4

# tests/test_reference_differential.py's tiny model and hyperparameters:
# 3 layers, 2 heads of 4, d_ff = 16
JCFG = jconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)
TCFG = tconfigs.ViTConfig(name="difftest", img_size=32, patch_size=8,
                          embed_dim=8, depth=3, num_heads=2, mlp_ratio=2.0,
                          num_classes=10)
HP_FIELDS = dict(
    budget=0.5, slr=0.05, rlr=0.05, glr=0.05, ylr=0.02, plr=0.02,
    zlr_schedule=(2.0,), sl2wd=1e-3, z_grad_clip=0.5, gating_weight=0.5,
    gating_interval=4, soptim="sgd", roptim="sgd", flops_with_mhsa=True,
    use_gumbel=False, eps=0.05, enable_block_gating=True,
    enable_part_gating=False, enable_patch_gating=0, enable_pruning=True)
THP_FIELDS = dict(learning_rate=1e-2, warmup_steps=2, t_total=20,
                  mixup=0.0, cutmix=0.0, num_classes=10)


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def close(out, ref, tol=TOL):
    np.testing.assert_allclose(np_(out), np_(ref), rtol=tol, atol=tol)


def jgumbel_noise(key, shape):
    return jax.random.gumbel(key, shape, jnp.float32)


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# straight-through estimators
# ---------------------------------------------------------------------------


def test_ste_rounding_and_identity_gradients():
    a = np.array([-1.5, -0.2, 0.0, 0.3, 2.0, 2.7], np.float32)
    for jfn, tfn in ((jstes.ste_ceil, tstes.ste_ceil),
                     (jstes.ste_floor, tstes.ste_floor)):
        w = np.arange(1, 7, dtype=np.float32)
        jv, jg = jax.value_and_grad(lambda x: jnp.sum(jfn(x) * w))(
            jnp.asarray(a))
        x = t_(a).requires_grad_()
        tv = (tfn(x) * t_(w)).sum()
        tv.backward()
        close(tv, jv)
        close(x.grad, jg)


@pytest.mark.parametrize("s", [[0.0, 0.5, 3.0], [1.2, 4.0, 7.5]])
def test_least_k_sum_value_and_gradient(s):
    scores = np.random.default_rng(0).random((3, 5)).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5], np.float32)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(
        jstes.least_k_sum(x, jnp.asarray(scores)) * w))(jnp.asarray(s))
    x = t_(s).requires_grad_()
    tv = (tstes.least_k_sum(x, t_(scores)) * t_(w)).sum()
    tv.backward()
    close(tv, jv)
    close(x.grad, jg)


def test_torch_clamp_passes_the_boundary_gradient():
    a = np.array([-0.7, -0.5, 0.0, 0.5, 0.9], np.float32)
    jg = jax.grad(lambda x: jnp.sum(jstes.torch_clamp(x, -0.5, 0.5)))(
        jnp.asarray(a))
    x = t_(a).requires_grad_()
    tstes.torch_clamp(x, -0.5, 0.5).sum().backward()
    close(x.grad, jg)
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 0])


# ---------------------------------------------------------------------------
# samplers, with JAX's Gumbel draws fed in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_with_jax_noise(hard):
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(1).standard_normal((4, 2)).astype(
        np.float32)
    w = np.array([[1.0, -3.0]] * 4, np.float32)
    jv, jg = jax.value_and_grad(lambda l: jnp.sum(jgumbel.gumbel_softmax(
        key, l, tau=0.5, hard=hard) * w))(jnp.asarray(logits))
    jy = jgumbel.gumbel_softmax(key, jnp.asarray(logits), tau=0.5, hard=hard)
    x = t_(logits).requires_grad_()
    ty = tgumbel.gumbel_softmax(t_(jgumbel_noise(key, (4, 2))), x, tau=0.5,
                                hard=hard)
    (ty * t_(w)).sum().backward()
    close(ty, jy)
    close(x.grad, jg)


def test_gumbel_topk_mask_matches_with_jax_noise():
    key = jax.random.PRNGKey(4)
    logits = np.random.default_rng(2).standard_normal((3, 16)).astype(
        np.float32)
    w = np.random.default_rng(3).standard_normal((3, 16)).astype(np.float32)
    jm = jgumbel.gumbel_topk_mask(key, jnp.asarray(logits), 11, 2.0)
    jg = jax.grad(lambda l: jnp.sum(jgumbel.gumbel_topk_mask(
        key, l, 11, 2.0) * w))(jnp.asarray(logits))
    x = t_(logits).requires_grad_()
    tm = tgumbel.gumbel_topk_mask(t_(jgumbel_noise(key, (3, 16))), x, 11, 2.0)
    (tm * t_(w)).sum().backward()
    close(tm, jm)
    assert float(tm.detach().sum()) == pytest.approx(3 * 11, abs=1e-4)
    close(x.grad, jg)


@pytest.mark.parametrize("mode", ["gumbel", "hard", "softl0", "warmup"])
def test_block_gating_distrib_matches(mode):
    key = jax.random.PRNGKey(5)
    g = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    kw = dict(use_gumbel=mode in ("gumbel", "hard"), gumbel_hard=mode == "hard",
              eps=0.05, warmup=mode == "warmup")
    jd = jgumbel.block_gating_distrib(key, jnp.asarray(g), **kw)
    td = tgumbel.block_gating_distrib(t_(jgumbel_noise(key, (3, 2))), t_(g),
                                      **kw)
    close(td, jd)
    close(tgumbel.softl0(t_(g), 0.05), jgumbel.softl0(jnp.asarray(g), 0.05))


def test_gumbel_noise_is_standard_gumbel():
    gen = torch.Generator().manual_seed(0)
    z = tgumbel.gumbel_noise(gen, (200000,)).double()
    # mean = Euler's gamma, variance = pi^2 / 6 (6 sigma bands)
    assert abs(float(z.mean()) - 0.5772157) < 6 * 1.28 / 447
    assert abs(float(z.var()) - np.pi ** 2 / 6) < 0.05


# ---------------------------------------------------------------------------
# mixup, with JAX's draws fed in
# ---------------------------------------------------------------------------


MIX = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.8, switch_prob=0.5)


def _jax_draw(key, h, w, cutmix_minmax=None):
    lam, blend, box = jmixup._sample_one(
        key, h, w, MIX["mixup_alpha"], MIX["cutmix_alpha"], MIX["prob"],
        MIX["switch_prob"], cutmix_minmax)
    return tmixup.MixupDraw(t_(lam), torch.tensor(bool(blend)),
                            torch.from_numpy(np.array(box)))


@pytest.mark.parametrize("seed", range(6))
def test_mixup_batch_mode_matches_with_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    jx, jt = jmixup.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(labels),
                                 num_classes=10, **MIX)
    tx, tt = tmixup.mixup_cutmix(t_(x), torch.from_numpy(labels),
                                 _jax_draw(key, 8, 8), num_classes=10)
    close(tx, jx)
    close(tt, jt)


@pytest.mark.parametrize("mode", ["elem", "pair"])
def test_mixup_per_sample_modes_match_with_jax_draws(mode):
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 5)
    jx, jt = jmixup.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(labels),
                                 num_classes=10, mode=mode, **MIX)
    draws = [_jax_draw(k, 8, 8) for k in jax.random.split(key, 5)]
    draw = tmixup.MixupDraw(*(torch.stack(t) for t in zip(*draws)))
    tx, tt = tmixup.mixup_cutmix(t_(x), torch.from_numpy(labels), draw,
                                 num_classes=10, mode=mode)
    close(tx, jx)
    close(tt, jt)


def test_sample_mixup_draws_valid_decisions():
    gen = torch.Generator().manual_seed(1)
    for minmax in (None, (0.2, 0.6)):
        d = tmixup.sample_mixup(gen, 16, 16, decisions=64,
                                cutmix_minmax=minmax, **MIX)
        assert d.lam.shape == (64,) and d.box.shape == (64, 16, 16)
        area = d.box.float().mean(dim=(1, 2))
        cut = d.box.any(dim=(1, 2))
        # a cut's lam is the uncut share; a blend's lam is a Beta draw
        np.testing.assert_allclose(d.lam[cut].numpy(),
                                   1 - area[cut].numpy(), atol=1e-6)
        assert not (cut & d.use_blend).any()
        assert ((d.lam == 1) | cut | d.use_blend).all()


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["soft", "hard", "none"])
def test_losses_match(kind):
    rng = np.random.default_rng(8)
    s, t = (rng.standard_normal((6, 10)).astype(np.float32) for _ in "st")
    kd = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(t)))
    close(tlosses.soft_target_cross_entropy(t_(s), t_(probs)),
          jlosses.soft_target_cross_entropy(jnp.asarray(s),
                                            jnp.asarray(probs)))
    close(tlosses.label_smoothing_cross_entropy(
        t_(s), torch.from_numpy(labels), 0.1),
        jlosses.label_smoothing_cross_entropy(jnp.asarray(s),
                                              jnp.asarray(labels), 0.1))
    base = jnp.float32(1.5)
    close(tlosses.distillation_loss(torch.tensor(1.5), t_(kd), t_(t),
                                    kind=kind, alpha=0.5, tau=2.0),
          jlosses.distillation_loss(base, jnp.asarray(kd), jnp.asarray(t),
                                    kind=kind, alpha=0.5, tau=2.0))


SCHEDULES = {
    "cosine": (jsched.warmup_cosine_schedule(1e-3, 5, 40),
               tsched.warmup_cosine_schedule(1e-3, 5, 40)),
    "linear": (jsched.warmup_linear_schedule(1e-3, 5, 40),
               tsched.warmup_linear_schedule(1e-3, 5, 40)),
    "constant": (jsched.warmup_constant_schedule(1e-3, 5),
                 tsched.warmup_constant_schedule(1e-3, 5)),
    "timm_cosine": (jsched.timm_epoch_schedule(
        "cosine", 1e-3, epochs=6, steps_per_epoch=4, warmup_epochs=2),
        tsched.timm_epoch_schedule("cosine", 1e-3, epochs=6,
                                   steps_per_epoch=4, warmup_epochs=2)),
    "timm_step": (jsched.timm_epoch_schedule(
        "step", 1e-3, epochs=6, steps_per_epoch=4, warmup_epochs=2,
        decay_epochs=2), tsched.timm_epoch_schedule(
        "step", 1e-3, epochs=6, steps_per_epoch=4, warmup_epochs=2,
        decay_epochs=2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    jfn, tfn = SCHEDULES[name]
    for step in (0, 1, 3, 5, 6, 17, 39, 40, 55):
        out = tfn(step)
        assert out.dtype == torch.float32
        close(out, jfn(step), tol=1e-7)


# ---------------------------------------------------------------------------
# resource, prox, the tiny optimizers, the minimax update
# ---------------------------------------------------------------------------


def _jax_params(seed, cfg=JCFG):
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("with_mhsa", [True, False])
def test_flops_fractions_and_their_gradients_match(with_mhsa):
    params = _jax_params(0)
    scores2 = j_group_scores(params["blocks"], JCFG.num_heads)[1]
    table_j = jresource.build_macs_table(JCFG)
    table_t = tresource.build_macs_table(TCFG)
    s = np.array([[0.0, 3.2], [1.4, 0.0], [0.3, 9.0]], np.float32)
    r = np.array([[0.0, 1.5], [2.2, 0.0], [0.7, 3.0]], np.float32)
    dist = np.array([0.2, 0.9, 0.6], np.float32)
    if with_mhsa:
        def jfn(s, r, d):
            return jresource.flops_fraction(s, r, scores2, d, table_j, JCFG)
    else:
        def jfn(s, r, d):
            return jresource.flops2_fraction(s, r, scores2, JCFG) + 0 * d[0]
    jv = jfn(jnp.asarray(s), jnp.asarray(r), jnp.asarray(dist))
    jg = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(s), jnp.asarray(r),
                                          jnp.asarray(dist))
    ts, tr, td = (t_(a).requires_grad_() for a in (s, r, dist))
    sc2 = t_(np.asarray(scores2))
    if with_mhsa:
        tv = tresource.flops_fraction(ts, tr, sc2, td, table_t, TCFG)
    else:
        tv = tresource.flops2_fraction(ts, tr, sc2, TCFG) + 0 * td[0]
    tv.backward()
    close(tv, jv)
    for got, ref in zip((ts.grad, tr.grad, td.grad), jg):
        close(got, ref)


def test_prox_weights_match():
    params = _jax_params(1)
    s = jnp.array([[1.0, 5.0], [0.0, 3.0], [2.0, 0.0]])
    r = jnp.array([[1.0, 2.0], [0.0, 3.0], [1.0, 1.0]])
    y = jnp.array([[0.3, 0.2], [0.1, 0.4], [0.5, 0.6]])
    p = jnp.array([[0.2, 0.7], [0.3, 0.1], [0.9, 0.4]])
    ref = jmasks.prox_weights(params, s, r, y, p, jnp.float32(0.1), JCFG)
    tp = params_from_numpy(_np_tree(params), device="cpu")
    out = tmasks.prox_weights(tp, t_(s), t_(r), t_(y), t_(p),
                              torch.tensor(0.1), TCFG)
    for name in ("proj", "fc2"):
        close(out["blocks"][name]["kernel"], ref["blocks"][name]["kernel"])
    assert torch.equal(tp["blocks"]["fc1"]["kernel"],
                       out["blocks"]["fc1"]["kernel"])


@pytest.mark.parametrize("kind,kw", [
    ("sgd", {}), ("sgd", dict(momentum=0.9, weight_decay=1e-4)),
    ("adam", dict(betas=(0.9, 0.999))), ("rmsprop", {})])
def test_tiny_optimizers_match(kind, kw):
    rng = np.random.default_rng(9)
    p0 = rng.standard_normal((3, 2)).astype(np.float32)
    jp, js = jnp.asarray(p0), joptim.init_opt_state(kind, jnp.asarray(p0))
    tp, ts = t_(p0), toptim.init_opt_state(kind, t_(p0))
    for _ in range(4):
        g = rng.standard_normal((3, 2)).astype(np.float32)
        jp, js = joptim.opt_step(kind, jp, jnp.asarray(g), js, 0.05, **kw)
        tp, ts = toptim.opt_step(kind, tp, t_(g), ts, 0.05, **kw)
        close(tp, jp)
    assert ts.count == int(js.count) == 4


def _arch_inputs(hp_fields, seed):
    jhp, thp = JHParams(**hp_fields), THParams(**hp_fields)
    params = _jax_params(seed)
    params["block_gating"] = jnp.array([[-0.4, 0.6], [0.3, 0.1],
                                        [-0.2, 0.9]])
    cstate = jminimax.init_compression_state(JCFG, jhp).replace(
        s=jnp.array([[0.0, 2.3], [1.2, 0.0], [0.4, 5.0]]),
        r=jnp.array([[0.0, 1.1], [2.6, 0.0], [0.2, 0.0]]),
        z=jnp.float32(0.4), gating_accum=jnp.full((3, 2), 0.05))
    return jhp, thp, params, cstate


@pytest.mark.parametrize("case", ["gumbel_window_step", "gumbel_mid_window",
                                  "softl0_adam", "warmup", "no_pruning"])
def test_arch_update_matches(case):
    fields = dict(HP_FIELDS, use_gumbel=case.startswith("gumbel"))
    if case == "softl0_adam":
        fields.update(soptim="adam", roptim="rmsprop")
    if case == "no_pruning":
        fields.update(enable_pruning=False, use_gumbel=True)
    jhp, thp, params, cstate = _arch_inputs(fields, 2)
    step = {"gumbel_mid_window": 5}.get(case, 3)   # interval 4: 3 steps
    warmup = case == "warmup"
    key = jax.random.PRNGKey(11)
    g_grad = np.random.default_rng(10).standard_normal((3, 2)).astype(
        np.float32)
    table_j = jresource.build_macs_table(JCFG)
    jp, jc, jm = jminimax.arch_update(
        params, cstate, key=key, step=jnp.int32(step),
        gating_loss_grad=jnp.asarray(g_grad), main_lr=jnp.float32(0.1),
        hp=jhp, cfg=JCFG, table=table_j, warmup=warmup, gumbel_hard=warmup)
    k_res1, k_res2, _ = jax.random.split(key, 3)
    noise = (t_(jgumbel_noise(k_res1, (3, 2))),
             t_(jgumbel_noise(k_res2, (3, 2))))
    tp = params_from_numpy(_np_tree(params), device="cpu")
    tc = cstate_from_numpy(_np_tree(cstate), device="cpu")
    op, oc, om = tminimax.arch_update(
        tp, tc, noise=noise, step=step, gating_loss_grad=t_(g_grad),
        main_lr=torch.tensor(0.1), hp=thp, cfg=TCFG,
        table=tresource.build_macs_table(TCFG), warmup=warmup,
        gumbel_hard=warmup)
    assert set(om) == set(jm)
    for k in jm:
        close(om[k], jm[k])
    for f in ("s", "r", "y", "p", "z", "gating_accum"):
        close(getattr(oc, f), getattr(jc, f))
    close(oc.gating_opt.m, jc.gating_opt.m)
    assert oc.gating_opt.count == int(jc.gating_opt.count)
    for name in ("proj", "fc2"):
        close(op["blocks"][name]["kernel"], jp["blocks"][name]["kernel"])
    close(op["block_gating"], jp["block_gating"])


def test_cstate_from_numpy_carries_every_field():
    jhp = JHParams(soptim="adam")
    jc = jminimax.init_compression_state(JCFG, jhp)
    tc = cstate_from_numpy(_np_tree(jc), device="cpu")
    ref = tminimax.init_compression_state(TCFG, THParams(soptim="adam"),
                                          device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(tc, f.name), getattr(ref, f.name)
        if isinstance(b, OptState):
            assert a.count == b.count
            for m in ("m", "v"):
                assert (getattr(a, m) is None) == (getattr(b, m) is None)
                if getattr(b, m) is not None:
                    assert torch.equal(getattr(a, m), getattr(b, m))
        else:
            assert a.dtype == torch.float32 and torch.equal(a, b), f.name


def test_minimax_hparams_fields_match_the_jax_defaults():
    assert ({f.name: f.default for f in dataclasses.fields(THParams)}
            == {f.name: f.default for f in dataclasses.fields(JHParams)})


# ---------------------------------------------------------------------------
# AdamW, clipping, train hyperparameters
# ---------------------------------------------------------------------------


def test_adamw_matches_optax():
    rng = np.random.default_rng(12)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    sched_j = jsched.warmup_cosine_schedule(1e-2, 2, 10)
    sched_t = tsched.warmup_cosine_schedule(1e-2, 2, 10)
    tx = optax.adamw(sched_j, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    ttx = tstate.AdamW(sched_t, 0.9, 0.999, 1e-8, 0.05)
    tp = {"a": t_(params["a"]), "b": {"c": t_(params["b"]["c"])}}
    ts = ttx.init(tp)
    for _ in range(5):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
        ju, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({"a": t_(g["a"]), "b": {"c": t_(g["b"]["c"])}},
                            ts, tp)
        tp = {"a": tp["a"] + tu["a"], "b": {"c": tp["b"]["c"] + tu["b"]["c"]}}
        close(tp["a"], jp["a"])
        close(tp["b"]["c"], jp["b"]["c"])
    assert ts.count == 5


def test_clip_global_norm_matches():
    rng = np.random.default_rng(13)
    g = {"a": 3 * rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        jg, jn = jstate.clip_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm)
        tg, tn = tstate.clip_global_norm({k: t_(v) for k, v in g.items()},
                                         max_norm)
        close(tn, jn)
        for k in g:
            close(tg[k], jg[k])


def test_train_hparams_fields_match_the_jax_defaults():
    j = {f.name: f.default for f in dataclasses.fields(jstate.TrainHParams)}
    t = {f.name: f.default for f in dataclasses.fields(tstate.TrainHParams)}
    assert set(j) == set(t)
    for k in j:
        if k != "compute_dtype":
            assert t[k] == j[k], k
    assert t["compute_dtype"] == torch.bfloat16
    assert j["compute_dtype"] == jnp.bfloat16


def test_unported_paths_raise():
    # stage 2's SGD surface is ported: the optimizer builds
    assert isinstance(tstate.make_weight_optimizer(
        tstate.TrainHParams(opt="sgd")), tstate.SGD)
    # CaiT has no block gating: the step refuses it where it is built
    with pytest.raises(ValueError, match="no block gating"):
        build_stage1_step(tconfigs.get_config("cait_S24_224"),
                          tresource.build_macs_table(TCFG), THParams(),
                          tstate.TrainHParams(), warmup=False)
    # part gating is ported: the step builds
    build_stage1_step(TCFG, tresource.build_macs_table(TCFG),
                      THParams(enable_part_gating=True),
                      tstate.TrainHParams(), warmup=False)


@pytest.mark.parametrize("entry", ["draw_stage1_noise",
                                   "init_compression_state",
                                   "s_r_upper_bounds"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a device argument a tensor-making entry point asks for the
    card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "draw_stage1_noise": lambda: draw_stage1_noise(
            torch.Generator(), TCFG, THParams(), tstate.TrainHParams(), 2),
        "init_compression_state": lambda: tminimax.init_compression_state(
            TCFG, THParams()),
        "s_r_upper_bounds": lambda: tminimax.s_r_upper_bounds(TCFG)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


# ---------------------------------------------------------------------------
# the stage-1 step against build_stage1_step
# ---------------------------------------------------------------------------


def _setup_step(hp_fields, thp_fields, batch, seed=0):
    jhp, thp_ = JHParams(**hp_fields), THParams(**hp_fields)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **thp_fields)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **thp_fields)
    params = _jax_params(seed)
    teacher = _jax_params(seed + 100)
    cstate = jminimax.init_compression_state(JCFG, jhp)
    jst = jstate.create_train_state(params, jthp, cstate)
    tst = tstate.create_train_state(
        params_from_numpy(_np_tree(params), device="cpu"), tthp,
        cstate_from_numpy(_np_tree(cstate), device="cpu"))
    tteacher = params_from_numpy(_np_tree(teacher), device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return dict(jhp=jhp, thp=thp_, jthp=jthp, tthp=tthp, jst=jst, tst=tst,
                teacher=teacher, tteacher=tteacher, x=x, labels=labels)


def _jax_noise(key, jthp, jhp, batch):
    """The draws of one JAX step, along its key chain."""
    k_mix, k_gate, k_part1, k_part2, k_tok, k_arch = jax.random.split(key, 6)
    k_res1, k_res2, _ = jax.random.split(k_arch, 3)
    mix = None
    if jthp.mixup > 0 or jthp.cutmix > 0:
        lam, blend, box = jmixup._sample_one(
            k_mix, JCFG.img_size, JCFG.img_size, jthp.mixup, jthp.cutmix,
            jthp.mixup_prob, jthp.mixup_switch_prob, jthp.cutmix_minmax)
        mix = tmixup.MixupDraw(t_(lam), torch.tensor(bool(blend)),
                               torch.from_numpy(np.array(box)))
    l2 = (JCFG.depth, 2)
    return Stage1Noise(
        mixup=mix, gate=t_(jgumbel_noise(k_gate, l2)),
        token=t_(jgumbel_noise(k_tok, (batch, JCFG.num_patches))),
        res1=t_(jgumbel_noise(k_res1, l2)),
        res2=t_(jgumbel_noise(k_res2, l2)),
        part_attn=t_(jgumbel_noise(k_part1, l2)),
        part_mlp=t_(jgumbel_noise(k_part2, l2)))


def _compare_states(tst, jst, tol):
    tc, jc = tst.cstate, jst.cstate
    for f in ("s", "r", "y", "p", "z", "gating_accum"):
        close(getattr(tc, f), getattr(jc, f), tol=TOL)
    assert tst.step == int(jst.step)
    jleaves = dict((jax.tree_util.keystr(p), v) for p, v in
                   jax.tree_util.tree_leaves_with_path(jst.params))
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(tst.params):
        ref = np.asarray(jleaves["".join(f"['{k}']" for k in path)])
        leaf = np_(leaf)
        if path == ("blocks", "qkv", "bias"):
            # the key bias: zero gradient up to rounding (see the top)
            bound = THP_FIELDS["learning_rate"] * max(1, tst.step)
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=bound, rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if np.any(ref):
            assert rel_fro(np_(leaf), ref) <= tol, path
        else:
            np.testing.assert_allclose(np_(leaf), np.asarray(ref), atol=tol)


def _run_both(setup, n_steps, *, warmup=False, tau=5.0, key_seed=0):
    jstep = j_build_stage1_step(JCFG, jresource.build_macs_table(JCFG),
                                setup["jhp"], setup["jthp"], warmup=warmup,
                                donate=False)
    tstep = build_stage1_step(TCFG, tresource.build_macs_table(TCFG),
                              setup["thp"], setup["tthp"], warmup=warmup)
    jst, tst = setup["jst"], setup["tst"]
    x, labels = setup["x"], setup["labels"]
    hist = []
    for i in range(n_steps):
        key = jax.random.PRNGKey(1000 * key_seed + i)
        jst, jm = jstep(jst, setup["teacher"], jnp.asarray(x),
                        jnp.asarray(labels), key, jnp.float32(tau))
        noise = _jax_noise(key, setup["jthp"], setup["jhp"], x.shape[0])
        tst, tm = tstep(tst, setup["tteacher"], t_(x),
                        torch.from_numpy(labels).long(), noise, tau)
        hist.append((jst, jm, tst, tm))
    return hist


def test_stage1_trajectory_matches_jax_five_steps():
    """5 steps of the differential-test configuration (no Gumbel draws,
    no token selection, mixup off): s / r / y / p / z / gating / weights
    and the metrics after every step; the gating SGD step fires at step
    3 (interval 4)."""
    setup = _setup_step(HP_FIELDS, THP_FIELDS, batch=4)
    hist = _run_both(setup, 5)
    moved = False
    for jst, jm, tst, tm in hist:
        for k in ("loss", "grad_norm", "lr", "resource", "z"):
            close(tm[k], jm[k])
        _compare_states(tst, jst, TRAJ_TOL)
        moved |= bool(np.any(np.asarray(jst.cstate.s) > 0))
    assert moved
    g0 = np.asarray(setup["jst"].params["block_gating"])
    assert not np.allclose(np.asarray(hist[3][0].params["block_gating"]), g0)


def test_stage1_step_with_gumbel_tokens_and_mixup_matches_jax_draws():
    """One step of bench.py's flagship settings at a tiny size: Gumbel
    block gating, Gumbel token top-k (enable_patch_gating=2), mixup and
    cutmix, soft distillation, with the JAX step's own draws."""
    fields = dict(HP_FIELDS, use_gumbel=True, enable_patch_gating=2,
                  patch_ratio=0.75, gating_interval=100)
    thp_fields = dict(THP_FIELDS, mixup=0.8, cutmix=1.0)
    for key_seed in range(2):
        setup = _setup_step(fields, thp_fields, batch=4, seed=3)
        (jst, jm, tst, tm), = _run_both(setup, 1, key_seed=key_seed)
        for k in ("loss", "grad_norm", "resource", "z"):
            close(tm[k], jm[k])
        _compare_states(tst, jst, TRAJ_TOL)


def test_stage1_warmup_step_matches_and_freezes_gating():
    fields = dict(HP_FIELDS, use_gumbel=True)
    setup = _setup_step(fields, THP_FIELDS, batch=4, seed=4)
    (jst, jm, tst, tm), = _run_both(setup, 1, warmup=True)
    for k in ("loss", "grad_norm", "lr", "resource"):
        close(tm[k], jm[k])
    _compare_states(tst, jst, TRAJ_TOL)
    assert torch.equal(tst.params["block_gating"],
                       setup["tst"].params["block_gating"])
    assert tst.cstate.s is setup["tst"].cstate.s   # warmup leaves s alone


def test_stage1_micro_step_then_boundary_step_match():
    thp_fields = dict(THP_FIELDS, accum_steps=2)
    setup = _setup_step(HP_FIELDS, thp_fields, batch=4, seed=5)
    table_j = jresource.build_macs_table(JCFG)
    table_t = tresource.build_macs_table(TCFG)
    jmicro = j_build_stage1_step(JCFG, table_j, setup["jhp"], setup["jthp"],
                                 warmup=False, donate=False, micro=True)
    tmicro = build_stage1_step(TCFG, table_t, setup["thp"], setup["tthp"],
                               warmup=False, micro=True)
    x, labels = setup["x"], setup["labels"]
    key = jax.random.PRNGKey(9)
    jst, jm = jmicro(setup["jst"], setup["teacher"], jnp.asarray(x),
                     jnp.asarray(labels), key, jnp.float32(5.0))
    tst, tm = tmicro(setup["tst"], setup["tteacher"], t_(x),
                     torch.from_numpy(labels).long(),
                     _jax_noise(key, setup["jthp"], setup["jhp"], 4), 5.0)
    close(tm["loss"], jm["loss"])
    assert tst.step == 0 and set(tm) == {"loss"}
    jacc = dict((jax.tree_util.keystr(p), v) for p, v in
                jax.tree_util.tree_leaves_with_path(jst.grad_accum))
    for path, leaf in tree_leaves_with_path(tst.grad_accum):
        ref = jacc["".join(f"['{k}']" for k in path)]
        np.testing.assert_allclose(np_(leaf), np.asarray(ref), rtol=1e-4,
                                   atol=1e-7)
    # the boundary step folds the buffer in and clears it
    setup.update(jst=jst, tst=tst)
    (jst2, jm2, tst2, tm2), = _run_both(setup, 1, key_seed=3)
    for k in ("loss", "grad_norm", "resource", "z"):
        close(tm2[k], jm2[k])
    _compare_states(tst2, jst2, TRAJ_TOL)
    assert all(not torch.any(leaf) for _, leaf in
               tree_leaves_with_path(tst2.grad_accum))


def test_draw_stage1_noise_shapes_and_reproducibility():
    hp = THParams(enable_patch_gating=2)
    thp = tstate.TrainHParams()
    a = draw_stage1_noise(torch.Generator().manual_seed(7), TCFG, hp, thp, 5,
                          device="cpu")
    b = draw_stage1_noise(torch.Generator().manual_seed(7), TCFG, hp, thp, 5,
                          device="cpu")
    assert a.gate.shape == a.res1.shape == a.res2.shape == (3, 2)
    assert a.token.shape == (5, TCFG.num_patches)
    assert a.mixup.box.shape == (32, 32)
    for u, v in zip(a, b):
        if torch.is_tensor(u):
            assert torch.equal(u, v)
    assert torch.equal(a.mixup.box, b.mixup.box)
    off = draw_stage1_noise(torch.Generator(), TCFG,
                            THParams(use_gumbel=False, enable_patch_gating=0),
                            tstate.TrainHParams(mixup=0.0, cutmix=0.0), 5,
                            device="cpu")
    assert off == Stage1Noise(None, None, None, None, None)
    part = draw_stage1_noise(torch.Generator(), TCFG,
                             THParams(enable_part_gating=True), thp, 5,
                             device="cpu")
    assert part.part_attn.shape == part.part_mlp.shape == (3, 2)


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------


def test_gumbel_token_draw_masks_and_never_gathers():
    """With a Gumbel draw, patch_physical=True still masks (the JAX rule
    ``physical = token_select and patch_physical and rng is None``): the
    same logits and token mask as the JAX forward with the same noise."""
    params = _jax_params(6)
    x = np.random.default_rng(6).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    ref = jvit.apply(params, jnp.asarray(x), JCFG, patch_gate_mode=2,
                     patch_ratio=0.75, patch_physical=True, rng=key, tau=2.0,
                     train=True)
    tp = params_from_numpy(_np_tree(params), device="cpu")
    noise = t_(jgumbel_noise(key, (3, JCFG.num_patches)))
    out = tvit.apply(tp, t_(x), TCFG, patch_gate_mode=2, patch_ratio=0.75,
                     patch_physical=True, rng=noise, tau=2.0, train=True)
    assert out.token_mask is not None
    assert out.token_mask.shape == (3, TCFG.num_patches)
    close(out.token_mask, ref.token_mask)
    close(out.logits, ref.logits, tol=2e-4)
    # without a draw the physical path gathers and reports no mask
    det = tvit.apply(tp, t_(x), TCFG, patch_gate_mode=2, patch_ratio=0.75,
                     patch_physical=True)
    assert det.token_mask is None
