"""The port's stage-2 step (uvc_tpu_torch/train/step.py::build_stage2_step)
and its SGD / momentum optimizer against the JAX package, on the CPU, in
f32.

The configuration is ``tests/test_compact_ft.py``'s: the testing ViT with
a token scorer and a distillation head, one head of layer 0 pruned,
within-head dims pruned in layer 1, half the MLP units pruned everywhere
and block 2 gated off.  JAX's mixup draws cross over as values: the JAX
step draws from ``k_mix, _ = split(key)``, and the port's step takes that
draw as its ``Stage2Noise``.

Tolerances: the metrics 1e-5 relative (the same f32 arithmetic in another
summation order), every weight leaf of the trajectory 1e-4 relative
Frobenius (``TRAJ_TOL``), except the key bias (the middle third of the qkv
bias): its gradient is zero in exact arithmetic, since the softmax over
keys is invariant to a shift shared by all keys, so its f32 value is
rounding noise, which AdamW divides by its own magnitude.  It is held to
an absolute bound of the learning rate times the steps taken, as in
``test_torch_port_train.py``.  The optimizers alone agree to 1e-6.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu.train.step import build_stage2_step as j_build_stage2_step
from uvc_tpu.utils import schedules as jsched
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train.step import (Stage2Noise, build_stage2_step,
                                      draw_stage2_noise)
from uvc_tpu_torch.utils import schedules as tsched
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
LR = 1e-2
BATCH = 4

JCFG = jconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
TCFG = tconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
THP_FIELDS = dict(num_classes=7, learning_rate=LR, warmup_steps=1,
                  t_total=10, mixup=0.8, cutmix=1.0, smoothing=0.1)


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


def setup(token_drop, opt="adamw", seed=0, **thp_fields):
    """The JAX and port states, teachers and masks of one configuration,
    and a batch."""
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    for k in ("head", "head_dist"):
        params[k]["kernel"] = jnp.asarray(
            0.1 * rng.standard_normal(params[k]["kernel"].shape), jnp.float32)
    s = jnp.array([[1.0, 32.0], [0.0, 32.0], [0.0, 32.0]])
    r = jnp.array([[0.0, 0.0], [2.0, 0.0], [0.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, JCFG)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [-1.0, 1.0],
                                        [1.0, -1.0]])
    teacher = jvit.init_params(jax.random.PRNGKey(seed + 9), JCFG)
    fields = dict(THP_FIELDS, opt=opt, **thp_fields)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **fields)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **fields)
    hp = dict(enable_patch_gating=2 if token_drop else 0, patch_ratio=0.7)
    np_params = jax.tree.map(np.asarray, params)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 7, BATCH).astype(np.int32)
    return dict(
        jhp=JHParams(**hp), thp=THParams(**hp), jthp=jthp, tthp=tthp,
        jst=jstate.create_train_state(params, jthp, None),
        tst=tstate.create_train_state(
            params_from_numpy(np_params, device="cpu"), tthp),
        teacher=teacher,
        tteacher=params_from_numpy(jax.tree.map(np.asarray, teacher),
                                   device="cpu"),
        masks=masks,
        tmasks=masks_from_numpy(jax.tree.map(np.asarray, masks),
                                device="cpu"),
        x=x, labels=labels)


def jax_noise(key, jthp):
    """The JAX stage-2 step's mixup draw (``k_mix, _ = split(key)``)."""
    k_mix, _ = jax.random.split(key)
    lam, blend, box = jmixup._sample_one(
        k_mix, 32, 32, jthp.mixup, jthp.cutmix, jthp.mixup_prob,
        jthp.mixup_switch_prob, jthp.cutmix_minmax)
    return Stage2Noise(mixup=MixupDraw(t_(lam), torch.tensor(bool(blend)),
                                       torch.from_numpy(np.array(box))))


def steps(su, keys, *, micro=False, jst=None, tst=None):
    """Run the JAX and port stage-2 steps from the setup's (or the given)
    states, one per key; returns the last states and metrics."""
    jstep = j_build_stage2_step(JCFG, su["jhp"], su["jthp"], donate=False,
                                micro=micro)
    tstep = build_stage2_step(TCFG, su["thp"], su["tthp"], micro=micro)
    jst = su["jst"] if jst is None else jst
    tst = su["tst"] if tst is None else tst
    hist = []
    for key in keys:
        key = jax.random.PRNGKey(key)
        jst, jm = jstep(jst, su["teacher"], su["masks"], jnp.asarray(su["x"]),
                        jnp.asarray(su["labels"]), key)
        tst, tm = tstep(tst, su["tteacher"], su["tmasks"], t_(su["x"]),
                        torch.from_numpy(su["labels"]).long(),
                        jax_noise(key, su["jthp"]))
        hist.append((jst, jm, tst, tm))
    return hist


def compare_params(tparams, jparams, n_steps, tol=TRAJ_TOL):
    jl = jax_leaves(jparams)
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(tparams):
        ref, leaf = jl[path], np_(leaf)
        assert leaf.shape == ref.shape, path
        if path == ("blocks", "qkv", "bias"):
            # the key bias: zero gradient up to rounding (see the top)
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=LR * max(1, n_steps), rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if np.any(ref):
            assert rel_fro(leaf, ref) <= tol, path
        else:
            np.testing.assert_allclose(leaf, ref, atol=tol)


def close(out, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np_(out), np_(ref), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_sgd_matches_optax(opt):
    """``SGD`` against ``optax.chain(add_decayed_weights, sgd)``, Nesterov
    for "sgd", heavy ball for "momentum", over 5 updates with a warmup
    schedule."""
    rng = np.random.default_rng(21)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    tx = optax.chain(optax.add_decayed_weights(0.05),
                     optax.sgd(jsched.warmup_cosine_schedule(1e-1, 2, 10),
                               momentum=0.9, nesterov=opt == "sgd"))
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    thp = tstate.TrainHParams(opt=opt, weight_decay=0.05)
    ttx = tstate.make_weight_optimizer(
        thp, lr_fn=tsched.warmup_cosine_schedule(1e-1, 2, 10))
    assert isinstance(ttx, tstate.SGD) and ttx.nesterov == (opt == "sgd")
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
        close(tp["a"], jp["a"], tol=1e-6)
        close(tp["b"]["c"], jp["b"]["c"], tol=1e-6)
    assert ts.count == 5
    close(ts.trace["a"], js[1][0].trace["a"], tol=1e-6)


def test_make_weight_optimizer_builds_every_stage2_choice():
    for opt, cls in (("adamw", tstate.AdamW), ("sgd", tstate.SGD),
                     ("momentum", tstate.SGD)):
        tx = tstate.make_weight_optimizer(tstate.TrainHParams(opt=opt))
        assert type(tx) is cls
    mom = tstate.make_weight_optimizer(tstate.TrainHParams(
        opt="momentum", momentum=0.5))
    assert mom.momentum == 0.5 and not mom.nesterov


# ---------------------------------------------------------------------------
# the stage-2 step against build_stage2_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("token_drop", [False, True],
                         ids=["tokens_all", "token_drop"])
@pytest.mark.parametrize("opt", ["adamw", "sgd", "momentum"])
def test_stage2_trajectory_matches_jax_three_steps(opt, token_drop):
    """3 stage-2 steps with JAX's mixup draws: loss, grad_norm and lr after
    every step, and every parameter leaf."""
    su = setup(token_drop, opt)
    for n, (jst, jm, tst, tm) in enumerate(steps(su, [11, 12, 13]), 1):
        for k in ("loss", "grad_norm", "lr"):
            close(tm[k], jm[k], what=k)
        assert tst.step == int(jst.step) == n
        compare_params(tst.params, jst.params, n)


def test_stage2_micro_steps_then_boundary_step_match():
    """``accum_steps`` 2: two micro steps (each adds grad / 2 into the
    buffer), then the boundary step that folds the buffer in, applies the
    update and clears it."""
    su = setup(True, accum_steps=2)
    (jst, jm, tst, tm), = steps(su, [31], micro=True)
    (jst, jm, tst, tm), = steps(su, [32], micro=True, jst=jst, tst=tst)
    close(tm["loss"], jm["loss"], what="loss")
    assert tst.step == 0 and set(tm) == {"loss"}
    jacc = jax_leaves(jst.grad_accum)
    for path, leaf in tree_leaves_with_path(tst.grad_accum):
        np.testing.assert_allclose(np_(leaf), jacc[path], rtol=1e-4,
                                   atol=1e-7, err_msg=str(path))
    (jst, jm, tst, tm), = steps(su, [33], jst=jst, tst=tst)
    for k in ("loss", "grad_norm", "lr"):
        close(tm[k], jm[k], what=k)
    compare_params(tst.params, jst.params, 1)
    assert all(not torch.any(leaf) for _, leaf in
               tree_leaves_with_path(tst.grad_accum))


def test_stage2_freezes_the_gating_and_the_scorer():
    """Two AdamW steps under the token drop: ``block_gating`` and
    ``token_scorer`` unchanged bit for bit; the first moment exactly zero
    at every parameter of the skipped block 2, at the pruned MLP units'
    fc1 columns, fc1 biases and fc2 rows, and at the pruned head's q / k /
    v and proj coordinates; a kept head's pruned dims keep their q / k
    gradients."""
    su = setup(True)
    tstep = build_stage2_step(TCFG, su["thp"], su["tthp"])
    tst = su["tst"]
    for i in range(2):
        tst, _ = tstep(tst, su["tteacher"], su["tmasks"], t_(su["x"]),
                       torch.from_numpy(su["labels"]).long(),
                       jax_noise(jax.random.PRNGKey(40 + i), su["jthp"]))
    p0 = su["tst"].params
    assert torch.equal(tst.params["block_gating"], p0["block_gating"])
    for k in ("kernel", "bias"):
        assert torch.equal(tst.params["token_scorer"][k],
                           p0["token_scorer"][k])
    mu = tst.opt_state.mu["blocks"]
    for path, leaf in tree_leaves_with_path(mu):
        assert not torch.any(leaf[2]), ("skipped block moved", path)
    d = TCFG.embed_dim
    attn, mlp = su["tmasks"]["attn"], su["tmasks"]["mlp"]
    for i in range(2):
        pruned_units = mlp[i] == 0
        assert not torch.any(mu["fc1"]["kernel"][i][:, pruned_units])
        assert not torch.any(mu["fc1"]["bias"][i][pruned_units])
        assert not torch.any(mu["fc2"]["kernel"][i][pruned_units])
        cols = attn[i] == 0
        assert not torch.any(mu["proj"]["kernel"][i][cols])
        assert not torch.any(mu["qkv"]["kernel"][i][:, 2 * d:][:, cols])
        assert not torch.any(mu["qkv"]["bias"][i][2 * d:][cols])
    # layer 0: one head pruned whole, so its q and k get no gradient either
    heads = attn[0].reshape(TCFG.num_heads, TCFG.head_size).any(dim=1)
    assert int(heads.sum()) == TCFG.num_heads - 1
    whole = (~heads).repeat_interleave(TCFG.head_size)
    for part in (slice(0, d), slice(d, 2 * d)):
        assert not torch.any(mu["qkv"]["kernel"][0][:, part][:, whole])
        assert not torch.any(mu["qkv"]["bias"][0][part][whole])
    # layer 1: pruned dims inside kept heads keep their q / k gradients
    inside = attn[1] == 0
    assert torch.any(inside)
    assert torch.all(mu["qkv"]["kernel"][1][:, :d][:, inside] != 0)


def test_draw_stage2_noise_shapes_and_reproducibility():
    thp = tstate.TrainHParams()
    a = draw_stage2_noise(torch.Generator().manual_seed(3), TCFG, thp, 5,
                          device="cpu")
    b = draw_stage2_noise(torch.Generator().manual_seed(3), TCFG, thp, 5,
                          device="cpu")
    assert a.mixup.box.shape == (32, 32)
    for u, v in zip(a.mixup, b.mixup):
        assert torch.equal(u, v)
    elem = draw_stage2_noise(torch.Generator(), TCFG,
                             tstate.TrainHParams(mixup_mode="elem"), 5,
                             device="cpu")
    assert elem.mixup.lam.shape == (5,)
    off = draw_stage2_noise(torch.Generator(), TCFG,
                            tstate.TrainHParams(mixup=0.0, cutmix=0.0), 5,
                            device="cpu")
    assert off == Stage2Noise(mixup=None)


def test_draw_stage2_noise_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        draw_stage2_noise(torch.Generator(), TCFG, tstate.TrainHParams(), 2)
