"""The port's baseline epoch loop (uvc_tpu_torch/baselines/finetune.py::
run_baseline) against the JAX package's, on the CPU, in f32, and the
resume in both directions.

Both drivers read the same procedural loaders (bit for bit the same
batches).  The port's draws are JAX's: ``finetune.draw_step_noise`` is
replaced by one that derives each step's token noise and drop-path
decisions from ``fold_in(PRNGKey(seed), global_step)`` as the JAX step
does.  Each epoch's checkpoint of the two runs then agrees: every weight
and EMA leaf within 1e-4 relative Frobenius (the key bias and the token
scorer's bias, whose gradients are rounding noise, within the learning
rate times the steps: see ``tests/test_torch_port_baseline.py``), the
masks, the step, the epoch, the GMP events and the best accuracy equal.
With its own draws, the port's run resumed from a checkpoint repeats the
uninterrupted run bit for bit; each package resumes the other's
checkpoint.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.baselines import finetune as jfinetune
from uvc_tpu.baselines import gmp as jgmp
from uvc_tpu.baselines import pruning as jpruning
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu.utils.checkpoint import load_checkpoint as j_load
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.baselines import finetune as tfinetune
from uvc_tpu_torch.baselines import gmp as tgmp
from uvc_tpu_torch.data import pipeline as tpipe
from uvc_tpu_torch.interop import params_from_numpy, wmasks_from_numpy
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.utils.checkpoint import load_checkpoint
from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

TRAJ_TOL = 1e-4
LR, SEED, BATCH, STEPS = 1e-2, 3, 4, 3
KW = dict(name="runbase", img_size=32, patch_size=8, embed_dim=16, depth=2,
          num_heads=2, num_classes=10)
JCFG = jconfigs.ViTConfig(**KW)
TCFG = tconfigs.ViTConfig(**KW)
THP = dict(learning_rate=LR, warmup_steps=2, num_epochs=2, mixup=0.0,
           cutmix=0.0, smoothing=0.1, num_classes=10,
           distillation_type=None)
CASES = {
    "mask_ema": dict(mask=True, ema=0.9),
    "gmp": dict(gmp=True),
    "tokens_drop_path": dict(tokens=True, drop_path=0.2, ema=0.5),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(seed):
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    params["head"]["kernel"] = jnp.asarray(
        0.1 * rng.standard_normal(params["head"]["kernel"].shape),
        jnp.float32)
    return params


def loaders(pkg):
    train = pkg.ProceduralLoader(BATCH, num_batches=STEPS, img_size=32,
                                 num_classes=10, train=True, seed=SEED)
    test = pkg.ProceduralLoader(BATCH, num_batches=2, img_size=32,
                                num_classes=10, train=False, seed=SEED)
    return train, test


def jax_step_noise(seed, global_step, cfg, thp, batch, *, device,
                   token_selection, drop_path_rate, re_prob, re_count,
                   re_mode):
    """The JAX step's draws at ``global_step`` as a ``BaselineNoise``
    (no mixup and no erasing in these runs)."""
    assert thp.mixup == 0 and thp.cutmix == 0 and re_prob == 0
    key = jax.random.fold_in(jax.random.PRNGKey(seed), global_step)
    _, k_tok, _ = jax.random.split(key, 3)
    token = keep = None
    if token_selection:
        token = torch.from_numpy(np.array(jax.random.gumbel(
            k_tok, (batch, cfg.num_patches), jnp.float32)))
    if drop_path_rate > 0:
        keys = jax.random.split(jax.random.fold_in(k_tok, 7), cfg.depth)
        rates = jnp.linspace(0.0, drop_path_rate, cfg.depth)
        keep = np.zeros((cfg.depth, 2, batch), bool)
        for i in range(cfg.depth):
            p = 1.0 - rates[i].astype(jnp.float32)
            for j in range(2):
                keep[i, j] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(keys[i], j), p,
                    (batch, 1, 1)))[:, 0, 0]
        keep = torch.from_numpy(keep)
    return tfinetune.BaselineNoise(mixup=None, erasing=None, token=token,
                                   drop_path=keep)


def run_kw(case):
    return dict(token_selection=case.get("tokens", False),
                ema_decay=case.get("ema", 0.0),
                drop_path_rate=case.get("drop_path", 0.0), seed=SEED)


def run_jax(case, tmp_path, name, resume=None):
    params = jax_params(4)
    thp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP)
    masks = (jpruning.global_threshold_mask(
        jpruning.magnitude_scores(params), 0.5) if case.get("mask")
             else None)
    gmp = (jgmp.GMPSchedule(sparsity=0.6, t_start=1, delta_t=2,
                            pruning_times=2) if case.get("gmp") else None)
    train, test = loaders(jpipe)
    return jfinetune.run_baseline(
        JCFG, thp, train_loader=train, test_loader=test, params=params,
        wmasks=masks, gmp=gmp, output_dir=str(tmp_path), name=name,
        resume=resume, **run_kw(case))


def run_port(case, tmp_path, name, resume=None):
    params = jax_params(4)
    thp = tstate.TrainHParams(compute_dtype=torch.float32, **THP)
    masks = (wmasks_from_numpy(np_tree(jpruning.global_threshold_mask(
        jpruning.magnitude_scores(params), 0.5)), device="cpu")
             if case.get("mask") else None)
    gmp = (tgmp.GMPSchedule(sparsity=0.6, t_start=1, delta_t=2,
                            pruning_times=2) if case.get("gmp") else None)
    train, test = loaders(tpipe)
    return tfinetune.run_baseline(
        TCFG, thp, train_loader=train, test_loader=test,
        params=params_from_numpy(np_tree(params), device="cpu"),
        wmasks=masks, gmp=gmp, output_dir=str(tmp_path), name=name,
        resume=resume, device="cpu", **run_kw(case))


def ckpt(tmp_path, name, epoch):
    return str(tmp_path / name / f"{JCFG.name}_baseline_{epoch}.ckpt")


def compare_weights(ttree, jtree, steps):
    d = JCFG.embed_dim
    for path, leaf in tree_leaves_with_path(ttree):
        ref = np.asarray(leaf_at(jtree, path), np.float64)
        leaf = np.asarray(leaf, np.float64)
        if path == ("blocks", "qkv", "bias"):
            np.testing.assert_allclose(leaf[:, d:2 * d], ref[:, d:2 * d],
                                       atol=LR * steps, rtol=0)
            leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                         for a in (leaf, ref))
        if path == ("token_scorer", "bias"):
            np.testing.assert_allclose(leaf, ref, atol=LR * steps, rtol=0)
            continue
        den = np.linalg.norm(ref)
        err = np.linalg.norm(leaf - ref) / (den if den else 1.0)
        assert err <= TRAJ_TOL, (path, err)


def compare_checkpoints(tck, jck, case):
    """A port checkpoint against a JAX one of the same epoch."""
    assert sorted(tck) == sorted(jck)
    for k in ("step", "epoch", "gmp_events"):
        assert int(tck[k]) == int(np.asarray(jck[k])), k
    assert float(tck["best_acc"]) == float(np.asarray(jck["best_acc"]))
    steps = int(tck["step"])
    compare_weights(tck["params"], jck["params"], steps)
    if case.get("ema"):
        compare_weights(tck["ema_params"], jck["ema_params"], steps)
    else:
        assert not tck["ema_params"] and not jck["ema_params"]
    assert sorted(tck["masks"]) == sorted(jck["masks"])
    for k, m in tck["masks"].items():
        np.testing.assert_array_equal(m.numpy(), np.asarray(jck["masks"][k]),
                                      err_msg=k)
    # AdamW's state: the counts, and the moments (but those of the two
    # rounding-noise biases) within the trajectory tolerance
    assert int(tck["opt_state"]["0"]["count"]) == steps
    assert int(tck["opt_state"]["2"]["count"]) == steps
    d = JCFG.embed_dim
    for mom in ("mu", "nu"):
        for path, leaf in tree_leaves_with_path(tck["opt_state"]["0"][mom]):
            ref = np.asarray(leaf_at(jck["opt_state"]["0"][mom], path),
                             np.float64)
            leaf = leaf.double().numpy()
            if path == ("token_scorer", "bias"):
                continue
            if path == ("blocks", "qkv", "bias"):
                leaf, ref = (np.concatenate([a[:, :d], a[:, 2 * d:]], axis=1)
                             for a in (leaf, ref))
            den = np.linalg.norm(ref)
            err = np.linalg.norm(leaf - ref) / (den if den else 1.0)
            assert err <= TRAJ_TOL, (mom, path, err)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tfinetune, "draw_step_noise", jax_step_noise)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_baseline_matches_jax(tmp_path, jax_draws, name):
    case = CASES[name]
    jres = run_jax(case, tmp_path, "jax")
    tres = run_port(case, tmp_path, "port")
    assert tres.best_acc == pytest.approx(jres.best_acc, abs=0)
    for epoch in range(THP["num_epochs"]):
        compare_checkpoints(load_checkpoint(ckpt(tmp_path, "port", epoch)),
                            j_load(ckpt(tmp_path, "jax", epoch)), case)
    assert tres.state.step == int(jres.state.step) == 2 * STEPS
    if case.get("gmp"):
        # events at steps 3 and 5: the second at the ramp's end
        ck = load_checkpoint(ckpt(tmp_path, "port", 1))
        assert int(ck["gmp_events"]) == 2
        assert tfinetune.mask_sparsity(tres.masks) == pytest.approx(
            jpruning.mask_sparsity(jres.masks), abs=0)
        assert tfinetune.mask_sparsity(tres.masks) == pytest.approx(0.4,
                                                                    abs=1e-3)
    if case.get("mask") or case.get("gmp"):
        # a masked coordinate's AdamW first moment is exactly zero
        for path, m in tree_leaves_with_path(tres.masks):
            mu = leaf_at(tres.state.opt_state.mu, path)
            if case.get("mask"):
                assert not torch.any(mu[m == 0]), path


@pytest.mark.parametrize("name", ["mask_ema", "gmp", "tokens_drop_path"])
def test_port_resume_repeats_the_run_bit_for_bit(tmp_path, name):
    """The port's own draws, keyed by (seed, step): the run resumed from
    its epoch-0 checkpoint writes the uninterrupted run's epoch-1
    checkpoint bit for bit."""
    case = CASES[name]
    run_port(case, tmp_path, "full")
    run_port(case, tmp_path, "resumed", resume=ckpt(tmp_path, "full", 0))
    with open(ckpt(tmp_path, "full", 1), "rb") as a, \
            open(ckpt(tmp_path, "resumed", 1), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("direction", ["jax_resumes_port",
                                       "port_resumes_jax"])
def test_each_package_resumes_the_other(tmp_path, jax_draws, direction):
    """Epoch 1 resumed by one package from the other's epoch-0 checkpoint
    (masks, EMA and GMP events included) agrees with the uninterrupted
    run's epoch-1 checkpoint."""
    case = {"gmp": True, "ema": 0.9}
    if direction == "jax_resumes_port":
        run_port(case, tmp_path, "first")
        run_jax(case, tmp_path, "second", resume=ckpt(tmp_path, "first", 0))
        tck = load_checkpoint(ckpt(tmp_path, "first", 1))
        jck = j_load(ckpt(tmp_path, "second", 1))
    else:
        run_jax(case, tmp_path, "first")
        run_port(case, tmp_path, "second", resume=ckpt(tmp_path, "first", 0))
        jck = j_load(ckpt(tmp_path, "first", 1))
        tck = load_checkpoint(ckpt(tmp_path, "second", 1))
    compare_checkpoints(tck, jck, case)


def test_resume_without_saved_ema_warm_starts_from_the_weights(tmp_path):
    """EMA on, resuming a checkpoint that holds none: the EMA starts from
    the restored weights (one step of decay 0.99 after them), not from
    the pre-resume ones."""
    thp = tstate.TrainHParams(compute_dtype=torch.float32,
                                   **dict(THP, num_epochs=1))
    saved = params_from_numpy(np_tree(jax_params(7)), device="cpu")
    state = tfinetune.create_baseline_state(saved, thp)
    from uvc_tpu_torch.utils.checkpoint import save_checkpoint
    path = str(tmp_path / "no_ema.ckpt")
    save_checkpoint(path, {"params": saved,
                           "opt_state": tstate.opt_state_to_state_dict(
                               state.opt_state),
                           "ema_params": {}, "masks": {}, "step": 5,
                           "epoch": 0, "best_acc": 0.0, "gmp_events": 0})
    train, _ = loaders(tpipe)
    thp = dataclasses.replace(thp, num_epochs=0)
    res = tfinetune.run_baseline(
        TCFG, thp, train_loader=train, test_loader=None,
        params=params_from_numpy(np_tree(jax_params(0)), device="cpu"),
        ema_decay=0.99, resume=path, save_checkpoints=False,
        output_dir=str(tmp_path), name="ema", device="cpu")
    assert res.state.step == 5
    for path_, leaf in tree_leaves_with_path(res.state.ema_params):
        assert torch.equal(leaf, leaf_at(saved, path_)), path_


def test_run_baseline_mesh_raises(tmp_path):
    """A mesh whose model axis is not ``mp`` raises; ``mp > 1`` without a
    mesh is not read, as in the JAX driver, and the run is the one-process
    run bit for bit."""
    from uvc_tpu_torch.parallel.mesh import Mesh
    thp = tstate.TrainHParams(compute_dtype=torch.float32,
                              **dict(THP, num_epochs=1))
    train, test = loaders(tpipe)
    params = params_from_numpy(np_tree(jax_params(0)), device="cpu")
    with pytest.raises(ValueError, match=r"mp\(2\) is not the mesh's"):
        tfinetune.run_baseline(
            TCFG, thp, train_loader=train, test_loader=test, params=params,
            mesh=Mesh(size=1, rank=0), mp=2, output_dir=str(tmp_path),
            device="cpu")
    runs = [tfinetune.run_baseline(
        TCFG, thp, train_loader=train, test_loader=None, params=params,
        mp=mp, save_checkpoints=False, output_dir=str(tmp_path),
        device="cpu") for mp in (1, 2)]
    for path_, leaf in tree_leaves_with_path(runs[1].state.params):
        assert torch.equal(leaf, leaf_at(runs[0].state.params, path_)), path_


def test_draw_step_noise_is_keyed_by_seed_and_step():
    thp = tstate.TrainHParams(num_classes=10)
    kw = dict(token_selection=True, drop_path_rate=0.1, re_prob=0.25,
              re_count=1, re_mode="pixel", device="cpu")
    a = tfinetune.draw_step_noise(1, 7, TCFG, thp, 3, **kw)
    b = tfinetune.draw_step_noise(1, 7, TCFG, thp, 3, **kw)
    c = tfinetune.draw_step_noise(1, 8, TCFG, thp, 3, **kw)
    d = tfinetune.draw_step_noise(2, 7, TCFG, thp, 3, **kw)
    assert torch.equal(a.token, b.token)
    assert torch.equal(a.erasing.fill, b.erasing.fill)
    assert not torch.equal(a.token, c.token)
    assert not torch.equal(a.token, d.token)
