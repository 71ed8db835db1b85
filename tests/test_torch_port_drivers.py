"""The port's training drivers (uvc_tpu_torch/train/stage1.py::run_stage1,
train/stage2.py::run_stage2) against the JAX package's, on the CPU, in
f32, and the port's resume.

The drivers run the same loaders (bit for bit the same batches) from the
same weights; the port's draws are the JAX driver's: its two draw
functions (``train/step.py::draw_stage1_noise`` / ``draw_stage2_noise``
and ``train/stage1.py::draw_report_noise``) are replaced by ones that walk
the JAX driver's key chain (``key, k_init = split(PRNGKey(seed))``, then
``key, sub = split(key)`` a batch and ``key, k_rep = split(key)`` for the
epoch-end report; stage 2 from ``PRNGKey(seed)``) and derive each draw as
the JAX step derives it.

Tolerances are ``tests/test_torch_port_train.py``'s: every weight leaf of
the trajectory within 1e-4 relative Frobenius, except the key bias (the
middle third of the qkv bias) and the token scorer's bias, held to the
learning rate times the steps taken: each is a shift shared by all keys
(all tokens' scores), to which the softmax (the top-k) is invariant, so
its gradient is zero in exact arithmetic and its f32 value rounding
noise, which AdamW divides by its own magnitude; the minimax state
within 1e-5; the masks and the accuracy equal; the logged losses and
FLOPs fractions within 1e-4.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import mixup as jmixup
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu.models import vit as jvit
from uvc_tpu.train import state as jstate
from uvc_tpu.train.stage1 import run_stage1 as j_run_stage1
from uvc_tpu.train.stage2 import run_stage2 as j_run_stage2
from uvc_tpu.utils.checkpoint import load_checkpoint as j_load
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.data import pipeline as tpipe
from uvc_tpu_torch.data.mixup import MixupDraw
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.parallel.mesh import Mesh
from uvc_tpu_torch.train import stage1 as tstage1
from uvc_tpu_torch.train import state as tstate
from uvc_tpu_torch.train import step as tstep
from uvc_tpu_torch.train.stage1 import run_stage1
from uvc_tpu_torch.train.stage2 import run_stage2
from uvc_tpu_torch.utils.checkpoint import load_checkpoint
from uvc_tpu_torch.utils.tree import tree_leaves_with_path

TOL = 1e-5
TRAJ_TOL = 1e-4
BATCH, STEPS, SEED = 4, 3, 42

JCFG = jconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
TCFG = tconfigs.get_config("testing").replace(embed_dim=16, num_heads=2,
                                              depth=3, num_classes=7,
                                              distilled=True)
HP1 = dict(use_gumbel=True, enable_patch_gating=2, patch_ratio=0.75,
           gating_interval=2, zlr_schedule=(1.0, 5.0), slr=0.05, rlr=0.05,
           glr=0.05, gating_weight=0.5)
THP1 = dict(num_classes=7, learning_rate=2e-3, warmup_lr=1e-3,
            warmup_steps=1, t_total=STEPS, warmup_epochs=1, num_epochs=2,
            mixup=0.8, cutmix=1.0)
HP2 = dict(enable_patch_gating=2, patch_ratio=0.75)
THP2 = dict(num_classes=7, learning_rate=0.5, warmup_steps=1,
            t_total=STEPS, num_epochs=1, mixup=0.8, cutmix=1.0)


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_fro(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(out - ref) / (den if den else 1.0))


def jax_leaves(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare_params(tparams, jparams, bound):
    """Every leaf within TRAJ_TOL relative Frobenius; the key bias's middle
    third and the scorer's bias within ``bound`` (see the top)."""
    ref = jax_leaves(jparams)
    mine = tree_leaves_with_path(tparams)
    assert set(ref) == {p for p, _ in mine}
    for path, leaf in mine:
        a, b = np_(leaf), np.asarray(ref[path], np.float32)
        if path[-2:] == ("qkv", "bias"):
            d = a.shape[-1] // 3        # a compact layer's kept width
            sl = (Ellipsis, slice(d, 2 * d))
            np.testing.assert_allclose(a[sl], b[sl], atol=bound, rtol=0)
            a, b = (np.concatenate([v[..., :d], v[..., 2 * d:]], axis=-1)
                    for v in (a, b))
        if path[-2:] == ("token_scorer", "bias"):
            # a shift shared by every token's score: no gradient either
            np.testing.assert_allclose(a, b, atol=bound, rtol=0)
            continue
        if np.any(b):
            assert rel_fro(a, b) <= TRAJ_TOL, path
        else:
            np.testing.assert_allclose(a, b, atol=TRAJ_TOL)


class JaxChain:
    """Stands in for the port driver's draw functions: each call takes the
    next key of the JAX driver's chain and returns the draws the JAX step
    (or the epoch-end report) derives from it."""

    def __init__(self, key, jthp):
        self.key = key
        self.jthp = jthp

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _mixup(self, k_mix, cfg):
        t = self.jthp
        lam, blend, box = jmixup._sample_one(
            k_mix, cfg.img_size, cfg.img_size, t.mixup, t.cutmix,
            t.mixup_prob, t.mixup_switch_prob, t.cutmix_minmax)
        return MixupDraw(t_(lam), torch.tensor(bool(blend)),
                         torch.from_numpy(np.array(box)))

    def stage1(self, generator, cfg, hp, thp, batch, device="cuda"):
        k_mix, k_gate, k_p1, k_p2, k_tok, k_arch = jax.random.split(
            self._next(), 6)
        k_res1, k_res2, _ = jax.random.split(k_arch, 3)
        l2 = (cfg.depth, 2)

        def g(k, shape):
            return t_(jax.random.gumbel(k, shape, jnp.float32))

        return tstep.Stage1Noise(
            mixup=self._mixup(k_mix, cfg), gate=g(k_gate, l2),
            token=g(k_tok, (batch, cfg.num_patches)), res1=g(k_res1, l2),
            res2=g(k_res2, l2), part_attn=g(k_p1, l2), part_mlp=g(k_p2, l2))

    def report(self, generator, cfg, hp, device):
        return t_(jax.random.gumbel(self._next(), (cfg.depth, 2),
                                    jnp.float32))

    def stage2(self, generator, cfg, thp, batch, device="cuda"):
        k_mix, _ = jax.random.split(self._next())
        return tstep.Stage2Noise(mixup=self._mixup(k_mix, cfg))


def _weights(seed=0):
    params = jvit.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    for k in ("head", "head_dist"):
        params[k]["kernel"] = jnp.asarray(
            0.1 * rng.standard_normal(params[k]["kernel"].shape), jnp.float32)
    teacher = jvit.init_params(jax.random.PRNGKey(seed + 9), JCFG)
    return params, teacher


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _loaders(pipe):
    kw = dict(img_size=32, num_classes=7, seed=SEED, noise_mode="lowpass",
              contrast_range=(0.3, 0.9))
    return (pipe.ProceduralLoader(BATCH, num_batches=STEPS, train=True, **kw),
            pipe.ProceduralLoader(BATCH, num_batches=2, train=False, **kw))


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _compare_metrics(tpath, jpath):
    trec, jrec = _metrics(tpath), _metrics(jpath)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec]
    for a, b in zip(trec, jrec):
        assert set(a) == set(b)
        for k in a:
            if k == "test/accuracy":
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=TRAJ_TOL,
                                           atol=1e-6, err_msg=k)
    return trec


@pytest.fixture
def jax_draws(monkeypatch):
    """Install the JAX chain in place of the port's draws; returns a
    function that starts a chain at a JAX key."""
    def start(key, jthp):
        chain = JaxChain(key, jthp)
        monkeypatch.setattr(tstep, "draw_stage1_noise", chain.stage1)
        monkeypatch.setattr(tstep, "draw_stage2_noise", chain.stage2)
        monkeypatch.setattr(tstage1, "draw_report_noise", chain.report)
        return chain
    return start


def test_run_stage1_matches_jax(tmp_path, jax_draws):
    """One warmup and one UVC epoch of 3 steps at bench.py's flagship
    settings cut to size (Gumbel block gating, Gumbel token top-k, mixup /
    cutmix, soft distillation): the final params, minimax state and masks,
    the logged epoch reports and validations, and the checkpoints."""
    params, teacher = _weights()
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP1)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP1)
    jtrain, jtest = _loaders(jpipe)
    jres = j_run_stage1(JCFG, JHParams(**HP1), jthp, train_loader=jtrain,
                        test_loader=jtest, params=params,
                        teacher_params=teacher, seed=SEED,
                        output_dir=str(tmp_path), name="jax")
    jax_draws(jax.random.split(jax.random.PRNGKey(SEED))[0], jthp)
    ttrain, ttest = _loaders(tpipe)
    tparams = params_from_numpy(_np(params), device="cpu")
    before = {p: v.clone() for p, v in tree_leaves_with_path(tparams)}
    tres = run_stage1(TCFG, THParams(**HP1), tthp, train_loader=ttrain,
                      test_loader=ttest, params=tparams,
                      teacher_params=params_from_numpy(_np(teacher),
                                                       device="cpu"),
                      seed=SEED, output_dir=str(tmp_path), name="port",
                      device="cpu")
    # the caller's weights are copied, never changed
    assert all(torch.equal(v, before[p])
               for p, v in tree_leaves_with_path(tparams))
    assert tres.state.step == int(jres.state.step) == 2 * STEPS
    compare_params(tres.state.params, jres.state.params,
                   bound=THP1["learning_rate"] * 2 * STEPS)
    tc, jc = tres.state.cstate, jres.state.cstate
    for f in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
        np.testing.assert_allclose(np_(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    assert np.any(np.asarray(jc.s) > 0)
    for k in ("attn", "mlp"):
        np.testing.assert_array_equal(np_(tres.masks[k]),
                                      np.asarray(jres.masks[k]))
    assert tres.best_acc == jres.best_acc
    recs = _compare_metrics(tmp_path / "port" / "metrics.jsonl",
                            tmp_path / "jax" / "metrics.jsonl")
    keys = set().union(*recs)
    assert {"train/flops_expectation", "train/flops_real",
            "train/flops_real_argmax", "train/param_size", "train/z",
            "test/accuracy", "test/loss"} <= keys
    for epoch in (1, 2):
        name = f"{TCFG.name}_{epoch}.ckpt"
        ck = load_checkpoint(str(tmp_path / "port" / name))
        jck = j_load(str(tmp_path / "jax" / name))
        for k in ("epoch", "step", "global_step", "key_seed"):
            assert int(ck[k]) == int(jck[k]), k
        assert set(ck) == set(jck)
        assert set(ck["opt_state"]) == set(jck["opt_state"])
        assert set(ck["cstate"]) == set(jck["cstate"])


E2E_SIZES = dict(STEPS=10, PRETRAIN_EPOCHS=1, EPOCHS=3, WARMUP=1,
                 CLASSES=7)


def test_run_stage1_matches_jax_at_the_e2e_recipe(tmp_path, jax_draws,
                                                 monkeypatch):
    """The e2e harness's dense pretrain (no distillation: the port runs no
    teacher) and then its stage-1 recipe from the pretrained weights, the
    teacher those weights (gating every 10 steps, the 5-entry zlr
    staircase, token selection at 0.7, soft distillation), cut to 1 and 3
    epochs (1 warmup) of 10 steps: the final params, minimax state, masks
    and logged reports of each run against JAX's driver with JAX's draws
    (the harness's recipe is JAX's: test_torch_port_evidence.py)."""
    from uvc_tpu_torch.scripts import e2e_accuracy as te2e

    for k, v in E2E_SIZES.items():
        monkeypatch.setattr(te2e, k, v)
    recipe = te2e.recipe()
    loaders = dict(img_size=32, num_classes=7, seed=SEED,
                   **te2e.HARD)
    jpre, _ = _weights()
    jparams = tparams = None
    for stage, seed in (("pretrain", SEED), ("stage1", SEED + 1)):
        hp_kw, thp_kw = recipe[stage]
        jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **thp_kw)
        tthp = tstate.TrainHParams(compute_dtype=torch.float32, **thp_kw)
        jstart = jpre if jparams is None else jparams
        tstart = (params_from_numpy(_np(jpre), device="cpu")
                  if tparams is None else tparams)
        jres = j_run_stage1(
            JCFG, JHParams(**hp_kw), jthp,
            train_loader=jpipe.ProceduralLoader(
                BATCH, num_batches=10, train=True, **loaders),
            test_loader=jpipe.ProceduralLoader(
                BATCH, num_batches=2, train=False, **loaders),
            params=jstart, teacher_params=jstart, seed=seed,
            output_dir=str(tmp_path), name=f"jax_{stage}",
            save_checkpoints=False)
        jax_draws(jax.random.split(jax.random.PRNGKey(seed))[0], jthp)
        tres = run_stage1(
            TCFG, THParams(**hp_kw), tthp,
            train_loader=tpipe.ProceduralLoader(
                BATCH, num_batches=10, train=True, **loaders),
            test_loader=tpipe.ProceduralLoader(
                BATCH, num_batches=2, train=False, **loaders),
            params=tstart, teacher_params=tstart, seed=seed,
            output_dir=str(tmp_path), name=f"port_{stage}",
            save_checkpoints=False, device="cpu")
        steps = jthp.num_epochs * 10
        assert tres.state.step == int(jres.state.step) == steps
        compare_params(tres.state.params, jres.state.params,
                       bound=thp_kw["learning_rate"] * steps)
        tc, jc = tres.state.cstate, jres.state.cstate
        for f in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
            np.testing.assert_allclose(np_(getattr(tc, f)),
                                       np.asarray(getattr(jc, f)),
                                       rtol=TOL, atol=TOL, err_msg=f)
        for k in ("attn", "mlp"):
            np.testing.assert_array_equal(np_(tres.masks[k]),
                                          np.asarray(jres.masks[k]))
        assert tres.best_acc == jres.best_acc
        _compare_metrics(tmp_path / f"port_{stage}" / "metrics.jsonl",
                         tmp_path / f"jax_{stage}" / "metrics.jsonl")
        jparams, tparams = jres.state.params, tres.state.params
    # the UVC epochs moved the architecture
    assert np.any(np.asarray(jc.s) > 0) and float(np.asarray(jc.z)) > 0


def _stage2_setup():
    params, teacher = _weights(1)
    s = jnp.array([[1.0, 32.0], [0.0, 32.0], [0.0, 32.0]])
    r = jnp.array([[0.0, 0.0], [2.0, 0.0], [0.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, JCFG)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [-1.0, 1.0],
                                        [1.0, -1.0]])
    return params, teacher, masks


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_run_stage2_matches_jax(tmp_path, jax_draws, compact):
    """One epoch of 3 steps (token drop, mixup, soft distillation, the
    lr scaled by batch / 512), with a validation at step 2: the trained
    (compact) params, the dense-layout checkpoint, the logged accuracy."""
    params, teacher, masks = _stage2_setup()
    # host copies first: JAX's compact step donates buffers that its
    # compact tree shares with the caller's params
    np_params, np_teacher, np_masks = _np(params), _np(teacher), _np(masks)
    jthp = jstate.TrainHParams(compute_dtype=jnp.float32, **THP2)
    tthp = tstate.TrainHParams(compute_dtype=torch.float32, **THP2)
    jtrain, jtest = _loaders(jpipe)
    jres = j_run_stage2(JCFG, JHParams(**HP2), jthp, params=params,
                        masks=masks, teacher_params=teacher,
                        train_loader=jtrain, test_loader=jtest, seed=SEED,
                        output_dir=str(tmp_path), name="jax", eval_every=2,
                        compact=compact)
    jax_draws(jax.random.PRNGKey(SEED), jthp)
    ttrain, ttest = _loaders(tpipe)
    tres = run_stage2(TCFG, THParams(**HP2), tthp,
                      params=params_from_numpy(np_params, device="cpu"),
                      masks=masks_from_numpy(np_masks, device="cpu"),
                      teacher_params=params_from_numpy(np_teacher,
                                                       device="cpu"),
                      train_loader=ttrain, test_loader=ttest, seed=SEED,
                      output_dir=str(tmp_path), name="port", eval_every=2,
                      compact=compact, device="cpu")
    assert tres.state.step == int(jres.state.step) == STEPS
    lr = THP2["learning_rate"] * BATCH / 512
    compare_params(tres.state.params, jres.state.params, bound=lr * STEPS)
    assert tres.best_acc == jres.best_acc
    _compare_metrics(tmp_path / "port" / "metrics.jsonl",
                     tmp_path / "jax" / "metrics.jsonl")
    name = f"{TCFG.name}_post_0.ckpt"
    ck = load_checkpoint(str(tmp_path / "port" / name))
    jck = j_load(str(tmp_path / "jax" / name))
    assert bool(ck["compact"]) == bool(jck["compact"]) == compact
    compare_params(ck["params"], jck["params"], bound=lr * STEPS)
    for k in ("epoch", "global_step", "key_seed"):
        assert int(ck[k]) == int(jck[k]), k
    assert float(ck["best_acc"]) == float(jck["best_acc"])


# ---------------------------------------------------------------------------
# resume (the port alone: the draws after a checkpoint come from its
# key_seed, so a resumed run repeats the uninterrupted one)
# ---------------------------------------------------------------------------


def _port_stage1(tmp_path, name, **kw):
    params, teacher = _weights()
    train, test = _loaders(tpipe)
    thp = tstate.TrainHParams(compute_dtype=torch.float32,
                              **dict(THP1, **kw.pop("thp", {})))
    return run_stage1(TCFG, THParams(**HP1), thp, train_loader=train,
                      test_loader=test,
                      params=params_from_numpy(_np(params), device="cpu"),
                      teacher_params=params_from_numpy(_np(teacher),
                                                       device="cpu"),
                      seed=SEED, output_dir=str(tmp_path), name=name,
                      device="cpu", **kw)


def _equal_trees(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


def _equal_cstates(a, b):
    for f in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("s_opt", "r_opt", "gating_opt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.count == y.count
        for m in ("m", "v"):
            u, v = getattr(x, m), getattr(y, m)
            assert (u is None and v is None) or torch.equal(u, v)


def test_stage1_resume_repeats_the_uninterrupted_run(tmp_path):
    """Resuming from the epoch-1 checkpoint restores step, params, AdamW
    state and cstate exactly, and the epoch-2 checkpoint it writes is the
    uninterrupted run's, byte for byte."""
    full = _port_stage1(tmp_path, "full")
    ck1 = str(tmp_path / "full" / f"{TCFG.name}_1.ckpt")
    # a resume with nothing left to train returns the checkpoint's state
    back = _port_stage1(tmp_path, "back", resume=ck1,
                        thp=dict(num_epochs=1))
    ck = load_checkpoint(ck1)
    assert back.state.step == int(ck["global_step"]) == STEPS
    _equal_trees(back.state.params, ck["params"])
    _equal_trees(tstate.opt_state_to_state_dict(back.state.opt_state)["0"]
                 ["mu"], ck["opt_state"]["0"]["mu"])
    _equal_trees(tstate.opt_state_to_state_dict(back.state.opt_state)["0"]
                 ["nu"], ck["opt_state"]["0"]["nu"])
    assert back.state.opt_state.count == int(ck["opt_state"]["0"]["count"])
    _equal_cstates(back.state.cstate,
                   tstate.cstate_from_state_dict(ck["cstate"], "cpu"))
    # past the end: the masks are still the real ones (rebuilt from the
    # restored cstate), so the inline stage 2 fine-tunes the compressed
    # model
    for k in ("attn", "mlp"):
        assert torch.equal(back.masks[k], ck["masks"][k])
    resumed = _port_stage1(tmp_path, "resumed", resume=ck1)
    assert resumed.state.step == full.state.step == 2 * STEPS
    _equal_trees(resumed.state.params, full.state.params)
    _equal_cstates(resumed.state.cstate, full.state.cstate)
    name = f"{TCFG.name}_2.ckpt"
    assert (tmp_path / "resumed" / name).read_bytes() == \
        (tmp_path / "full" / name).read_bytes()


def test_stage1_resume_from_a_checkpoint_directory(tmp_path):
    """``use_orbax`` keeps the checkpoints in a CheckpointManager
    directory; ``resume`` takes the directory (its latest step)."""
    full = _port_stage1(tmp_path, "dir", use_orbax=True)
    ckdir = tmp_path / "dir" / "checkpoints"
    assert sorted(p.name for p in ckdir.iterdir()) == ["1.ckpt", "2.ckpt"]
    back = _port_stage1(tmp_path, "dir_back", resume=str(ckdir))
    assert back.state.step == full.state.step
    _equal_trees(back.state.params, full.state.params)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_stage2_resume_repeats_the_uninterrupted_run(tmp_path, compact):
    params, teacher, masks = _stage2_setup()
    thp = tstate.TrainHParams(compute_dtype=torch.float32,
                              **dict(THP2, num_epochs=2))

    def run(name, **kw):
        train, test = _loaders(tpipe)
        return run_stage2(TCFG, THParams(**HP2), thp,
                          params=params_from_numpy(_np(params), device="cpu"),
                          masks=masks_from_numpy(_np(masks), device="cpu"),
                          teacher_params=params_from_numpy(_np(teacher),
                                                           device="cpu"),
                          train_loader=train, test_loader=test, seed=SEED,
                          output_dir=str(tmp_path), name=name, eval_every=0,
                          compact=compact, device="cpu", **kw)

    full = run("full")
    resumed = run("resumed", resume=str(
        tmp_path / "full" / f"{TCFG.name}_post_0.ckpt"))
    assert resumed.state.step == full.state.step == 2 * STEPS
    _equal_trees(resumed.state.params, full.state.params)
    _equal_trees(resumed.state.opt_state.mu, full.state.opt_state.mu)
    name = f"{TCFG.name}_post_1.ckpt"
    assert (tmp_path / "resumed" / name).read_bytes() == \
        (tmp_path / "full" / name).read_bytes()


def test_drivers_refuse_a_mesh(monkeypatch, tmp_path):
    """Stage 1 takes ``mp > 1`` (without a mesh ``mp`` is not read, as in
    the JAX drivers), a mesh whose model axis is not ``mp`` raises, and
    compact stage 2 on a mesh with a model axis raises JAX's ValueError; a
    data-parallel ``run_stage2`` scales its lr by the global batch (the
    loader's batch times the data-parallel ranks) / 512, as JAX's by
    ``batch_size * process_count``."""
    res = run_stage1(TCFG, THParams(), tstate.TrainHParams(num_epochs=0),
                     train_loader=[], test_loader=None, mp=2,
                     save_checkpoints=False, output_dir=str(tmp_path),
                     device="cpu")
    assert res.state.step == 0 and set(res.masks) == {"attn", "mlp"}
    with pytest.raises(ValueError, match=r"mp\(1\) is not the mesh's"):
        run_stage1(TCFG, THParams(), tstate.TrainHParams(), train_loader=[],
                   test_loader=None, mesh=Mesh(size=2, rank=0, mp=2),
                   device="cpu")
    with pytest.raises(ValueError, match="data-parallel meshes only"):
        run_stage2(TCFG, THParams(), tstate.TrainHParams(), params={},
                   masks={}, train_loader=[], test_loader=None,
                   mesh=Mesh(size=4, rank=0, mp=2), mp=2, compact=True,
                   device="cpu")

    class Built(Exception):
        pass

    def grab(cfg, hp, thp, **kw):
        raise Built(thp.learning_rate)

    monkeypatch.setattr(tstep, "build_stage2_step", grab)
    params = _weights()[0]
    tparams = params_from_numpy(_np(params), device="cpu")
    tmasks = {"attn": torch.ones(TCFG.depth, TCFG.embed_dim),
              "mlp": torch.ones(TCFG.depth, TCFG.mlp_hidden)}
    train, _ = _loaders(tpipe)
    lr = 1e-3
    for mesh, world_batch in ((None, None), (Mesh(size=4, rank=0), None),
                              (Mesh(size=4, rank=0), 64)):
        with pytest.raises(Built) as err:
            run_stage2(TCFG, THParams(), tstate.TrainHParams(
                learning_rate=lr), params=tparams, masks=tmasks,
                train_loader=train, test_loader=None, mesh=mesh,
                world_batch=world_batch, save_checkpoints=False,
                device="cpu")
        want = world_batch or train.batch_size * (mesh.size if mesh else 1)
        assert err.value.args[0] == pytest.approx(lr * want / 512.0)
