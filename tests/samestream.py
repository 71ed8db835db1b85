"""The port held to the JAX package on one set of initial weights and one
key chain, at the evidence harnesses' full size and horizon, on the CPU in
f32 (the ``slow`` cases of ``tests/test_torch_port_fidelity_recipe.py``),
and the JAX harnesses at other seeds.

A phase runs the JAX harness's own phase functions
(``scripts/trajectory_fidelity.py::run_pretrain`` / ``run_scenario_tiny``
/ ``run_scenario_below``, loaded by path and not changed; the e2e harness
``scripts/e2e_accuracy.py`` has one ``main``, so its dense pretrain and
stage 1 are JAX's ``run_stage1`` at the recipe the port's copy holds equal
to it), then the port's counterparts on JAX's initial weights
(``PRNGKey(seed)``'s init leaves through ``params_from_numpy``) and JAX's
key chain (``JaxChain`` of ``test_torch_port_drivers.py``). Both
packages' ``run_stage1`` are called through ``Recorder``, which passes
every argument on and asks for the per-epoch checkpoint besides (the
checkpoint draws nothing), so that each epoch's weights, minimax state and
masks can be held against each other.

Run one phase outside pytest as ``python tests/samestream.py <phase>
--dir <work dir>``: it writes ``<dir>/<phase>.json`` and merges it into
``<dir>/SAMESTREAM_cpu.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import fcntl
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import uvc_tpu.train.stage1 as jstage1  # noqa: E402
from uvc_tpu.compress.state import MinimaxHParams as JHP  # noqa: E402
from uvc_tpu.train.state import TrainHParams as JTHP  # noqa: E402
import uvc_tpu_torch.train.stage1 as tstage1  # noqa: E402
from uvc_tpu_torch.interop import params_from_numpy  # noqa: E402
from uvc_tpu_torch.scripts import e2e_accuracy as te2e  # noqa: E402
from uvc_tpu_torch.scripts import trajectory_fidelity as tfid  # noqa: E402
from uvc_tpu_torch.train import step as tstep  # noqa: E402
from uvc_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from seed_spread import offset_seeds  # noqa: E402

STATE_TOL = 1e-4
# a weight farther from its counterpart than this has parted (one ulp of
# the init grows past it within 20 pretrain steps: ``pretrain_steps``)
LEAF_TOL = 1e-4
CSTATE_FIELDS = ("s", "r", "y", "p", "z", "gating_accum")
# the e2e run whose stage 1 failed A6 on the card (E2EACC_h100_seed1.json)
E2E_SEED = 1


def load_harness(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfid = load_harness("trajectory_fidelity")
je2e = load_harness("e2e_accuracy")


class Recorder:
    """Stands in for a package's ``run_stage1``: the call goes through with
    ``save_checkpoints=checkpoints`` and, where the caller passes no
    weights, ``init`` as the start; each result is kept by its run's
    name."""

    def __init__(self, fn, init=None, checkpoints=True):
        self.fn, self.init, self.checkpoints = fn, init, checkpoints
        self.results = {}

    def __call__(self, *args, **kw):
        kw["save_checkpoints"] = self.checkpoints
        if kw.get("params") is None and self.init is not None:
            kw["params"] = self.init
        res = self.fn(*args, **kw)
        self.results[kw["name"]] = res
        return res


@contextlib.contextmanager
def patched(pairs):
    """Set ``(module, name, value)`` attributes; restore them on exit."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    try:
        for m, n, v in pairs:
            setattr(m, n, v)
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


def jax_chain(seed, jthp):
    """The port's three draw functions walking the chain that JAX's
    ``run_stage1(seed=seed)`` walks (after its init split)."""
    from test_torch_port_drivers import JaxChain

    chain = JaxChain(jax.random.split(jax.random.PRNGKey(seed))[0], jthp)
    return [(tstep, "draw_stage1_noise", chain.stage1),
            (tstep, "draw_stage2_noise", chain.stage2),
            (tstage1, "draw_report_noise", chain.report)]


def jax_init(cfg, seed, hp):
    """The weights JAX's ``run_stage1(seed=seed)`` draws when given none."""
    from uvc_tpu.models import get_model

    _, k_init = jax.random.split(jax.random.PRNGKey(seed))
    return get_model(cfg).init_params(
        k_init, cfg, patch_gating=hp.enable_patch_gating == 1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {prefix: np.asarray(tree.float().numpy() if torch.is_tensor(tree)
                               else tree, np.float64)}


def read_run(out, name):
    """A run's epoch reports and validations from its ``metrics.jsonl``."""
    rep = {"step": [], "real": [], "exp": [], "argmax": [], "z": [],
           "acc": []}
    with open(os.path.join(out, name, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if "train/flops_real" in rec:
                rep["step"].append(rec["step"])
                rep["real"].append(rec["train/flops_real"])
                rep["exp"].append(rec["train/flops_expectation"])
                rep["argmax"].append(rec.get("train/flops_real_argmax",
                                             rec["train/flops_real"]))
                rep["z"].append(rec.get("train/z", 0.0))
            if "test/accuracy" in rec:
                rep["acc"].append(rec["test/accuracy"])
    return rep


def compare_epochs(jdir, tdir, name, cfg_name, epochs):
    """Epoch by epoch: the decisions (masks, the argmax gating, the Real and
    argmax FLOPs reports) and how far the weights (each leaf's largest
    difference) and the minimax state lie apart, from both runs'
    checkpoints and logs (see ``parting``)."""
    jr, tr = read_run(jdir, name), read_run(tdir, name)
    rows = []
    for e in range(1, epochs + 1):
        jck = load_checkpoint(os.path.join(jdir, name, f"{cfg_name}_{e}.ckpt"))
        tck = load_checkpoint(os.path.join(tdir, name, f"{cfg_name}_{e}.ckpt"))
        jp, tp = _flat(jck["params"]), _flat(tck["params"])
        assert set(jp) == set(tp)
        dl = {k: float(np.max(np.abs(jp[k] - tp[k]))) for k in jp}
        worst = max(dl, key=dl.get)
        jc, tc = _flat(jck["cstate"]), _flat(tck["cstate"])
        ds = {f: float(np.max(np.abs(jc[(f,)] - tc[(f,)])))
              for f in CSTATE_FIELDS if (f,) in jc}
        js = {f: float(np.max(np.abs(jc[(f,)])))
              for f in CSTATE_FIELDS if (f,) in jc}
        jm, tm = _flat(jck["masks"]), _flat(tck["masks"])
        masks_equal = all(np.array_equal(jm[k], tm[k]) for k in jm)
        g_j = jp[("block_gating",)] if ("block_gating",) in jp else None
        keep_equal = (g_j is None or np.array_equal(
            g_j[:, 1] > g_j[:, 0],
            tp[("block_gating",)][:, 1] > tp[("block_gating",)][:, 0]))
        i = e - 1
        reports_equal = all(abs(jr[k][i] - tr[k][i]) <= 1e-6
                            for k in ("real", "argmax"))
        rows.append({
            "epoch": e, "step": jr["step"][i],
            "max_param_diff": dl[worst], "worst_leaf": "/".join(worst),
            "leaves_past_tol": sum(d > LEAF_TOL for d in dl.values()),
            "state_diff": ds, "state_scale": js,
            "masks_equal": masks_equal, "argmax_gating_equal": keep_equal,
            "reports_equal": reports_equal,
            "acc": [jr["acc"][i], tr["acc"][i]],
            "real": [jr["real"][i], tr["real"][i]],
            "argmax": [jr["argmax"][i], tr["argmax"][i]],
            "exp": [jr["exp"][i], tr["exp"][i]],
            "z": [jr["z"][i], tr["z"][i]]})
    return rows, jr, tr


DECISIONS = ("masks_equal", "argmax_gating_equal", "reports_equal")


def parting(rows, decisions=True):
    """The first epoch at which the runs part, and what parted there: a
    weight beyond ``LEAF_TOL`` of its counterpart ("weights"), a field of
    the minimax state beyond 1e-4 of its scale (which a decision flipped
    inside the epoch causes: a step's ``ceil`` of s or r changes the dual
    ascent's sum, and y or p jumps by the learning rate times a score),
    or, with ``decisions``, an epoch-end decision (the masks, the argmax
    gating, the Real / argmax reports).  ``(None, [])`` if they never
    part."""
    for row in rows:
        by = [k for k in DECISIONS if decisions and not row[k]]
        by += ["weights"] * (row["leaves_past_tol"] > 0)
        by += [f for f, d in row["state_diff"].items()
               if d > STATE_TOL * (1.0 + row["state_scale"][f])]
        if by:
            return row["epoch"], by
    return None, []


def summarize(res):
    """Set ``res``'s first parting epoch and what parted there, the first
    parting of the numbers alone (weights, state), and the first epoch-end
    decision that differs, from its rows."""
    rows = res["epochs"]
    res["first_parting_epoch"], res["parted_by"] = parting(rows)
    res["first_number_parting_epoch"] = parting(rows, decisions=False)[0]
    res["first_decision_parting_epoch"] = next(
        (r["epoch"] for r in rows if not all(r[k] for k in DECISIONS)),
        None)
    return res


def _fid_loaders(mod):
    """One loader per phase at the harness's seeds (0 / 10 / 11, test 99;
    within ``offset_seeds``, moved)."""
    return {"pretrain": mod.TextureLoader(mod.BATCH, mod.STEPS, seed=0),
            "tiny": mod.TextureLoader(mod.BATCH, mod.STEPS, seed=10),
            "below": mod.TextureLoader(mod.BATCH, mod.STEPS, seed=11),
            "test": mod.TextureLoader(mod.BATCH, tfid.EVAL_BATCHES, seed=99)}


def jax_dense(work, offset=0):
    """JAX's fidelity pretrain with its seeds moved by ``offset`` (through
    the harness's own pickle cache in ``work``): (cfg, dtype, dense, acc,
    from the cache)."""
    out = os.path.join(work, f"jax_pre{offset}")
    with offset_seeds(offset, jfid, jstage1):
        ld = _fid_loaders(jfid)
        with patched([(jstage1, "run_stage1", Recorder(jstage1.run_stage1))]):
            return jfid.run_pretrain(
                out, ld["pretrain"], ld["test"],
                cache=os.path.join(work, f"jax_dense{offset}.pkl"))


class _Stop(Exception):
    """Ends a traced run after its last kept step."""


class StepTrace:
    """Stands in for a package's ``build_stage1_step``: every step function
    it builds goes through, and the weights after the steps in ``at`` (one
    count over all the functions built) are kept flat, in f64; the run
    stops with ``_Stop`` after the last of them."""

    def __init__(self, build, at):
        self.build, self.at, self.params, self.n = build, sorted(at), {}, 0

    def __call__(self, *args, **kw):
        fn = self.build(*args, **kw)

        def step(state, *rest):
            out = fn(state, *rest)
            self.n += 1
            if self.n in self.at:
                self.params[self.n] = _flat(out[0].params)
                if self.n == self.at[-1]:
                    raise _Stop
            return out
        return step


def _ulp(tree):
    """``tree`` with every float32 weight one ulp up."""
    return jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), tree)


def _jax_fid_config():
    from uvc_tpu.configs import get_config

    return get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=jfid.IMG, num_classes=jfid.CLASSES)


def trace_run(pkg, start, work, tag, at, which="pretrain"):
    """The fidelity harness's ``which`` phase ("pretrain", "tiny" or
    "below") of ``pkg`` ("jax" or "port", the port on JAX's chain) from the
    numpy weights ``start`` (the pretrain's init, or a scenario's dense
    model), stopped after step ``max(at)``: the weights after each step of
    ``at``."""
    out = os.path.join(work, f"trace_{tag}")
    if pkg == "jax":
        mod, stage1, kw = jfid, jstage1, {}
        trace = StepTrace(jstage1.build_stage1_step, at)
        pairs = [(jstage1, "build_stage1_step", trace)]
        weights = jax.tree.map(jnp.asarray, start)
        cfg, dtype = _jax_fid_config(), jnp.float32
    else:
        mod, stage1, kw = tfid, tstage1, {"device": "cpu"}
        trace = StepTrace(tstep.build_stage1_step, at)
        jthp = (tfid._pretrain_thp(JTHP, jnp.float32) if which == "pretrain"
                else tfid._thp(JTHP, *{"tiny": (tfid.EPOCHS, tfid.WARMUP),
                                       "below": (tfid.EPOCHS_BELOW, 0)}[which],
                               jnp.float32))
        pairs = jax_chain(0, jthp) + [(tstep, "build_stage1_step", trace)]
        weights = params_from_numpy(start, "cpu")
        cfg, dtype = tfid._make_config(), torch.float32
    ld = _fid_loaders(mod)
    if which == "pretrain":
        pairs.append((stage1, "run_stage1", Recorder(
            stage1.run_stage1, checkpoints=False, init=weights)))
    with patched(pairs):
        try:
            if which == "pretrain":
                mod.run_pretrain(out, ld["pretrain"], ld["test"], **kw)
            else:
                getattr(mod, f"run_scenario_{which}")(
                    out, cfg, dtype, weights, ld[which], ld["test"], **kw)
        except _Stop:
            pass
    assert sorted(trace.params) == sorted(at), (pkg, sorted(trace.params))
    return trace.params


def leaf_diffs(a, b, at):
    """Per kept step: the largest difference of any weight, the leaf that
    holds it, the Frobenius norm of the difference over that of the
    weights, and the leaves whose largest difference passes ``LEAF_TOL``
    (largest first)."""
    rows = []
    for n in at:
        d = {k: float(np.max(np.abs(a[n][k] - b[n][k]))) for k in a[n]}
        num = sum(float(np.sum((a[n][k] - b[n][k]) ** 2)) for k in a[n])
        den = sum(float(np.sum(a[n][k] ** 2)) for k in a[n])
        worst = max(d, key=d.get)
        past = sorted((k for k in d if d[k] > LEAF_TOL), key=d.get,
                      reverse=True)
        rows.append({"step": n, "max": d[worst], "worst_leaf": "/".join(worst),
                     "rel_fro": (num / den) ** 0.5,
                     "leaves_past_tol": {"/".join(k): d[k] for k in past}})
    return rows


PRETRAIN_AT = (1, 2, 3, 5, 10, 20, 50, 100)
SCENARIO_AT = (1, 2, 5, 10, 20, 50, 100, 150, 200)


def phase_steps(work, which, at):
    """A phase's first steps, weight by weight: JAX against the port on
    JAX's chain from one start (the pretrain: JAX's ``PRNGKey(0)``
    weights; a scenario: JAX's dense model from the pretrain phase),
    beside two witnesses of how fast float noise alone grows there, each
    package against itself from the start one ulp up."""
    if which == "pretrain":
        start = _np_tree(jax_init(tfid._make_config(), 0, JHP(
            enable_patch_gating=0, enable_pruning=False)))
    else:
        start = _np_tree(jax_dense(work)[2])
    t = time.time()
    runs = {}
    for pkg in ("jax", "port"):
        runs[pkg] = trace_run(pkg, start, work, f"{which}_{pkg}", at, which)
        runs[pkg + "_ulp"] = trace_run(pkg, _ulp(start), work,
                                       f"{which}_{pkg}_ulp", at, which)
    return {"phase": f"{which}_steps", "steps": list(at),
            "leaf_tol": LEAF_TOL,
            "pairs": {"jax_vs_port": leaf_diffs(runs["jax"], runs["port"], at),
                      "jax_vs_jax_ulp": leaf_diffs(runs["jax"],
                                                   runs["jax_ulp"], at),
                      "port_vs_port_ulp": leaf_diffs(runs["port"],
                                                     runs["port_ulp"], at)},
            "wall_s": time.time() - t}


def _gates(g):
    return {k: bool(v) for k, v in g.items()}


def phase_pretrain(work):
    """(a) The fidelity pretrain from JAX's ``PRNGKey(0)`` weights: 5
    epochs of 100 steps, no mixup, no drop: each package's accuracy."""
    jdir, tdir = os.path.join(work, "jax_pre0"), os.path.join(work, "port_pre")
    t = time.time()
    cfg, _, _, jacc, cached = jax_dense(work)
    assert not cached, "the pretrain phase trains JAX's dense model itself"
    jsec = time.time() - t
    init = _np_tree(jax_init(cfg, 0, JHP(enable_patch_gating=0,
                                          enable_pruning=False)))
    jthp = tfid._pretrain_thp(JTHP, jnp.float32)
    ld = _fid_loaders(tfid)
    rec = Recorder(tstage1.run_stage1, init=params_from_numpy(init, "cpu"))
    t = time.time()
    with patched(jax_chain(0, jthp) + [(tstage1, "run_stage1", rec)]):
        _, _, _, tacc, _ = tfid.run_pretrain(tdir, ld["pretrain"], ld["test"],
                                             device="cpu")
    tsec = time.time() - t
    rows, jr, tr = compare_epochs(jdir, tdir, "pretrain", cfg.name,
                                  tfid.PRETRAIN_EPOCHS)
    return summarize({
        "phase": "pretrain", "jax": {"acc": jr["acc"], "best_acc": jacc},
        "port": {"acc": tr["acc"], "best_acc": tacc}, "epochs": rows,
        "wall_s": {"jax": jsec, "port": tsec}})


def phase_pretrain_ulp(work):
    """A witness at the pretrain's whole horizon: JAX's fidelity pretrain
    from JAX's ``PRNGKey(0)`` weights one ulp up, epoch by epoch against
    the pretrain phase's JAX run (``jax_pre0``): how far JAX parts from
    itself over the 500 steps."""
    cfg = tfid._make_config()
    init = _np_tree(jax_init(cfg, 0, JHP(enable_patch_gating=0,
                                          enable_pruning=False)))
    jdir, udir = (os.path.join(work, "jax_pre0"),
                  os.path.join(work, "jax_pre_ulp"))
    ld = _fid_loaders(jfid)
    rec = Recorder(jstage1.run_stage1,
                   init=jax.tree.map(jnp.asarray, _ulp(init)))
    t = time.time()
    with patched([(jstage1, "run_stage1", rec)]):
        _, _, _, uacc, _ = jfid.run_pretrain(udir, ld["pretrain"], ld["test"])
    rows, jr, ur = compare_epochs(jdir, udir, "pretrain", cfg.name,
                                  tfid.PRETRAIN_EPOCHS)
    return summarize({
        "phase": "pretrain_ulp", "jax": {"acc": jr["acc"]},
        "jax_ulp": {"acc": ur["acc"], "best_acc": uacc}, "epochs": rows,
        "wall_s": time.time() - t})


def _scenario(work, which):
    # JAX's fidelity pretrain (the pretrain phase's cache, else trained
    # here): the one start of both packages' scenarios
    cfg, jdtype, dense, pre_acc, _ = jax_dense(work)
    dense = _np_tree(dense)
    jrun = {"tiny": jfid.run_scenario_tiny,
            "below": jfid.run_scenario_below}[which]
    trun = {"tiny": tfid.run_scenario_tiny,
            "below": tfid.run_scenario_below}[which]
    name = {"tiny": "tinyshape", "below": "below"}[which]
    epochs = {"tiny": tfid.EPOCHS, "below": tfid.EPOCHS_BELOW}[which]
    jdir, tdir = (os.path.join(work, f"jax_{which}"),
                  os.path.join(work, f"port_{which}"))
    ld = _fid_loaders(jfid)
    t = time.time()
    rec = Recorder(jstage1.run_stage1)
    with patched([(jstage1, "run_stage1", rec)]):
        jg, jp = jrun(jdir, cfg, jdtype, jax.tree.map(jnp.asarray, dense),
                      ld[which], ld["test"])
    jsec = time.time() - t
    tcfg = tfid._make_config()
    jthp = tfid._thp(JTHP, epochs, tfid.WARMUP if which == "tiny"
                     else 0, jnp.float32)
    tl = _fid_loaders(tfid)
    rec_t = Recorder(tstage1.run_stage1)
    t = time.time()
    with patched(jax_chain(0, jthp) + [(tstage1, "run_stage1", rec_t)]):
        tg, tp = trun(tdir, tcfg, torch.float32,
                      params_from_numpy(dense, "cpu"), tl[which], tl["test"],
                      device="cpu")
    tsec = time.time() - t
    rows, _, _ = compare_epochs(jdir, tdir, name, cfg.name, epochs)
    return summarize({"phase": which, "pretrain_acc": pre_acc,
                      "jax": {"gates": _gates(jg), **jp},
                      "port": {"gates": _gates(tg), **tp}, "epochs": rows,
                      "wall_s": {"jax": jsec, "port": tsec}})


def phase_tiny(work):
    """(b) Scenario "tiny", 15 epochs of 100 steps, from JAX's dense."""
    return _scenario(work, "tiny")


def phase_below(work):
    """(c) Scenario "below", 12 epochs of 100 steps, from JAX's dense."""
    return _scenario(work, "below")


def _e2e_loaders(pipe, seed):
    kw = dict(img_size=te2e.IMG, num_classes=te2e.CLASSES, seed=seed,
              **te2e.HARD)
    return (pipe.ProceduralLoader(te2e.BATCH, num_batches=te2e.STEPS,
                                  train=True, **kw),
            pipe.ProceduralLoader(te2e.BATCH, num_batches=te2e.EVAL_BATCHES,
                                  train=False, **kw))


def _a3_a6(real, keep, frac):
    tail = float(np.mean(real[-3:]))
    return {"real_flops_final": tail, "compact_flops_fraction": frac,
            "blocks_kept": int(keep.sum()),
            "A3 stage-1 real FLOPs <= 0.62": tail <= 0.62,
            "A6 compact FLOPs <= real + 0.05": frac <= tail + 0.05}


def _jax_e2e(work, seed, checkpoints=True):
    """JAX's e2e run at ``seed`` through stage 1: the dense pretrain with
    its extension loop (``scripts/e2e_accuracy.py``), then stage 1 from
    that dense model, the teacher that model too.  Returns the dense
    model, its accuracy and epochs, stage 1's log and A3 / A6 (A6's compact
    FLOPs from stage 1's masks and argmax gating, which stage 2 keeps
    frozen), and the seconds of each part."""
    from uvc_tpu.configs import get_config
    from uvc_tpu.data import pipeline as jpipe
    from uvc_tpu.infer import compact as jcompact

    cfg = get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=te2e.IMG, num_classes=te2e.CLASSES)
    recipe = te2e.recipe()
    jdir = os.path.join(work, f"jax_e2e{seed}")
    train, test = _e2e_loaders(jpipe, seed)
    t = time.time()
    hp_kw, thp_kw = recipe["pretrain"]
    hp_pre, thp_pre = JHP(**hp_kw), JTHP(compute_dtype=jnp.float32, **thp_kw)
    pre = jstage1.run_stage1(cfg, hp_pre, thp_pre, train_loader=train,
                             test_loader=test, seed=seed, output_dir=jdir,
                             name="dense", save_checkpoints=False)
    dense = jax.tree.map(jnp.copy, pre.state.params)
    dense_acc = je2e.masked_dense_accuracy(dense, None, cfg, test)
    total_ep = te2e.PRETRAIN_EPOCHS
    while dense_acc < te2e.DENSE_TARGET and total_ep < te2e.DENSE_EPOCHS_MAX:
        cont = jstage1.run_stage1(
            cfg, hp_pre, dataclasses.replace(
                thp_pre, t_total=2 * te2e.STEPS, num_epochs=2,
                warmup_epochs=2),
            train_loader=te2e._EpochOffset(train, total_ep),
            test_loader=test, params=dense, seed=seed + total_ep,
            output_dir=jdir, name=f"dense_ext{total_ep}",
            save_checkpoints=False)
        dense = jax.tree.map(jnp.copy, cont.state.params)
        dense_acc = je2e.masked_dense_accuracy(dense, None, cfg, test)
        total_ep += 2
    dense_np = _np_tree(dense)
    dsec = time.time() - t

    hp_kw, thp_kw = recipe["stage1"]
    t = time.time()
    j1 = jstage1.run_stage1(
        cfg, JHP(**hp_kw), JTHP(compute_dtype=jnp.float32, **thp_kw),
        train_loader=train, test_loader=test, params=dense,
        teacher_params=dense, seed=seed, output_dir=jdir, name="stage1",
        save_checkpoints=checkpoints)
    jsec = time.time() - t
    jr = read_run(jdir, "stage1")
    jp = _np_tree(j1.state.params)
    keep = jp["block_gating"][:, 1] > jp["block_gating"][:, 0]
    layers, _ = jcompact.compact_model(jp, j1.masks, cfg, block_keep=keep)
    jsum = _a3_a6(jr["real"], keep,
                  float(jcompact.compact_flops_fraction(layers, cfg)))
    return {"dense_np": dense_np, "dense_acc": dense_acc,
            "dense_epochs": total_ep, "log": jr, "gates": jsum,
            "secs": {"jax_dense": dsec, "jax": jsec}}


_SERIES = ("real", "exp", "argmax", "z", "acc")


def phase_e2e_stage1(work, seed=E2E_SEED):
    """(d) The e2e harness at ``seed``: JAX's dense pretrain and stage 1
    (``_jax_e2e``), then the port's stage 1 from the same dense model on
    JAX's chain; A3 and A6 of each."""
    from uvc_tpu_torch.compress.state import MinimaxHParams as THP
    from uvc_tpu_torch.data import pipeline as tpipe
    from uvc_tpu_torch.infer import compact as tcompact
    from uvc_tpu_torch.train.state import TrainHParams as TTHP

    j = _jax_e2e(work, seed)
    hp_kw, thp_kw = te2e.recipe()["stage1"]
    tdir = os.path.join(work, f"port_e2e{seed}")
    ttrain, ttest = _e2e_loaders(tpipe, seed)
    jthp = JTHP(compute_dtype=jnp.float32, **thp_kw)
    tdense = params_from_numpy(j["dense_np"], "cpu")
    t = time.time()
    with patched(jax_chain(seed, jthp)):
        t1 = tstage1.run_stage1(
            te2e.make_config(), THP(**hp_kw),
            TTHP(compute_dtype=torch.float32, **thp_kw),
            train_loader=ttrain, test_loader=ttest, params=tdense,
            teacher_params=tdense, seed=seed, output_dir=tdir, name="stage1",
            device="cpu")
    tsec = time.time() - t
    tcfg = te2e.make_config()
    rows, jr, tr = compare_epochs(
        os.path.join(work, f"jax_e2e{seed}"), tdir, "stage1", tcfg.name,
        te2e.EPOCHS)
    g = t1.state.params["block_gating"].float().numpy()
    keep = g[:, 1] > g[:, 0]
    layers, _ = tcompact.compact_model(t1.state.params, t1.masks, tcfg,
                                       block_keep=keep, device="cpu")
    tsum = _a3_a6(tr["real"], keep,
                  float(tcompact.compact_flops_fraction(layers, tcfg)))
    return summarize({
        "phase": f"e2e_seed{seed}_stage1", "dense_acc": j["dense_acc"],
        "dense_epochs": j["dense_epochs"],
        "jax": {"series": {k: jr[k] for k in _SERIES}, **j["gates"]},
        "port": {"series": {k: tr[k] for k in _SERIES}, **tsum},
        "epochs": rows, "wall_s": dict(j["secs"], port=tsec)})


def phase_jax_e2e(work, seed):
    """JAX's e2e run at ``seed`` through stage 1 alone (``_jax_e2e``): A3
    and A6, to count how often JAX passes A6 at seeds the port ran on the
    card."""
    j = _jax_e2e(work, seed, checkpoints=False)
    return {"phase": f"jax_e2e{seed}", "seed": seed,
            "dense_acc": j["dense_acc"], "dense_epochs": j["dense_epochs"],
            "jax": {"series": {k: j["log"][k] for k in _SERIES},
                    **j["gates"]},
            "wall_s": j["secs"]}


def phase_jax_spread(work, offset):
    """The JAX fidelity harness's pretrain and both scenarios with every
    seed (``run_stage1``'s, the loaders') moved by ``offset``: its
    gates."""
    cfg, dtype, dense, acc, _ = jax_dense(work, offset)
    t = time.time()
    res = {"phase": f"jax_spread{offset}", "offset": offset,
           "pretrain_acc": acc, "gates": {}}
    with offset_seeds(offset, jfid, jstage1):
        ld = _fid_loaders(jfid)
        rec = Recorder(jstage1.run_stage1, checkpoints=False)
        with patched([(jstage1, "run_stage1", rec)]):
            for which in ("tiny", "below"):
                g, p = getattr(jfid, f"run_scenario_{which}")(
                    os.path.join(work, f"jax_{which}{offset}"), cfg, dtype,
                    dense, ld[which], ld["test"])
                res["gates"].update(_gates(g))
                res[which] = p
    res["wall_s"] = time.time() - t
    return res


def phase_port_pretrain(work, offset):
    """The port's fidelity pretrain from its own generator's weights (not
    JAX's), every seed moved by ``offset``, on the CPU in f32: its
    accuracy, beside JAX's from ``PRNGKey`` weights at the same offset."""
    out = os.path.join(work, f"port_pre_own{offset}")
    t = time.time()
    with offset_seeds(offset, tfid, tstage1):
        ld = _fid_loaders(tfid)
        rec = Recorder(tstage1.run_stage1, checkpoints=False)
        with patched([(tstage1, "run_stage1", rec)]):
            _, _, _, acc, _ = tfid.run_pretrain(out, ld["pretrain"],
                                                ld["test"], device="cpu")
    return {"phase": f"port_pretrain{offset}", "offset": offset,
            "acc": read_run(out, "pretrain")["acc"], "best_acc": acc,
            "wall_s": time.time() - t}


# each phase's runs: (first run's dir, second's, run name, config, epochs)
RUNS = {
    "pretrain": ("jax_pre0", "port_pre", "pretrain", "fid",
                 "PRETRAIN_EPOCHS"),
    "pretrain_ulp": ("jax_pre0", "jax_pre_ulp", "pretrain", "fid",
                     "PRETRAIN_EPOCHS"),
    "tiny": ("jax_tiny", "port_tiny", "tinyshape", "fid", "EPOCHS"),
    "below": ("jax_below", "port_below", "below", "fid", "EPOCHS_BELOW"),
    "e2e_stage1": (f"jax_e2e{E2E_SEED}", f"port_e2e{E2E_SEED}", "stage1",
                   "e2e", "EPOCHS")}


def recompare(work, phase):
    """Compare ``phase``'s runs in ``work`` again from their checkpoints
    and logs (the rows and the parting, the rest of the result kept)."""
    jdir, tdir, name, which, epochs = RUNS[phase]
    mod = tfid if which == "fid" else te2e
    cfg = tfid._make_config() if which == "fid" else te2e.make_config()
    with open(os.path.join(work, f"{phase}.json")) as fh:
        res = json.load(fh)
    res["epochs"], _, _ = compare_epochs(
        os.path.join(work, jdir), os.path.join(work, tdir), name, cfg.name,
        getattr(mod, epochs))
    return summarize(res)


PHASES = {"pretrain": phase_pretrain, "tiny": phase_tiny,
          "below": phase_below, "e2e_stage1": phase_e2e_stage1,
          "pretrain_steps": lambda w: phase_steps(w, "pretrain",
                                                  PRETRAIN_AT),
          "tiny_steps": lambda w: phase_steps(w, "tiny", SCENARIO_AT),
          "below_steps": lambda w: phase_steps(w, "below", SCENARIO_AT),
          "pretrain_ulp": phase_pretrain_ulp}


def run_phase(phase, work, again=False):
    """Run ``phase`` (a name of PHASES, ``spread<offset>``,
    ``jax_e2e<seed>`` or ``port_pretrain<offset>``) in ``work`` (``again``:
    compare its runs there again, ``recompare``); write ``<work>/<phase>.json`` and merge it into
    ``<work>/SAMESTREAM_cpu.json``.  Returns the phase's result."""
    os.makedirs(work, exist_ok=True)
    if again:
        res = recompare(work, phase)
    elif phase.startswith("spread"):
        res = phase_jax_spread(work, int(phase[len("spread"):]))
    elif phase.startswith("jax_e2e"):
        res = phase_jax_e2e(work, int(phase[len("jax_e2e"):]))
    elif phase.startswith("port_pretrain"):
        res = phase_port_pretrain(work, int(phase[len("port_pretrain"):]))
    else:
        res = PHASES[phase](work)
    with open(os.path.join(work, f"{phase}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    path = os.path.join(work, "SAMESTREAM_cpu.json")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        doc = {}
        if os.path.exists(path):
            with open(path) as fh:
                doc = json.load(fh)
        doc.setdefault("phases", {})[phase] = res
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("phase")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--again", action="store_true",
                    help="compare the phase's runs in --dir again")
    opts = ap.parse_args()
    r = run_phase(opts.phase, opts.dir, opts.again)
    print(json.dumps({k: v for k, v in r.items() if k != "epochs"}))
