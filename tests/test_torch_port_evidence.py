"""The port's evidence harnesses (uvc_tpu_torch/scripts/e2e_accuracy.py,
scripts/trajectory_fidelity.py) against the JAX package's
(scripts/e2e_accuracy.py, scripts/trajectory_fidelity.py, loaded by path
without being changed), on the CPU.

Held exactly: ``TextureLoader``'s batches (bit for bit), the accuracy
helpers' hit counts on one set of weights and one loader split (the
masked-dense oracle in f32 as both harnesses run it on the CPU, the compact
model in bf16 as JAX's ``apply_compact`` defaults to), the series readers,
scenario "below"'s start, and the gate functions on the committed TPU
records (``E2EACC_r05*.json``, ``FIDELITY_r05.json``), which must come out
as the records' own ``gates``, and false on a perturbed input.
"""

from torch_port_env import capped_threads  # noqa: F401  (autouse)
import ast
import importlib.util
import json
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvc_tpu.configs as jconfigs
from uvc_tpu.compress import masks as jmasks
from uvc_tpu.compress.minimax import init_compression_state as j_init_cs
from uvc_tpu.compress.state import MinimaxHParams as JHParams
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu.infer import compact as jcompact
from uvc_tpu.models import vit as jvit
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.compress.state import MinimaxHParams as THParams
from uvc_tpu_torch.data import pipeline as tpipe
from uvc_tpu_torch.infer import compact as tcompact
from uvc_tpu_torch.interop import masks_from_numpy, params_from_numpy
from uvc_tpu_torch.scripts import e2e_accuracy as te2e
from uvc_tpu_torch.scripts import trajectory_fidelity as tfid
from uvc_tpu_torch.train import state as tstate

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


je2e = _load("e2e_accuracy")
jfid = _load("trajectory_fidelity")


def _record(name):
    return json.loads((REPO / name).read_text())


def test_constants_and_record_keys_are_jaxs():
    for k in ("EPOCHS", "WARMUP", "PRETRAIN_EPOCHS", "STAGE2_EPOCHS",
              "STEPS", "BATCH", "CLASSES", "IMG", "TOKEN_RATIO", "HARD"):
        assert getattr(te2e, k) == getattr(je2e, k), k
    for k in ("EPOCHS", "WARMUP", "EPOCHS_BELOW", "PRETRAIN_EPOCHS",
              "STEPS", "BATCH", "CLASSES", "IMG"):
        assert getattr(tfid, k) == getattr(jfid, k), k
    assert set(te2e.RECORD_KEYS) == set(_record("E2EACC_r05.json"))
    # the JAX harness writes "pretrain_from_cache" since after its r05 run
    assert set(tfid.RECORD_KEYS) == set(_record("FIDELITY_r05.json")) | {
        "pretrain_from_cache"}
    assert tfid._uvc_hp(THParams).__dict__ == jfid._uvc_hp(JHParams).__dict__


def _jax_kwargs(script, function):
    """The keyword arguments of each MinimaxHParams / TrainHParams call
    assigned in ``function`` of the JAX ``script``, by target name,
    evaluated at the script's constants (compute_dtype left out: the
    device's)."""
    mod = {"e2e_accuracy": je2e, "trajectory_fidelity": jfid}[script]
    tree = ast.parse((REPO / "scripts" / f"{script}.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    consts = {k: getattr(mod, k) for k in dir(mod) if k.isupper()}
    calls = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) in (
                    "MinimaxHParams", "TrainHParams")):
            calls[node.targets[0].id] = {
                kw.arg: eval(compile(ast.Expression(kw.value), script,
                                     "eval"), consts)
                for kw in node.value.keywords if kw.arg != "compute_dtype"}
    return calls


def test_recipes_are_jaxs():
    """Every hyperparameter of every stage of both harnesses."""
    calls = _jax_kwargs("e2e_accuracy", "main")
    assert te2e.recipe() == {"pretrain": (calls["hp_pre"], calls["thp_pre"]),
                             "stage1": (calls["hp"], calls["thp"]),
                             "stage2": (calls["hp"], calls["thp2"])}
    tthp = tstate.TrainHParams
    for function, port in (
            ("run_pretrain", tfid._pretrain_thp(tthp, torch.float32)),
            ("run_scenario_tiny", tfid._thp(tthp, tfid.EPOCHS, tfid.WARMUP,
                                            torch.float32)),
            ("run_scenario_below", tfid._thp(tthp, tfid.EPOCHS_BELOW, 0,
                                             torch.float32))):
        calls = _jax_kwargs("trajectory_fidelity", function)
        want = calls["thp_pre" if function == "run_pretrain" else "thp"]
        assert {k: getattr(port, k) for k in want} == want, function
    assert _jax_kwargs("trajectory_fidelity", "run_pretrain")["hp_pre"] == \
        dict(enable_patch_gating=0, enable_pruning=False)
    assert (te2e.DENSE_TARGET, te2e.DENSE_EPOCHS_MAX) == (0.75, 13)
    assert "while dense_acc < 0.75 and total_ep < 13:" in (
        REPO / "scripts" / "e2e_accuracy.py").read_text()


@pytest.mark.parametrize("seed", [0, 10, 99])
def test_texture_loader_is_jaxs(seed):
    jl, tl = jfid.TextureLoader(16, 3, seed=seed), tfid.TextureLoader(
        16, 3, seed=seed)
    assert len(jl) == len(tl) == 3
    for (jx, jy), (tx, ty) in zip(jl, tl):
        assert jx.dtype == tx.dtype == np.uint8
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)


JCFG = jconfigs.get_config("deit_tiny_distilled_patch16_224").replace(
    img_size=32, num_classes=50, depth=2)
TCFG = tconfigs.get_config("deit_tiny_distilled_patch16_224").replace(
    img_size=32, num_classes=50, depth=2)


def _model():
    """A 2-block DeiT-Tiny at 32 px: a non-zero head, head 0 of block 0
    and within-head dims of block 1 pruned, MLP units pruned, block 1
    gated off."""
    params = jvit.init_params(jax.random.PRNGKey(4), JCFG)
    rng = np.random.default_rng(4)
    for k in ("head", "head_dist"):
        params[k]["kernel"] = jnp.asarray(
            0.2 * rng.standard_normal(params[k]["kernel"].shape),
            jnp.float32)
    params["token_scorer"]["kernel"] = jnp.asarray(
        rng.standard_normal(params["token_scorer"]["kernel"].shape),
        jnp.float32)
    s = jnp.array([[1.0, 100.0], [0.0, 300.0]])
    r = jnp.array([[0.0, 0.0, 0.0], [8.0, 16.0, 0.0]])
    masks = jmasks.build_masks(params, s, r, JCFG)
    params["block_gating"] = jnp.array([[-1.0, 1.0], [1.0, -1.0]])
    np_params = jax.tree.map(np.asarray, params)
    np_masks = jax.tree.map(np.asarray, masks)
    return (np_params, np_masks, params_from_numpy(np_params, device="cpu"),
            masks_from_numpy(np_masks, device="cpu"))


def _loaders(pipe):
    return pipe.ProceduralLoader(16, num_batches=2, img_size=32,
                                 num_classes=50, train=False, seed=0,
                                 **te2e.HARD)


@pytest.mark.parametrize("ratio", [None, te2e.TOKEN_RATIO])
def test_accuracy_helpers_give_jaxs_hits(ratio):
    jp, jm, tp, tm = _model()
    keep = np.array([True, False])
    gd = np.stack([1.0 - keep, keep.astype(np.float64)],
                  axis=1).astype(np.float32)
    jl, jtop = jcompact.compact_model(jp, jm, JCFG, block_keep=keep)
    tl, ttop = tcompact.compact_model(tp, tm, TCFG, block_keep=keep,
                                      dtype=torch.bfloat16, device="cpu")
    j_serve = je2e.serving_accuracy(jl, jtop, JCFG, _loaders(jpipe),
                                    token_ratio=ratio)
    t_serve = te2e.serving_accuracy(tl, ttop, TCFG, _loaders(tpipe),
                                    token_ratio=ratio, device="cpu",
                                    dtype=torch.bfloat16)
    assert t_serve == j_serve
    j_md = je2e.masked_dense_accuracy(jp, jm, JCFG, _loaders(jpipe),
                                      token_ratio=ratio,
                                      gating_distrib=jnp.asarray(gd))
    t_md = te2e.masked_dense_accuracy(tp, tm, TCFG, _loaders(tpipe),
                                      token_ratio=ratio,
                                      gating_distrib=torch.from_numpy(gd),
                                      device="cpu")
    assert t_md == j_md
    # the dense baseline's form: no masks, no gating
    assert te2e.masked_dense_accuracy(
        tp, None, TCFG, _loaders(tpipe), device="cpu") == \
        je2e.masked_dense_accuracy(jp, None, JCFG, _loaders(jpipe))


def test_series_readers_are_jaxs(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    recs = [{"step": 50, "train/loss": 3.0},
            {"step": 100, "train/flops_real": 0.9,
             "train/flops_expectation": 0.85},
            {"step": 100, "test/accuracy": 0.5},
            {"step": 200, "train/flops_real": 0.6,
             "train/flops_expectation": 0.62,
             "train/flops_real_argmax": 0.7, "train/z": 0.0},
            {"step": 300, "train/flops_real": 0.4,
             "train/flops_expectation": 0.45,
             "train/flops_real_argmax": 0.42, "train/z": 3.5}]
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    got = tfid._read_series(str(tmp_path), "run")
    assert got == jfid._read_series(str(tmp_path), "run")
    assert got["real"] == te2e.read_flops_real(str(tmp_path), "run")
    for vals in (got["argmax"], got["real"], [0.3], []):
        assert tfid._max_bounce(vals) == jfid._max_bounce(vals)


def test_below_start_is_jaxs():
    jcfg = jconfigs.get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=64, num_classes=100)
    tcfg = tconfigs.get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=64, num_classes=100)
    params = jax.tree.map(np.asarray,
                          jvit.init_params(jax.random.PRNGKey(1), jcfg))
    dense = params_from_numpy(params, device="cpu")
    tp, tcs = tfid.below_start(dense, tcfg, tfid._uvc_hp(THParams), "cpu")
    # the JAX harness's edits (run_scenario_below)
    g = np.tile(np.array([[-1.0, 1.0]], np.float32), (jcfg.depth, 1))
    g[np.arange(jcfg.depth) % 4 != 3] = [1.25, -1.25]
    jcs = j_init_cs(jcfg, jfid._uvc_hp(JHParams))
    jcs = jcs.replace(s=jcs.s.at[:, 0].set(1.0),
                      r=jnp.full_like(jcs.r, 16.0))
    np.testing.assert_array_equal(tp["block_gating"].numpy(), g)
    assert (g[:, 0] > g[:, 1]).sum() == 9
    for name in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
        np.testing.assert_array_equal(getattr(tcs, name).numpy(),
                                      np.asarray(getattr(jcs, name)),
                                      err_msg=name)
    # every other leaf is the dense params', which stay untouched
    assert tp["blocks"] is dense["blocks"]
    assert not torch.equal(dense["block_gating"], tp["block_gating"])


@pytest.mark.parametrize("name", ["E2EACC_r05.json", "E2EACC_r05_seed1.json",
                                  "E2EACC_r05_seed2.json"])
def test_e2e_gates_reproduce_the_tpu_records(name):
    rec = _record(name)
    assert te2e.e2e_gates(rec) == rec["gates"]


def _fid_series(part):
    return {"real": part["real_flops_series"],
            "exp": part.get("exp_flops_series", part["real_flops_series"]),
            "argmax": part["argmax_flops_series"],
            "z": part.get("z_series", [0.0])}


def _cstate(z=1.0, neg=None):
    cs = types.SimpleNamespace(
        z=torch.tensor(z), y=torch.full((12, 2), 1e-3),
        p=torch.full((12, 3), 1e-3), s=torch.zeros(12, 2))
    if neg:
        getattr(cs, neg)[3, 0] = -1e-4
    return cs


def test_fidelity_gates_reproduce_the_tpu_record():
    rec = _record("FIDELITY_r05.json")
    gates = {**tfid.tiny_gates(_fid_series(rec["tiny"]), _cstate()),
             **tfid.below_gates(_fid_series(rec["below"]), _cstate())}
    assert gates == rec["gates"]
    for neg in ("y", "p", "s"):
        assert not tfid.tiny_gates(_fid_series(rec["tiny"]),
                                   _cstate(neg=neg))[
            "T5 dual/primal invariants"]
    assert not tfid.below_gates(_fid_series(rec["below"]), _cstate(-1.0))[
        "B5 dual/primal invariants"]


def _e2e_perturbed():
    rec = _record("E2EACC_r05.json")
    rec["stage2_acc"] = rec["dense_acc"] - 0.07
    return te2e.e2e_gates(rec), "A2 stage-2 acc >= dense - 0.06"


def _tiny_perturbed():
    part = _record("FIDELITY_r05.json")["tiny"]
    ser = _fid_series(part)
    am = list(ser["argmax"])
    am[5] = am[4] + 0.2                      # an up-move after warmup
    ser["argmax"] = am
    return (tfid.tiny_gates(ser, _cstate()),
            "T6a argmax up-bounce <= 0.15 after warmup (thrash)")


def _below_perturbed():
    ser = _fid_series(_record("FIDELITY_r05.json")["below"])
    ser["z"] = [0.5] + list(ser["z"][1:])
    return (tfid.below_gates(ser, _cstate()),
            "B4 dual relaxed early (z at epoch 1 <= 0.1)")


@pytest.mark.parametrize("perturbed", [_e2e_perturbed, _tiny_perturbed,
                                       _below_perturbed],
                         ids=["A2", "T6a", "B4"])
def test_gates_turn_false_on_perturbed_inputs(perturbed):
    gates, name = perturbed()
    assert gates[name] is False
    assert sum(not v for v in gates.values()) == 1


def test_report_draw_keeps_blocks_at_the_logistic_rate():
    """Gate T1 reads one hard Gumbel draw of the frozen warmup logits
    (-1, 1) per block (``train/stage1.py::draw_report_noise``): each block
    is kept with probability sigmoid(2), so T1 (at least 10 of 12 kept)
    passes with the binomial probability 0.836 whatever the
    implementation.  The port's draws over 20000 generator seeds keep
    that rate and that pass share."""
    from uvc_tpu_torch.ops.gumbel import block_gating_distrib, gumbel_noise

    p = 1.0 / (1.0 + math.exp(-2.0))
    t1 = sum(math.comb(12, k) * p ** k * (1 - p) ** (12 - k)
             for k in range(10, 13))
    logits = torch.tensor([[-1.0, 1.0]] * 12)
    kept = np.array([
        int(block_gating_distrib(
            gumbel_noise(torch.Generator().manual_seed(s), (12, 2)), logits,
            use_gumbel=True, gumbel_hard=True, eps=torch.tensor(0.1),
            warmup=False)[:, 1].sum()) for s in range(20000)])
    assert abs(kept.mean() - 12 * p) < 0.02
    assert abs((kept >= 10).mean() - t1) < 0.01
    assert round(t1, 3) == 0.836
