"""The port's drivers against the JAX package's on JAX's key chain, at the
fidelity harness's recipes (``scripts/trajectory_fidelity.py``, loaded by
path and not changed) over every epoch.

Tier 1: both scenarios' recipes (the 15-entry zlr staircase, gating every
10 steps, eps decay 0.92, gating weight 5e-4, one warmup epoch for "tiny"
and none for "below" from its over-compressed start) on a toy model, all
15 and 12 epochs at 3 steps each; the pretrain's recipe over its 5
epochs; the seed spread's offsets (``tests/seed_spread.py``).

``slow``: the same-stream comparison at full size and horizon
(``tests/samestream.py``): DeiT-Tiny at 64 px, batch 128, the harnesses'
own loaders, f32 on the CPU, from JAX's weights on JAX's chain, and the
pretrain's first 100 steps beside two one-ulp witnesses.  Set
``UVC_SAMESTREAM_DIR`` to keep its checkpoints and its
``SAMESTREAM_cpu.json``; run one phase as ``python -m pytest
tests/test_torch_port_fidelity_recipe.py -m slow -k <phase>`` (the
pretrain first: the scenarios start from its JAX dense model, which it
leaves in the directory as the harness's pretrain cache).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samestream
import uvc_tpu.configs as jconfigs
from samestream import jfid, jstage1, tfid, tstage1
from test_torch_port_drivers import _compare_metrics, _loaders, np_
from uvc_tpu.data import pipeline as jpipe
from uvc_tpu.models import vit as jvit
from uvc_tpu.train.state import TrainHParams as JTHP
from uvc_tpu_torch import configs as tconfigs
from uvc_tpu_torch.data import pipeline as tpipe
from uvc_tpu_torch.interop import params_from_numpy

TOY = dict(embed_dim=16, num_heads=2, depth=4, num_classes=7,
           distilled=True, img_size=32)
# every epoch of both recipes at 3 steps each: the 15 staircase entries
# (1..14 executed), 4 gating updates over "tiny"'s 45 steps
TOY_SIZES = dict(STEPS=3, CLASSES=7)


@pytest.mark.parametrize("scenario", ["tiny", "below"])
def test_fidelity_recipe_matches_jax_over_every_epoch(scenario, tmp_path,
                                                      monkeypatch):
    """The JAX harness's scenario function against the port's at a toy
    size, the port on JAX's chain, from one set of weights: each epoch's
    report (FLOPs, z, accuracy, loss) within 1e-4, the gates equal, and
    the final minimax state within 1e-5."""
    for mod in (jfid, tfid):
        for k, v in TOY_SIZES.items():
            monkeypatch.setattr(mod, k, v)
    jcfg = jconfigs.get_config("testing").replace(**TOY)
    tcfg = tconfigs.get_config("testing").replace(**TOY)
    dense = samestream._np_tree(jvit.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    epochs, warmup = ((tfid.EPOCHS, tfid.WARMUP) if scenario == "tiny"
                      else (tfid.EPOCHS_BELOW, 0))
    name = {"tiny": "tinyshape", "below": "below"}[scenario]
    jrec = samestream.Recorder(jstage1.run_stage1, checkpoints=False)
    with samestream.patched([(jstage1, "run_stage1", jrec)]):
        jgates, jpay = getattr(jfid, f"run_scenario_{scenario}")(
            str(tmp_path / "jax"), jcfg, jnp.float32,
            jax.tree.map(jnp.asarray, dense), *_loaders(jpipe))
    jthp = tfid._thp(JTHP, epochs, warmup, jnp.float32)
    trec = samestream.Recorder(tstage1.run_stage1, checkpoints=False)
    with samestream.patched(samestream.jax_chain(0, jthp)
                            + [(tstage1, "run_stage1", trec)]):
        tgates, tpay = getattr(tfid, f"run_scenario_{scenario}")(
            str(tmp_path / "port"), tcfg, torch.float32,
            params_from_numpy(dense, "cpu"), *_loaders(tpipe),
            device="cpu")
    (jres,), (tres,) = jrec.results.values(), trec.results.values()
    assert tres.state.step == int(jres.state.step) == epochs * 3
    recs = _compare_metrics(tmp_path / "port" / name / "metrics.jsonl",
                            tmp_path / "jax" / name / "metrics.jsonl")
    assert sum("train/flops_real" in r for r in recs) == epochs
    assert tgates == {k: bool(v) for k, v in jgates.items()}
    for k in tpay:
        np.testing.assert_allclose(tpay[k], jpay[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    tc, jc = tres.state.cstate, jres.state.cstate
    for f in ("s", "r", "y", "p", "z", "eps", "zlr", "gating_accum"):
        np.testing.assert_allclose(np_(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    # the staircase reached its last epoch's entry, and eps is 0.92^(UVC
    # epochs) of the first
    assert float(np_(tc.zlr)) == jfid._uvc_hp(
        samestream.JHP).zlr_for_epoch(epochs, epochs)
    np.testing.assert_allclose(float(np_(tc.eps)),
                               0.1 * 0.92 ** (epochs - warmup), rtol=1e-6)
    for k in ("attn", "mlp"):
        np.testing.assert_array_equal(np_(tres.masks[k]),
                                      np.asarray(jres.masks[k]))


def test_pretrain_recipe_matches_jax(tmp_path, monkeypatch):
    """The JAX harness's fidelity pretrain (``run_pretrain``: lr 1e-3 from
    the first step, weight decay 0.05, smoothing 0.1, no distillation, no
    mixup) against the port's over its 5 epochs at a toy size, the port
    from JAX's ``PRNGKey(0)`` weights on JAX's chain: each epoch's report
    and accuracy as the drivers' tests hold them, and every weight after
    the last step within 1e-5."""
    for mod in (jfid, tfid):
        for k, v in dict(TOY_SIZES, IMG=TOY["img_size"]).items():
            monkeypatch.setattr(mod, k, v)
    jcfg = jconfigs.get_config("testing").replace(**TOY)
    tcfg = tconfigs.get_config("testing").replace(**TOY)
    monkeypatch.setattr(jconfigs, "get_config", lambda name: jcfg)
    monkeypatch.setattr(tfid, "_make_config", lambda: tcfg)
    jrec = samestream.Recorder(jstage1.run_stage1, checkpoints=False)
    with samestream.patched([(jstage1, "run_stage1", jrec)]):
        jfid.run_pretrain(str(tmp_path / "jax"), *_loaders(jpipe))
    init = samestream._np_tree(samestream.jax_init(
        jcfg, 0, samestream.JHP(enable_patch_gating=0,
                                enable_pruning=False)))
    trec = samestream.Recorder(tstage1.run_stage1, checkpoints=False,
                               init=params_from_numpy(init, "cpu"))
    jthp = tfid._pretrain_thp(JTHP, jnp.float32)
    with samestream.patched(samestream.jax_chain(0, jthp)
                            + [(tstage1, "run_stage1", trec)]):
        tfid.run_pretrain(str(tmp_path / "port"), *_loaders(tpipe),
                          device="cpu")
    (jres,), (tres,) = jrec.results.values(), trec.results.values()
    assert tres.state.step == int(jres.state.step) == tfid.PRETRAIN_EPOCHS * 3
    recs = _compare_metrics(tmp_path / "port" / "pretrain" / "metrics.jsonl",
                            tmp_path / "jax" / "pretrain" / "metrics.jsonl")
    assert sum("test/accuracy" in r for r in recs) == tfid.PRETRAIN_EPOCHS
    jp = samestream._flat(samestream._np_tree(jres.state.params))
    tp = samestream._flat(tres.state.params)
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))


def test_seed_spread_moves_every_fidelity_seed(monkeypatch):
    """``seed_spread.run_fidelity(offset)`` runs the port's whole fidelity
    harness (cut to 2 steps of 8 images an epoch and 2 epochs a scenario)
    with each loader's seed and each ``run_stage1`` call's seed ``offset``
    more than the harness's own, and puts both back afterwards."""
    import seed_spread

    for k, v in dict(tfid.SMOKE, EPOCHS=2, EPOCHS_BELOW=2, EVAL_BATCHES=1,
                     IMG=TOY["img_size"], CLASSES=TOY["num_classes"]).items():
        monkeypatch.setattr(tfid, k, v)
    tcfg = tconfigs.get_config("testing").replace(**TOY)
    monkeypatch.setattr(tfid, "_make_config", lambda: tcfg)
    seen = {"loaders": [], "runs": []}

    class Loader(tfid.TextureLoader):
        def __init__(self, batch_size, num_batches, *, seed=0):
            seen["loaders"].append(seed)
            super().__init__(batch_size, num_batches, seed=seed)

    base = tstage1.run_stage1

    def run_stage1(*args, seed=42, **kw):
        seen["runs"].append(seed)
        return base(*args, seed=seed, **kw)

    monkeypatch.setattr(tfid, "TextureLoader", Loader)
    monkeypatch.setattr(tstage1, "run_stage1", run_stage1)
    record = seed_spread.run_fidelity(300, device="cpu")
    assert sorted(seen["loaders"]) == [300, 310, 311, 399]
    assert seen["runs"] == [300, 300, 300]
    assert record["offset"] == 300 and len(record["gates"]) == 13
    assert tfid.TextureLoader is Loader
    assert tstage1.run_stage1 is run_stage1


def test_seed_spread_imports_no_jax():
    """The seed spread runs on the card's machine, which has no JAX:
    importing it loads neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, 'tests'); import seed_spread; "
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'uvc_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=samestream.REPO)


@pytest.mark.slow
@pytest.mark.parametrize("phase", ["pretrain", "pretrain_steps", "tiny",
                                   "tiny_steps", "below", "below_steps",
                                   "e2e_stage1"])
def test_same_stream_at_full_size(phase, tmp_path):
    """Epoch phases: no epoch-end decision (masks, argmax gating, the
    reports) parts before the numbers it is made from do (a weight beyond
    ``LEAF_TOL`` of its counterpart, the minimax state beyond 1e-4 of its
    scale); the parting epochs are reported.  ``<phase>_steps``: the
    port's first 100 (pretrain) or 200 (scenario) steps against JAX's,
    weight by weight: at every kept step from the first, the port no
    farther from JAX (the largest weight difference, and the relative
    Frobenius norm) than 10 times the farther of two witnesses of float
    noise, each package against itself from the same start one ulp up (a
    wrong constant of the recipe moves most weights by the learning rate
    at step 1, ~10^4 times the witnesses)."""
    work = os.environ.get("UVC_SAMESTREAM_DIR") or str(tmp_path)
    res = samestream.run_phase(phase, work)
    if phase.endswith("_steps"):
        port, jw, tw = (res["pairs"][k] for k in (
            "jax_vs_port", "jax_vs_jax_ulp", "port_vs_port_ulp"))
        assert port[0]["step"] == 1
        for p, a, b in zip(port, jw, tw):
            print(f"step {p['step']}: port {p['rel_fro']:.3g}, witnesses "
                  f"{a['rel_fro']:.3g} / {b['rel_fro']:.3g}")
            for k in ("max", "rel_fro"):
                assert p[k] <= 10 * max(a[k], b[k]), (k, p)
        return
    dec = res["first_decision_parting_epoch"]
    num = res["first_number_parting_epoch"]
    print(f"{phase}: numbers part at epoch {num}, decisions at {dec} "
          f"({res['parted_by']})")
    assert dec is None or (num is not None and num <= dec), res["epochs"]


def test_init_draws_from_jaxs_distribution():
    """The fidelity harness's DeiT-Tiny (cut to 2 blocks) drawn by each
    package from its own generator (torch's at seed 0, JAX's
    ``PRNGKey(0)``): every leaf the same shape, the same constant leaves,
    and the random ones of the same law (the truncated normal's mean,
    scale and bound; 2% on the scale)."""
    from uvc_tpu_torch.models import get_model

    cfg = tfid._make_config().replace(depth=2)
    hp = samestream.JHP(enable_patch_gating=0, enable_pruning=False)
    jp = samestream._flat(samestream._np_tree(samestream.jax_init(cfg, 0,
                                                                  hp)))
    tp = samestream._flat(get_model(cfg).init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert set(jp) == set(tp)
    for k, a in jp.items():
        b = tp[k]
        assert a.shape == b.shape, k
        if a.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=str(k))
            continue
        assert abs(b.std() / a.std() - 1) < 0.02 or a.size < 500, k
        assert abs(b.mean() - a.mean()) < 4 * a.std() / np.sqrt(a.size), k
        assert np.abs(b).max() <= np.abs(a).max() * 1.01 + 1e-3, k
