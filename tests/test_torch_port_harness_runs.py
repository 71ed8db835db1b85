"""The port's evidence harnesses and examples run end to end on the CPU at
plumbing sizes (gates meaningless there): ``trajectory_fidelity`` under
its ``UVC_FID_SMOKE=1`` switch as a module of its own, ``e2e_accuracy``
with its constants and config cut in the port's module (depth 2, 2
batches of 8 an epoch), and both examples cut the same way.  Each writes
its record with the JAX harness's keys, and none falls back to the CPU
when the card is asked for and absent.
"""

import torch_port_env
from torch_port_env import capped_threads  # noqa: F401  (autouse)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uvc_tpu_torch.examples import learning_demo, serving_demo
from uvc_tpu_torch.scripts import e2e_accuracy as te2e
from uvc_tpu_torch.scripts import trajectory_fidelity as tfid

REPO = Path(__file__).resolve().parents[1]
E2E_GATES = {"A1 0.72 <= dense acc <= 0.97", "A2 stage-2 acc >= dense - 0.06",
             "A3 stage-1 real FLOPs <= 0.62",
             "A4 compact acc >= masked-dense full - 0.01",
             "A5 slimmed acc >= stage-2 - 0.06",
             "A6 compact FLOPs <= real + 0.05",
             "A7 slim acc >= masked-dense slim - 0.02",
             "A8 stage-2 acc <= 0.985 (unsaturated)",
             "A9 slim acc <= 0.985 (unsaturated)"}


def test_e2e_runs_at_plumbing_size(monkeypatch, tmp_path):
    for k, v in dict(STEPS=2, BATCH=8, PRETRAIN_EPOCHS=1, EPOCHS=2,
                     WARMUP=1, STAGE2_EPOCHS=1, EVAL_BATCHES=2,
                     DENSE_EPOCHS_MAX=3).items():
        monkeypatch.setattr(te2e, k, v)
    make = te2e.make_config
    monkeypatch.setattr(te2e, "make_config", lambda: make().replace(depth=2))
    out = tmp_path / "e2e.json"
    rc = te2e.main(["--seed", "1", "--out", str(out), "--device", "cpu"])
    rec = json.loads(out.read_text())
    assert rc == (0 if rec["ok"] else 1)
    assert set(rec) == set(te2e.RECORD_KEYS)
    assert set(rec["gates"]) == E2E_GATES
    assert (rec["backend"], rec["device"], rec["seed"]) == ("cpu", "cpu", 1)
    # below its target the pretrain extends once, to the cut ceiling
    assert rec["dense_epochs"] == 3
    assert rec["blocks_kept"] <= 2 and rec["token_ratio"] == 0.7
    for k in ("dense_acc", "stage1_acc", "stage2_acc", "compact_acc",
              "slim_acc", "masked_dense_full_acc", "masked_dense_slim_acc"):
        assert 0.0 <= rec[k] <= 1.0, k
    assert 0.0 < rec["compact_flops_fraction"] <= 1.0


def test_fidelity_runs_under_its_smoke_switch(tmp_path):
    out = tmp_path / "fid.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(UVC_FID_SMOKE="1",
               OMP_NUM_THREADS=str(torch_port_env.THREADS))
    res = subprocess.run(
        [sys.executable, "-m", "uvc_tpu_torch.scripts.trajectory_fidelity",
         "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    rec = json.loads(out.read_text())
    assert res.returncode == (0 if rec["ok"] else 1), res.stderr[-2000:]
    assert set(rec) == set(tfid.RECORD_KEYS)
    assert len(rec["gates"]) == 13
    assert len(rec["tiny"]["real_flops_series"]) == tfid.EPOCHS
    assert len(rec["below"]["z_series"]) == tfid.EPOCHS_BELOW
    # T5 / B5 hold at any horizon
    assert rec["gates"]["T5 dual/primal invariants"]
    assert rec["gates"]["B5 dual/primal invariants"]
    assert "stage tiny:" in res.stdout and "img/s" in res.stdout


def test_fidelity_pretrain_cache(monkeypatch, tmp_path):
    """The pretrain cache is the port's own: written on a miss, read back
    bit for bit on a hit, refused when its fingerprint differs."""
    for k, v in tfid.SMOKE.items():
        monkeypatch.setattr(tfid, k, v)
    cache = str(tmp_path / "pre.pkl")
    test = tfid.TextureLoader(tfid.BATCH, 1, seed=99)
    *_, dense, acc, hit = tfid.run_pretrain(
        str(tmp_path), tfid.TextureLoader(tfid.BATCH, tfid.STEPS, seed=0),
        test, cache=cache, device="cpu")
    assert not hit and os.path.exists(cache)
    *_, again, acc2, hit2 = tfid.run_pretrain(
        str(tmp_path), None, test, cache=cache, device="cpu")
    assert hit2 and acc2 == acc
    assert torch.equal(again["blocks"]["qkv"]["kernel"],
                       dense["blocks"]["qkv"]["kernel"])
    monkeypatch.setattr(tfid, "STEPS", 1)
    *_, hit3 = tfid.run_pretrain(
        str(tmp_path), tfid.TextureLoader(tfid.BATCH, 1, seed=0), test,
        cache=cache, device="cpu")
    assert not hit3            # stale: another step count retrains


def test_learning_demo_runs(monkeypatch):
    for k, v in dict(IMAGES_TRAIN=256, IMAGES_TEST=128, EPOCHS=3,
                     DEPTH=2).items():
        monkeypatch.setattr(learning_demo, k, v)
    res = learning_demo.run("cpu")
    assert 0.0 <= res.best_acc <= 1.0
    assert len(res.masks["attn"]) == 2


def test_serving_demo_runs(monkeypatch):
    monkeypatch.setattr(serving_demo, "EPOCHS", 3)
    monkeypatch.setattr(serving_demo, "STEPS", 4)
    served, compact, y = serving_demo.run("cpu")
    assert served.shape == compact.shape == (8, 10)
    np.testing.assert_allclose(served.numpy(), compact.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert y.shape == (8,)


@pytest.mark.parametrize("entry", [
    lambda: te2e.main(["--device", "cuda"]),
    lambda: tfid.main(["--device", "cuda"]),
    lambda: learning_demo.main(["--device", "cuda"]),
    lambda: serving_demo.main(["--device", "cuda"]),
], ids=["e2e", "fidelity", "learning", "serving"])
def test_entry_points_refuse_a_missing_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
