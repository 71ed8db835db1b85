"""Longer-horizon trajectory fidelity: two published-log regimes
(counterpart of ``scripts/trajectory_fidelity.py``, whose docstring tells
each gate's history).

The full 12-block / 3-head / 192-wide DeiT-Tiny on a structured
synthetic task (``TextureLoader``: class-conditional sinusoid textures,
100 classes, 64 px), the FLOPs trajectories gated against the logs'
qualitative shapes.

SCENARIO 1 (``tiny_gates``) -- descent from dense (deit-tiny-log.log):
budget 0.5, warmup then steady descent; the dual z tightens.
  T1  warmup epochs stay in the no-pruning band (>= 83.3%)
  T2  descent reaches <= 60% by epoch 10
  T3  tail mean (last 3 epochs, stochastic Real) in [0.20, 0.55]
  T4  |Expectation - Real| <= 0.08 tail mean
  T5  dual/primal invariants: z, y, p, s >= 0 at the end
  T6a argmax up-moves after warmup <= 0.15 (thrash)
  T6b argmax never collapses (min >= 0.15)

SCENARIO 2 (``below_gates``) -- budget approached from below
(deit-base-log.log): from an over-compressed start (``below_start``: 9 of
12 blocks gated shut, 1/3 heads + 16/64 within-head dims removed) the
dual relaxes and the FLOPs rise until the budget binds.
  B1  starts below budget: first-epoch argmax Real <= 0.42
  B2  rises: tail mean (argmax, last 3) - first epoch >= 0.08
  B3  lands at the budget band: tail mean (argmax) in [0.40, 0.60]
  B4  dual relaxed early: z at the end of epoch 1 <= 0.1
  B5  invariants (as T5)
  B6  smoothness: argmax bounce <= 0.15 after the first 2 epochs

Every stage computes in the device's dtype: bf16 on the card, f32 on the
CPU.

Usage:  python -m uvc_tpu_torch.scripts.trajectory_fidelity \\
            --out FIDELITY_h100.json      # --scenario tiny|below: one
        UVC_FID_SMOKE=1 ... --device cpu  # plumbing sizes on the CPU

Exits non-zero if any gate fails; --out writes gate results + all series.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from uvc_tpu_torch.scripts import (device_dtype, device_record, print_gates,
                                   write_record)

EPOCHS = 15        # reference: 30
WARMUP = 1         # reference: 5
EPOCHS_BELOW = 12  # scenario 2 (no warmup)
PRETRAIN_EPOCHS = 5
STEPS = 100        # batches per epoch
BATCH = 128
CLASSES = 100
IMG = 64
EVAL_BATCHES = 5

# plumbing smoke: tiny step counts, gates meaningless
SMOKE = dict(STEPS=2, BATCH=8, PRETRAIN_EPOCHS=1)
if os.environ.get("UVC_FID_SMOKE") == "1":
    globals().update(SMOKE)

# the record's keys, those of the JAX harness's (a one-scenario run
# leaves the other's out)
RECORD_KEYS = ("harness", "golden_source", "backend", "device", "ok",
               "wall_s", "gates", "pretrain_acc", "pretrain_from_cache",
               "tiny", "below")


class TextureLoader:
    """Structured synthetic task: each class is a distinct 3-channel
    sinusoid texture (frequency/orientation/color mix) + per-sample phase
    jitter and pixel noise.  Learnable by a tiny ViT in a few hundred
    steps, so the compression loss has real accuracy pressure to push
    against (pure-noise data lets stage 1 prune everything)."""

    def __init__(self, batch_size, num_batches, *, seed=0):
        rng = np.random.default_rng(1234)   # class definitions are fixed
        self.freq = rng.uniform(0.15, 0.9, (CLASSES, 2))
        self.color = rng.uniform(0.3, 1.0, (CLASSES, 3))
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.num_batches = num_batches
        yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float32)
        self._grid = (xx, yy)

    def __len__(self):
        return self.num_batches

    def set_epoch(self, epoch):
        pass

    def _make(self, labels, phases):
        xx, yy = self._grid
        fx = self.freq[labels, 0][:, None, None]
        fy = self.freq[labels, 1][:, None, None]
        wave = np.sin(fx * xx + fy * yy + phases[:, None, None])
        img = wave[..., None] * self.color[labels][:, None, None, :]
        img = (img * 0.5 + 0.5) * 255.0
        noise = self.rng.normal(0.0, 12.0, img.shape)
        return np.clip(img + noise, 0, 255).astype(np.uint8)

    def __iter__(self):
        for _ in range(self.num_batches):
            labels = self.rng.integers(0, CLASSES, self.batch_size)
            phases = self.rng.uniform(0, 2 * np.pi, self.batch_size) \
                .astype(np.float32)
            yield self._make(labels, phases), labels.astype(np.int32)


def _uvc_hp(MinimaxHParams):
    return MinimaxHParams(
        budget=0.5, slr=0.02, rlr=0.02, glr=0.1, ylr=2e-4, plr=2e-4,
        # dual rates scaled 2x for the ~1.5k-step horizon (5x was
        # measured to limit-cycle); the staircase keeps the recipe's
        # 2 -> 34 endpoints and its integral at 1-epoch granularity (max
        # stair +3/epoch: the recipe's +8 lumps mass-flip the argmax
        # architecture on the 2x-compressed epoch axis)
        zlr_schedule=(2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29,
                      32, 34),
        gating_interval=10,
        gating_weight=5e-4,   # the published tiny recipe (log Namespace);
                              # the argparse default 5 slams gates shut
        eps=0.1, eps_decay=0.92, use_gumbel=True,
        enable_block_gating=True, enable_part_gating=False,
        enable_patch_gating=0)


def _read_series(out, name):
    series = {"real": [], "exp": [], "argmax": [], "z": []}
    with open(os.path.join(out, name, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if "train/flops_real" in rec:
                series["real"].append(rec["train/flops_real"])
                series["exp"].append(rec["train/flops_expectation"])
                series["argmax"].append(
                    rec.get("train/flops_real_argmax",
                            rec["train/flops_real"]))
                series["z"].append(rec.get("train/z", 0.0))
    return series


def _max_bounce(vals):
    return max((abs(b - a) for a, b in zip(vals, vals[1:])), default=0.0)


def _host(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


def _invariants(cs):
    """z, y, p, s >= 0 (T5, B5)."""
    return (float(cs.z) >= 0
            and bool(np.all(_host(cs.y) >= 0))
            and bool(np.all(_host(cs.p) >= 0))
            and bool(np.all(_host(cs.s) >= 0)))


def tiny_gates(series, cstate) -> dict:
    """Gates T1-T6b of scenario "tiny": ``series`` as ``_read_series``
    returns it, ``cstate`` the compression state at the end."""
    real, exp, am = series["real"], series["exp"], series["argmax"]
    return {
        "T1 warmup in no-pruning band (>= 83.3%)":
            all(v >= 10.0 / 12.0 - 1e-3 for v in real[:WARMUP]),
        "T2 descent <= 60% by epoch 10": min(real[:10]) <= 0.60,
        "T3 tail mean in [0.20, 0.55]":
            0.20 <= float(np.mean(real[-3:])) <= 0.55,
        "T4 |exp - real| <= 0.08 tail mean":
            float(np.mean([abs(e - r)
                           for e, r in zip(exp[-3:], real[-3:])])) <= 0.08,
        "T5 dual/primal invariants": _invariants(cstate),
        # directional smoothness on the deterministic argmax
        # architecture: up-moves are thrash; the down-move size reflects
        # the task's block homogeneity, so T6b floors the deepest
        # excursion instead (collapse through the budget)
        "T6a argmax up-bounce <= 0.15 after warmup (thrash)":
            max((b - a for a, b in zip(am[WARMUP:], am[WARMUP + 1:])),
                default=0.0) <= 0.15,
        "T6b argmax never collapses (min >= 0.15)":
            min(am[WARMUP:]) >= 0.15,
    }


def below_gates(series, cstate) -> dict:
    """Gates B1-B6 of scenario "below"."""
    am, zs = series["argmax"], series["z"]
    return {
        "B1 starts below budget (argmax[0] <= 0.42)": am[0] <= 0.42,
        "B2 rises >= 0.08 (tail mean - first)":
            float(np.mean(am[-3:])) - am[0] >= 0.08,
        "B3 tail mean (argmax) in [0.40, 0.60]":
            0.40 <= float(np.mean(am[-3:])) <= 0.60,
        # while resource < budget the z-excess is negative, so the >= 0
        # projection pins z near 0 (a dual-ascent sign error would blow z
        # up here)
        "B4 dual relaxed early (z at epoch 1 <= 0.1)": zs[0] <= 0.1,
        "B5 dual/primal invariants": _invariants(cstate),
        "B6 argmax bounce <= 0.15 after epoch 2":
            _max_bounce(am[2:]) <= 0.15,
    }


def _make_config():
    from uvc_tpu_torch.configs import get_config
    return get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=IMG, num_classes=CLASSES)


def _fingerprint(dtype):
    """The pretrain cache's key: a stale or smoke-size cache never feeds a
    record run a differently trained dense model."""
    return {"steps": STEPS, "batch": BATCH, "pre_epochs": PRETRAIN_EPOCHS,
            "classes": CLASSES, "img": IMG, "dtype": str(dtype),
            "lr": 1e-3, "wd": 0.05, "smoothing": 0.1, "seed": 0}


def run_pretrain(out, train, test, cache=None, device="cuda"):
    import pickle

    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.interop import params_from_numpy
    from uvc_tpu_torch.train.stage1 import copy_tree, run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger
    from uvc_tpu_torch.utils.tree import tree_map

    cfg = _make_config()
    dtype = device_dtype(torch.device(device))
    fprint = _fingerprint(dtype)
    if cache and os.path.exists(cache):
        # dev-iteration shortcut: identical dense init across harness runs
        with open(cache, "rb") as fh:
            blob = pickle.load(fh)
        if blob.get("fprint") == fprint:
            dense = params_from_numpy(blob["params"], device)
            print(f"pretrain cache hit: {cache} "
                  f"(acc {blob['acc'] * 100:.1f}%)")
            return cfg, dtype, dense, blob["acc"], True
        print(f"pretrain cache STALE (fprint {blob.get('fprint')} != "
              f"{fprint}): retraining")
    hp_pre = MinimaxHParams(enable_patch_gating=0, enable_pruning=False)
    thp_pre = _pretrain_thp(TrainHParams, dtype)
    pre = run_stage1(cfg, hp_pre, thp_pre, train_loader=train,
                     test_loader=test, seed=0, output_dir=out,
                     name="pretrain", eval_each_epoch=True,
                     save_checkpoints=False,
                     logger=MetricLogger(out, "pretrain"), device=device)
    dense = copy_tree(pre.state.params)
    if cache:
        with open(cache, "wb") as fh:
            pickle.dump({"params": tree_map(_host, dense),
                         "acc": float(pre.best_acc),
                         "fprint": fprint}, fh)
        print(f"pretrain cached -> {cache}")
    return cfg, dtype, dense, float(pre.best_acc), False


def _pretrain_thp(TrainHParams, dtype):
    return TrainHParams(
        learning_rate=1e-3, warmup_lr=1e-3, weight_decay=0.05,
        warmup_steps=0, t_total=PRETRAIN_EPOCHS * STEPS,
        num_epochs=PRETRAIN_EPOCHS, warmup_epochs=PRETRAIN_EPOCHS,
        num_classes=CLASSES, mixup=0.0, cutmix=0.0, smoothing=0.1,
        distillation_type="none", compute_dtype=dtype)


def _thp(TrainHParams, epochs, warmup, dtype):
    return TrainHParams(
        learning_rate=1e-4, warmup_lr=1e-4, weight_decay=0.05,
        warmup_steps=25, t_total=epochs * STEPS, num_epochs=epochs,
        warmup_epochs=warmup, num_classes=CLASSES, mixup=0.8, cutmix=1.0,
        distillation_type="soft", distillation_alpha=0.1,
        distillation_tau=1.0, compute_dtype=dtype)


def run_scenario_tiny(out, cfg, dtype, dense, train, test, device="cuda"):
    """Descent-from-dense (tiny-log regime)."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger

    hp = _uvc_hp(MinimaxHParams)
    thp = _thp(TrainHParams, EPOCHS, WARMUP, dtype)
    result = run_stage1(cfg, hp, thp, train_loader=train, test_loader=test,
                        params=dense, teacher_params=dense, seed=0,
                        output_dir=out, name="tinyshape",
                        eval_each_epoch=True, save_checkpoints=False,
                        logger=MetricLogger(out, "tinyshape"),
                        device=device)
    cs = result.state.cstate
    ser = _read_series(out, "tinyshape")
    real, exp, am = ser["real"], ser["exp"], ser["argmax"]
    print("[tiny] Real-FLOPs series:",
          " ".join(f"{v * 100:.1f}" for v in real))
    print("[tiny] argmax series:   ",
          " ".join(f"{v * 100:.1f}" for v in am))
    print(f"[tiny] compressed acc: {result.best_acc * 100:.1f}%")
    return tiny_gates(ser, cs), {
        "real_flops_series": real, "exp_flops_series": exp,
        "argmax_flops_series": am,
        "compressed_acc": round(float(result.best_acc), 4),
        "final_z": round(float(cs.z), 4)}


def below_start(dense, cfg, hp, device="cuda"):
    """Scenario "below"'s over-compressed start: (params, cstate) with 9 of
    12 blocks gated shut at logits (1.25, -1.25) (decisive: a hard Gumbel
    draw opens one with probability ~8%), every layer's first head
    removed (``s[:, 0] = 1``) and 16 within-head dims removed
    (``r = 16``)."""
    from uvc_tpu_torch.compress.minimax import init_compression_state

    dev = torch.device(device)
    params = dict(dense)
    g = np.tile(np.array([[-1.0, 1.0]], np.float32), (cfg.depth, 1))
    shut = np.arange(cfg.depth) % 4 != 3       # 9 of 12 shut
    g[shut] = [1.25, -1.25]
    params["block_gating"] = torch.from_numpy(g).to(dev)
    cs0 = init_compression_state(cfg, hp, dev)
    s = cs0.s.clone()
    s[:, 0] = 1.0
    cs0 = cs0.replace(s=s, r=torch.full_like(cs0.r, 16.0))
    return params, cs0


def run_scenario_below(out, cfg, dtype, dense, train, test, device="cuda"):
    """Budget-from-below (base-log regime: dual relaxes, FLOPs rise)."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger

    hp = _uvc_hp(MinimaxHParams)
    thp = _thp(TrainHParams, EPOCHS_BELOW, 0, dtype)
    params, cs0 = below_start(dense, cfg, hp, device)
    result = run_stage1(cfg, hp, thp, train_loader=train, test_loader=test,
                        params=params, teacher_params=dense, seed=0,
                        output_dir=out, name="below", eval_each_epoch=True,
                        save_checkpoints=False,
                        logger=MetricLogger(out, "below"),
                        init_cstate=cs0, device=device)
    cs = result.state.cstate
    ser = _read_series(out, "below")
    real, am, zs = ser["real"], ser["argmax"], ser["z"]
    z_final = float(cs.z)
    print("[below] Real-FLOPs series:",
          " ".join(f"{v * 100:.1f}" for v in real))
    print("[below] argmax series:   ",
          " ".join(f"{v * 100:.1f}" for v in am))
    print("[below] z series:        ",
          " ".join(f"{v:.2f}" for v in zs))
    print(f"[below] compressed acc: {result.best_acc * 100:.1f}%  "
          f"final z: {z_final:.3f}")
    return below_gates(ser, cs), {
        "real_flops_series": real, "argmax_flops_series": am,
        "z_series": [round(v, 4) for v in zs],
        "compressed_acc": round(float(result.best_acc), 4),
        "final_z": round(z_final, 4)}


def run(out, scenario="both", pretrain_cache=None, device="cuda"):
    """The pretrain and the scenarios in ``out``.  Returns (record, each
    stage's wall seconds)."""
    from uvc_tpu_torch.interop import resolve_device

    t0 = time.time()
    dev = resolve_device(device)
    secs = {}

    def timed(stage, fn, *args):
        t = time.time()
        res = fn(*args, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[stage] = time.time() - t
        return res

    # one loader per phase: TextureLoader's stream is stateful, so a
    # shared loader would make each phase's data depend on the batches
    # the previous phases drew (a pretrain-cache hit would then change the
    # scenarios' trajectories)
    test = TextureLoader(BATCH, EVAL_BATCHES, seed=99)
    cfg, dtype, dense, pre_acc, cached = timed(
        "pretrain", run_pretrain, out, TextureLoader(BATCH, STEPS, seed=0),
        test, pretrain_cache)
    print(f"pretrain acc: {pre_acc * 100:.1f}%")

    gates, payload = {}, {"pretrain_acc": round(pre_acc, 4),
                          "pretrain_from_cache": cached}
    if scenario in ("both", "tiny"):
        g, p = timed("tiny", run_scenario_tiny, out, cfg, dtype, dense,
                     TextureLoader(BATCH, STEPS, seed=10), test)
        gates.update(g)
        payload["tiny"] = p
    if scenario in ("both", "below"):
        g, p = timed("below", run_scenario_below, out, cfg, dtype, dense,
                     TextureLoader(BATCH, STEPS, seed=11), test)
        gates.update(g)
        payload["below"] = p

    backend, device_name = device_record(dev)
    record = {
        "harness": "trajectory_fidelity",
        "golden_source": "reference log/deit-tiny-log.log (descent "
                         "to 42.71% @ budget 0.5) + "
                         "log/deit-base-log.log (rise 33.8->50.3%)",
        "backend": backend,
        "device": device_name,
        "ok": all(gates.values()), "wall_s": round(time.time() - t0, 1),
        "gates": {k: bool(v) for k, v in gates.items()},
        **payload,
    }
    return record, secs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the JSON record here")
    ap.add_argument("--scenario", default="both",
                    choices=["both", "tiny", "below"])
    ap.add_argument("--pretrain_cache", default=None,
                    help="pickle path: reuse the dense pretrain across "
                         "harness-development runs (same seed/task)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    opts = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="traj_fid_") as out:
        record, secs = run(out, opts.scenario, opts.pretrain_cache,
                           opts.device)
    print_gates(record["gates"])
    epochs = {"pretrain": PRETRAIN_EPOCHS, "tiny": EPOCHS,
              "below": EPOCHS_BELOW}
    for stage, s in secs.items():
        trained = not (stage == "pretrain" and record["pretrain_from_cache"])
        print(f"stage {stage}: {s:.1f} s wall"
              + (f", {epochs[stage] * STEPS * BATCH / s:.1f} img/s"
                 if trained else " (from the cache)")
              + f" [{record['device']}]", flush=True)
    if opts.out:
        write_record(record, opts.out)
    print("ALL PASS" if record["ok"] else "FAILURES", flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
