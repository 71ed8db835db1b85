"""Full-recipe accuracy evidence: dense -> stage-1 -> stage-2 -> serving
(counterpart of ``scripts/e2e_accuracy.py``, whose docstring tells the
task's history and each gate's reason).

  phase A  dense pretrain at the real DeiT-Tiny shape (64 px, 50-class
           procedural task, ``data/pipeline.py::ProceduralLoader``; eval
           is a held-out noise stream, so accuracy measures
           generalization), extended 2 epochs at a time until the dense
           accuracy reaches DENSE_TARGET or DENSE_EPOCHS_MAX epochs
  phase B  stage-1 UVC (budget 0.5, the published tiny recipe compressed
           2x) with token selection (ratio 0.7)
  phase C  stage-2 post-training on the discovered architecture (frozen
           gating, masked fine-tune, soft KD from the dense teacher)
  phase D  physical compaction (``infer/compact.py``) + token-slimmed
           serving, evaluated on the same held-out stream

Gates (``e2e_gates``, word for word the JAX harness's):
  A1  0.72 <= dense accuracy <= 0.97
  A2  stage-2 accuracy >= dense - 0.06
  A3  stage-1 final Real FLOPs <= 0.62
  A4  compact (all tokens) accuracy >= masked-dense full-token - 0.01
  A5  token-slimmed serving accuracy >= stage-2 - 0.06
  A6  compact FLOPs fraction <= Real FLOPs + 0.05
  A7  slimmed compact accuracy >= masked-dense (same token drop) - 0.02
  A8  stage-2 accuracy <= 0.985 (saturation guard)
  A9  slimmed accuracy <= 0.985 (saturation guard)

Every stage computes in the device's dtype: bf16 on the card, whose
sublayer kernels take bf16 only, f32 on the CPU.  The masked-dense
oracles too: the JAX harness asks for f32 there, which its Pallas kernels
compute in bf16 all the same.  The torch generator's streams are not
JAX's PRNG's, so the series differ from the TPU records'; the gates are
the comparison.

Usage:  python -m uvc_tpu_torch.scripts.e2e_accuracy --seed 0 \\
            --out E2EACC_h100_seed0.json       # --device cpu: the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from uvc_tpu_torch.scripts import (device_dtype, device_record, print_gates,
                                   write_record)

EPOCHS = 15
WARMUP = 1
PRETRAIN_EPOCHS = 7   # the contrast-spectrum task needs ~7 epochs for a
                      # decent dense baseline
STAGE2_EPOCHS = 8
STEPS = 100
BATCH = 128
CLASSES = 50
IMG = 64
TOKEN_RATIO = 0.7
EVAL_BATCHES = 5
# the dense pretrain is extended 2 epochs at a time until its accuracy
# reaches DENSE_TARGET or it has trained DENSE_EPOCHS_MAX epochs
DENSE_TARGET = 0.75
DENSE_EPOCHS_MAX = 13
# difficulty: a per-image contrast spectrum (see ProceduralLoader), the
# range whose long-budget dense ceiling (0.973) clears the 0.985
# saturation guards
HARD = dict(contrast_range=(0.22, 0.45), noise_mode="lowpass", jitter=0,
            freq=4.0)
# the record's keys, those of the JAX harness's
RECORD_KEYS = (
    "harness", "golden_source", "backend", "device", "ok", "seed", "wall_s",
    "gates", "dense_acc", "dense_epochs", "stage1_acc", "stage2_acc",
    "compact_acc", "slim_acc", "masked_dense_full_acc",
    "masked_dense_slim_acc", "hard_settings", "real_flops_final",
    "compact_flops_fraction", "blocks_kept", "token_ratio")


def make_config():
    """DeiT-Tiny (distilled) at IMG px and CLASSES classes."""
    from uvc_tpu_torch.configs import get_config
    return get_config("deit_tiny_distilled_patch16_224").replace(
        img_size=IMG, num_classes=CLASSES)


def recipe():
    """Each stage's (MinimaxHParams, TrainHParams) keyword arguments, the
    JAX harness's, at the module's sizes (the compute dtype comes from the
    device): the dense pretrain, stage 1 (the published tiny recipe, its
    epoch axis compressed 2x, with token selection) and stage 2 (the
    stage-1 MinimaxHParams, read for the token drop)."""
    uvc = dict(
        budget=0.5, slr=0.02, rlr=0.02, glr=0.1, ylr=2e-4, plr=2e-4,
        zlr_schedule=(2, 10, 18, 26, 34), gating_interval=10,
        gating_weight=5e-4,         # published tiny recipe (see fidelity)
        eps=0.1, eps_decay=0.92, use_gumbel=True,
        enable_block_gating=True, enable_part_gating=False,
        enable_patch_gating=2, patch_ratio=TOKEN_RATIO)
    return {
        "pretrain": (
            dict(enable_patch_gating=0, enable_pruning=False),
            dict(learning_rate=1e-3, warmup_lr=1e-3, weight_decay=0.05,
                 warmup_steps=0, t_total=PRETRAIN_EPOCHS * STEPS,
                 num_epochs=PRETRAIN_EPOCHS, warmup_epochs=PRETRAIN_EPOCHS,
                 num_classes=CLASSES, mixup=0.0, cutmix=0.0, smoothing=0.1,
                 distillation_type="none")),
        "stage1": (uvc, dict(
            learning_rate=1e-4, warmup_lr=1e-4, weight_decay=0.05,
            warmup_steps=25, t_total=EPOCHS * STEPS, num_epochs=EPOCHS,
            warmup_epochs=WARMUP, num_classes=CLASSES, mixup=0.8,
            cutmix=1.0, distillation_type="soft", distillation_alpha=0.1,
            distillation_tau=1.0)),
        "stage2": (uvc, dict(
            learning_rate=5e-4, warmup_lr=1e-5, weight_decay=0.05,
            warmup_steps=50, t_total=STAGE2_EPOCHS * STEPS,
            num_epochs=STAGE2_EPOCHS, warmup_epochs=0, num_classes=CLASSES,
            mixup=0.8, cutmix=1.0, distillation_type="soft",
            distillation_alpha=0.1, distillation_tau=1.0)),
    }


def _fused(out, cfg):
    return 0.5 * (out.logits + out.logits_kd) if cfg.distilled \
        else out.logits


@torch.no_grad()
def serving_logits(layers, top, cfg, x, *, token_ratio=None, dtype):
    """The compact model's logits on a normalized batch ``x``."""
    from uvc_tpu_torch.infer.compact import apply_compact
    return _fused(apply_compact(layers, top, x, cfg, dtype=dtype,
                                token_ratio=token_ratio), cfg)


@torch.no_grad()
def masked_dense_logits(params, masks, cfg, x, *, token_ratio=None,
                        gating_distrib=None, dtype):
    """Reference-style serving's logits: masked weights at dense cost, with
    the frozen block decision ``gating_distrib``; ``token_ratio`` set, the
    deterministic masked token drop (ghost rows retained)."""
    from uvc_tpu_torch.models import vit
    return _fused(vit.apply(params, x, cfg, masks=masks,
                            gating_distrib=gating_distrib,
                            patch_gate_mode=(2 if token_ratio else 0),
                            patch_ratio=(token_ratio or 1.0),
                            rng=None, train=False, dtype=dtype), cfg)


def _accuracy(logits_of, loader, dev):
    from uvc_tpu_torch.data.pipeline import (device_prefetch,
                                             normalize_on_device)
    hits = total = 0
    for x, y in device_prefetch(iter(loader), device=dev):
        pred = logits_of(normalize_on_device(x)).argmax(-1)
        hits += int((pred == y.long()).sum())
        total += len(y)
    return hits / total


def serving_accuracy(layers, top, cfg, loader, *, token_ratio=None,
                     device="cuda", dtype=None):
    """Top-1 accuracy of the compact model over ``loader``; ``dtype`` (the
    one the model was compacted in) defaults to the device's."""
    dev = torch.device(device)
    dtype = dtype or device_dtype(dev)
    return _accuracy(lambda x: serving_logits(
        layers, top, cfg, x, token_ratio=token_ratio, dtype=dtype),
        loader, dev)


def masked_dense_accuracy(params, masks, cfg, loader, *, token_ratio=None,
                          gating_distrib=None, device="cuda", dtype=None):
    """Top-1 accuracy of ``masked_dense_logits`` over ``loader``:
    ``token_ratio`` None, the compaction-losslessness oracle (A4); set,
    the oracle of the slimmed artifact's drift (A7).  ``dtype`` defaults
    to the device's."""
    dev = torch.device(device)
    dtype = dtype or device_dtype(dev)
    return _accuracy(lambda x: masked_dense_logits(
        params, masks, cfg, x, token_ratio=token_ratio,
        gating_distrib=gating_distrib, dtype=dtype), loader, dev)


class _EpochOffset:
    """ProceduralLoader batches derive from (seed, epoch) tags, and
    run_stage1 numbers each run's epochs from 1: an offset keeps every
    extension chunk on fresh stream tags instead of replaying the main
    run's epoch-1/2 batches."""

    def __init__(self, loader, off):
        self._loader, self._off = loader, off

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch):
        self._loader.set_epoch(epoch + self._off)

    def __iter__(self):
        return iter(self._loader)

    def __getattr__(self, name):          # batch_size etc.
        return getattr(self._loader, name)


def e2e_gates(record) -> dict:
    """Gates A1-A9 of a record's numbers."""
    dense_acc = record["dense_acc"]
    stage2_acc = record["stage2_acc"]
    final_flops = record["real_flops_final"]
    compact_acc = record["compact_acc"]
    md_full_acc = record["masked_dense_full_acc"]
    slim_acc = record["slim_acc"]
    frac = record["compact_flops_fraction"]
    md_slim_acc = record["masked_dense_slim_acc"]
    return {
        "A1 0.72 <= dense acc <= 0.97":
            0.72 <= dense_acc <= 0.97,
        "A2 stage-2 acc >= dense - 0.06": stage2_acc >= dense_acc - 0.06,
        "A3 stage-1 real FLOPs <= 0.62": final_flops <= 0.62,
        "A4 compact acc >= masked-dense full - 0.01":
            compact_acc >= md_full_acc - 0.01,
        "A5 slimmed acc >= stage-2 - 0.06": slim_acc >= stage2_acc - 0.06,
        "A6 compact FLOPs <= real + 0.05": frac <= final_flops + 0.05,
        "A7 slim acc >= masked-dense slim - 0.02":
            slim_acc >= md_slim_acc - 0.02,
        "A8 stage-2 acc <= 0.985 (unsaturated)": stage2_acc <= 0.985,
        "A9 slim acc <= 0.985 (unsaturated)": slim_acc <= 0.985,
    }


def read_flops_real(out, name):
    """The ``train/flops_real`` series of a run's ``metrics.jsonl``."""
    real = []
    with open(os.path.join(out, name, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if "train/flops_real" in rec:
                real.append(rec["train/flops_real"])
    return real


def run(seed, out, device="cuda"):
    """The four phases in ``out``.  Returns (record, what the record was
    computed from: the config, loaders, dense params, stage 1's result,
    stage-2 params, masks, compact model, frozen decision and the stage
    timings)."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.data.pipeline import ProceduralLoader
    from uvc_tpu_torch.infer.compact import (compact_flops_fraction,
                                             compact_model)
    from uvc_tpu_torch.interop import resolve_device
    from uvc_tpu_torch.train.stage1 import copy_tree, run_stage1
    from uvc_tpu_torch.train.stage2 import run_stage2
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger

    t0 = time.time()
    dev = resolve_device(device)
    cfg = make_config()
    train = ProceduralLoader(BATCH, num_batches=STEPS, img_size=IMG,
                             num_classes=CLASSES, train=True, seed=seed,
                             **HARD)
    test = ProceduralLoader(BATCH, num_batches=EVAL_BATCHES, img_size=IMG,
                            num_classes=CLASSES, train=False, seed=seed,
                            **HARD)
    dtype = device_dtype(dev)
    secs = {}

    def timed(stage, fn):
        t = time.time()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[stage] = secs.get(stage, 0.0) + time.time() - t
        return res

    # ---- phase A: dense pretrain ----
    def hparams(stage):
        hp_kw, thp_kw = recipe()[stage]
        return (MinimaxHParams(**hp_kw),
                TrainHParams(**thp_kw, compute_dtype=dtype))

    hp_pre, thp_pre = hparams("pretrain")
    pre = timed("pretrain", lambda: run_stage1(
        cfg, hp_pre, thp_pre, train_loader=train, test_loader=test,
        seed=seed, output_dir=out, name="dense", eval_each_epoch=True,
        save_checkpoints=False, logger=MetricLogger(out, "dense"),
        device=dev))
    # the student's start and the teacher: a copy the drivers never alias
    dense = copy_tree(pre.state.params)
    # the accuracy of the carried params (direct eval), not run_stage1's
    # best epoch: stage 1 starts from them and the teacher serves them
    dense_acc = masked_dense_accuracy(dense, None, cfg, test, device=dev)

    # train to proficiency: extend in 2-epoch chunks until the dense
    # baseline clears the A1 floor with margin (or the ceiling)
    total_ep = PRETRAIN_EPOCHS
    while dense_acc < DENSE_TARGET and total_ep < DENSE_EPOCHS_MAX:
        cont = timed("pretrain", lambda: run_stage1(
            cfg, hp_pre,
            dataclasses.replace(thp_pre, t_total=2 * STEPS, num_epochs=2,
                                warmup_epochs=2),
            train_loader=_EpochOffset(train, total_ep), test_loader=test,
            params=dense, seed=seed + total_ep, output_dir=out,
            name=f"dense_ext{total_ep}", eval_each_epoch=True,
            save_checkpoints=False,
            logger=MetricLogger(out, f"dense_ext{total_ep}"), device=dev))
        dense = copy_tree(cont.state.params)
        dense_acc = masked_dense_accuracy(dense, None, cfg, test, device=dev)
        total_ep += 2
        print(f"[A] dense extended to {total_ep} epochs: "
              f"acc {dense_acc * 100:.1f}%", flush=True)
    print(f"[A] dense acc {dense_acc * 100:.1f}% ({total_ep} epochs)",
          flush=True)

    # ---- phase B: stage-1 UVC with token selection ----
    hp, thp = hparams("stage1")
    s1 = timed("stage1", lambda: run_stage1(
        cfg, hp, thp, train_loader=train, test_loader=test, params=dense,
        teacher_params=dense, seed=seed, output_dir=out, name="stage1",
        eval_each_epoch=True, save_checkpoints=False,
        logger=MetricLogger(out, "stage1"), device=dev))
    real = read_flops_real(out, "stage1")
    final_flops = float(np.mean(real[-3:]))
    print(f"[B] stage-1 acc {s1.best_acc * 100:.1f}% "
          f"real FLOPs {final_flops * 100:.1f}%", flush=True)

    # ---- phase C: stage-2 post-training ----
    _, thp2 = hparams("stage2")
    s2 = timed("stage2", lambda: run_stage2(
        cfg, hp, thp2, params=s1.state.params, masks=s1.masks,
        teacher_params=dense, train_loader=train, test_loader=test,
        seed=seed, output_dir=out, name="post", eval_every=STEPS,
        world_batch=BATCH, save_checkpoints=False,
        logger=MetricLogger(out, "post"), device=dev))
    stage2_acc = float(s2.best_acc)
    print(f"[C] stage-2 acc {stage2_acc * 100:.1f}%", flush=True)

    # ---- phase D: physical compaction + slimmed serving ----
    t = time.time()
    params2 = s2.state.params
    g = params2["block_gating"].detach().float().cpu().numpy()
    block_keep = g[:, 1] > g[:, 0]               # stage-2 frozen decision
    layers, top = compact_model(params2, s1.masks, cfg,
                                block_keep=block_keep, dtype=dtype,
                                device=dev)
    frac = compact_flops_fraction(layers, cfg)
    compact_acc = serving_accuracy(layers, top, cfg, test, device=dev)
    slim_acc = serving_accuracy(layers, top, cfg, test,
                                token_ratio=TOKEN_RATIO, device=dev)
    # the masked-dense oracles at the same architecture: full-token (A4)
    # and the reference-style masked token drop (A7)
    gd = torch.from_numpy(np.stack(
        [1.0 - block_keep, block_keep.astype(np.float64)],
        axis=1).astype(np.float32)).to(dev)
    md_full_acc = masked_dense_accuracy(
        params2, s1.masks, cfg, test, gating_distrib=gd, device=dev)
    md_slim_acc = masked_dense_accuracy(
        params2, s1.masks, cfg, test, token_ratio=TOKEN_RATIO,
        gating_distrib=gd, device=dev)
    secs["serving"] = time.time() - t
    print(f"[D] {len(layers)}/{cfg.depth} blocks, compact FLOPs "
          f"{frac * 100:.1f}%: acc compact {compact_acc * 100:.1f}% "
          f"slim {slim_acc * 100:.1f}% "
          f"masked-dense full {md_full_acc * 100:.1f}% "
          f"slim {md_slim_acc * 100:.1f}%", flush=True)

    numbers = {
        "dense_acc": dense_acc, "stage2_acc": stage2_acc,
        "real_flops_final": final_flops, "compact_acc": compact_acc,
        "masked_dense_full_acc": md_full_acc, "slim_acc": slim_acc,
        "compact_flops_fraction": float(frac),
        "masked_dense_slim_acc": md_slim_acc}
    gates = e2e_gates(numbers)
    backend, device_name = device_record(dev)
    record = {
        "harness": "e2e_accuracy",
        "golden_source": "reference log/deit-small-5041-7882.log "
                         "(top-1 0.78822 at ~50% FLOPs after "
                         "stage 2); no ImageNet in this "
                         "environment — procedural generalization "
                         "task at DeiT-Tiny shape instead",
        "backend": backend,
        "device": device_name,
        "ok": all(gates.values()), "seed": seed,
        "wall_s": round(time.time() - t0, 1),
        "gates": {k: bool(v) for k, v in gates.items()},
        "dense_acc": round(dense_acc, 4),
        "dense_epochs": total_ep,
        "stage1_acc": round(float(s1.best_acc), 4),
        "stage2_acc": round(stage2_acc, 4),
        "compact_acc": round(compact_acc, 4),
        "slim_acc": round(slim_acc, 4),
        "masked_dense_full_acc": round(md_full_acc, 4),
        "masked_dense_slim_acc": round(md_slim_acc, 4),
        "hard_settings": HARD,
        "real_flops_final": round(final_flops, 4),
        "compact_flops_fraction": round(float(frac), 4),
        "blocks_kept": len(layers),
        "token_ratio": TOKEN_RATIO,
    }
    return record, dict(cfg=cfg, train=train, test=test, dense=dense,
                        stage1=s1, params=params2, masks=s1.masks,
                        layers=layers,
                        top=top, gating_distrib=gd, dtype=dtype,
                        seconds=secs, real_flops=real,
                        images={"pretrain": total_ep * STEPS * BATCH,
                                "stage1": EPOCHS * STEPS * BATCH,
                                "stage2": STAGE2_EPOCHS * STEPS * BATCH})


def print_stage_times(art, device):
    """Each stage's wall seconds (its evaluations included) and the
    trainings' images over them."""
    for stage, secs in art["seconds"].items():
        rate = art["images"].get(stage)
        print(f"stage {stage}: {secs:.1f} s wall"
              + (f", {rate / secs:.1f} img/s" if rate else "")
              + f" [{device}]", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the JSON record here")
    ap.add_argument("--seed", type=int, default=0,
                    help="task + training seed: the procedural class "
                         "templates derive from it (so train and eval "
                         "loaders share it), as do init and the Gumbel "
                         "streams")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    opts = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="e2e_acc_") as out:
        record, art = run(opts.seed, out, opts.device)
    print_gates(record["gates"])
    print_stage_times(art, record["device"])
    if opts.out:
        write_record(record, opts.out)
    print("ALL PASS" if record["ok"] else "FAILURES", flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
