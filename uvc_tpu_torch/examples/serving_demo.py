"""Deployment demonstration: train -> compress -> compact -> export ->
serve (counterpart of ``examples/serving_demo.py``).

Runs the complete user journey on the procedural dataset (no external
data needed) at toy scale:

  1. stage-1 UVC on a small ViT with token selection (trains the token
     scorer the serving path uses),
  2. physical compaction (pruned heads/units sliced out, skipped blocks
     dropped, tokens top-k-slimmed),
  3. export through ``torch.export`` (``infer/export.py``): the serving
     artifact needs only ``uvc_tpu_torch.ops`` on the load side, no
     model code,
  4. reload + classify a batch, comparing the artifact's logits with the
     compact model's.

  $ python -m uvc_tpu_torch.examples.serving_demo      # --device cpu
  ...
  compact model: K/L blocks kept, NN.N% of dense FLOPs
  serving artifact: batches [8] -> logits (8, 10), agree with
  compact top-1 on 8/8

On the card the model computes in bf16 through the sublayer kernels
(the JAX example's f32 is not a dtype they take), on the CPU in f32.
The CLI equivalents are ``python -m uvc_tpu_torch.cli.joint_train`` and
``python -m uvc_tpu_torch.cli.export_compact --export_stablehlo``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

EPOCHS, STEPS, BATCH = 10, 30, 64


def run(device="cuda"):
    """The journey; returns (served logits, compact logits, labels)."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.data.pipeline import (ProceduralLoader,
                                             normalize_on_device)
    from uvc_tpu_torch.infer.compact import (apply_compact,
                                             compact_flops_fraction,
                                             compact_model)
    from uvc_tpu_torch.infer.export import (export_serving, load_serving,
                                            save_serving)
    from uvc_tpu_torch.interop import host_to_device, resolve_device
    from uvc_tpu_torch.scripts import device_dtype
    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger

    dev = resolve_device(device)
    dtype = device_dtype(dev)
    cfg = get_config("testing").replace(
        img_size=32, embed_dim=64, num_heads=2, depth=4, mlp_ratio=4.0,
        num_classes=10)
    ratio = 0.7
    train = ProceduralLoader(BATCH, num_batches=STEPS, img_size=32,
                             num_classes=10, train=True, seed=0)
    test = ProceduralLoader(BATCH, num_batches=4, img_size=32,
                            num_classes=10, train=False, seed=0)

    hp = MinimaxHParams(budget=0.6, gating_weight=5e-4, gating_interval=5,
                        zlr_schedule=(1, 3, 5, 7, 9),
                        enable_patch_gating=2, patch_ratio=ratio)
    thp = TrainHParams(learning_rate=1e-3, warmup_lr=1e-3, warmup_steps=10,
                       t_total=EPOCHS * STEPS, num_epochs=EPOCHS,
                       warmup_epochs=2, num_classes=10, mixup=0.0,
                       cutmix=0.0, distillation_type="none",
                       compute_dtype=dtype)
    with tempfile.TemporaryDirectory(prefix="serving_demo_") as out:
        result = run_stage1(cfg, hp, thp, train_loader=train,
                            test_loader=test, seed=0, output_dir=out,
                            name="demo", save_checkpoints=False,
                            logger=MetricLogger(out, "demo"), device=dev)
        print(f"stage-1 done: best acc {result.best_acc * 100:.1f}%")

        layers, top = compact_model(result.state.params, result.masks, cfg,
                                    dtype=dtype, device=dev)
        frac = compact_flops_fraction(layers, cfg, token_ratio=ratio)
        print(f"compact model: {len(layers)}/{cfg.depth} blocks kept, "
              f"{frac * 100:.1f}% of dense FLOPs")

        path = os.path.join(out, "serve.npz")
        save_serving(path, export_serving(layers, top, cfg, batch_sizes=(8,),
                                          token_ratio=ratio, dtype=dtype))
        model = load_serving(path)      # needs only uvc_tpu_torch.ops

    x, y = next(iter(test))
    x8 = normalize_on_device(host_to_device(torch.from_numpy(x[:8]), dev))
    served = model(x8).float()
    with torch.no_grad():
        out = apply_compact(layers, top, x8, cfg, dtype=dtype,
                            token_ratio=ratio)
    compact = (0.5 * (out.logits + out.logits_kd) if cfg.distilled
               else out.logits).float()
    agree = int((served.argmax(-1) == compact.argmax(-1)).sum())
    correct = int((served.argmax(-1).cpu().numpy() == y[:8]).sum())
    print(f"serving artifact: batches {model.batch_sizes} -> logits "
          f"{tuple(served.shape)}, agree with compact top-1 on {agree}/8, "
          f"correct on {correct}/8")
    return served, compact, y[:8]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
