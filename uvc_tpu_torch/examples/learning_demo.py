"""End-to-end learning demonstration (no external data needed;
counterpart of ``examples/learning_demo.py``).

Trains DeiT-Tiny (depth 6, 64 px) with the full stage-1 UVC loop on a
learnable synthetic task (10 classes of distinct frequency patterns) and
checks that the system learns while compressing:

  $ python -m uvc_tpu_torch.examples.learning_demo      # --device cpu
  ...
  Validation @ step 128: ... acc ...
  BEST ACC: ...

The joint weight + architecture optimization, gating, masking, eval and
reporting paths, all with real gradient signal; on the card in bf16
through the sublayer kernels, on the CPU in f32.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

IMAGES_TRAIN, IMAGES_TEST = 2048, 512
BATCH = 128
DEPTH = 6
EPOCHS = 8


def make_dataset(rng, n):
    ys = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:64, 0:64]
    imgs = np.empty((n, 64, 64, 3), np.uint8)
    for i, c in enumerate(ys):
        base = np.sin(xx / (2 + c)) * np.cos(yy / (1 + c // 2)) * 100 + 127
        img = np.stack([base] * 3, -1) + rng.normal(0, 40, (64, 64, 3))
        imgs[i] = img.clip(0, 255).astype(np.uint8)
    return imgs, ys.astype(np.int32)


def run(device="cuda"):
    """Stage 1 on the task; returns the driver's result."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.data.pipeline import ArrayLoader
    from uvc_tpu_torch.interop import resolve_device
    from uvc_tpu_torch.scripts import device_dtype
    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    xtr, ytr = make_dataset(rng, IMAGES_TRAIN)
    xte, yte = make_dataset(rng, IMAGES_TEST)
    train = ArrayLoader(xtr, ytr, BATCH, train=True, img_size=64)
    test = ArrayLoader(xte, yte, BATCH, train=False, img_size=64)
    steps = len(train)

    cfg = get_config("deit_tiny_patch16_224").replace(
        img_size=64, num_classes=10, depth=DEPTH)
    hp = MinimaxHParams(budget=0.6, enable_patch_gating=0,
                        gating_interval=10, zlr_schedule=(5,))
    thp = TrainHParams(num_classes=10, t_total=steps * EPOCHS,
                       warmup_steps=10, num_epochs=EPOCHS, warmup_epochs=2,
                       learning_rate=8e-4, mixup=0.0, cutmix=0.0,
                       smoothing=0.1, distillation_type=None,
                       compute_dtype=device_dtype(dev))
    with tempfile.TemporaryDirectory(prefix="uvc_demo_") as out:
        return run_stage1(cfg, hp, thp, train_loader=train,
                          test_loader=test, output_dir=out, name="demo",
                          save_checkpoints=False,
                          logger=MetricLogger(out, "demo"), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    res = run(ap.parse_args(argv).device)
    print("BEST ACC:", res.best_acc)
    assert res.best_acc > 0.5, "model failed to learn"
    return 0


if __name__ == "__main__":
    sys.exit(main())
