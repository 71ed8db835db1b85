"""Gradient-sparsity analysis CLI (counterpart of
``uvc_tpu/cli/show_gradient_sparsity.py``): the gradient of the training
loss summed over ``--num_batches`` batches, reported per leaf by
``uvc_tpu_torch/diagnostics.py``.

  python -m uvc_tpu_torch.cli.show_gradient_sparsity \\
      --model_type deit_tiny_patch16_224 --dataset synthetic --num_batches 4

The flags are the JAX package's plus ``--device``; the forward runs in
bf16, as the JAX CLI's does.
"""

from __future__ import annotations

import argparse

import torch

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.configs import get_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("uvc_tpu_torch gradient sparsity")
    flags.add_common_flags(p)
    p.add_argument("--num_batches", default=4, type=int)
    p.add_argument("--threshold", default=0.0, type=float)
    p.add_argument("--top", default=20, type=int)
    return p


def main(argv=None):
    args = flags.parse_with_config(build_parser(), argv)

    from uvc_tpu_torch.baselines.pruning import tree_grad
    from uvc_tpu_torch.cli.joint_train import build_loaders, load_params
    from uvc_tpu_torch.data.pipeline import (device_prefetch,
                                             normalize_on_device)
    from uvc_tpu_torch.diagnostics import (format_report,
                                           gradient_sparsity_stats)
    from uvc_tpu_torch.interop import resolve_device
    from uvc_tpu_torch.models import get_model
    from uvc_tpu_torch.utils.tree import tree_map

    dev = resolve_device(args.device)
    num_classes = flags.num_classes_for(args.dataset)
    if args.img_size is None:
        args.img_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=num_classes)
    params = tree_map(lambda t: t.to(dev), load_params(args, cfg))
    train, _ = build_loaders(args, num_classes, args.img_size)
    model = get_model(cfg)

    def loss_fn(p, x, y):
        out = model.apply(p, x, cfg, train=True, dtype=torch.bfloat16)
        return -torch.log_softmax(out.logits, dim=-1).gather(
            -1, y[:, None]).mean()

    acc = None
    for i, (x, y) in enumerate(device_prefetch(iter(train), device=dev)):
        if i >= args.num_batches:
            break
        g = tree_grad(loss_fn, params, normalize_on_device(x), y.long())
        acc = g if acc is None else tree_map(torch.add, acc, g)
    stats = gradient_sparsity_stats(acc, threshold=args.threshold)
    print(format_report(stats, args.top))


if __name__ == "__main__":
    main()
