"""Offline mask generation CLI (counterpart of
``uvc_tpu/cli/generate_mask.py``).

  python -m uvc_tpu_torch.cli.generate_mask --type synflow \\
      --model_type deit_small_patch16_224 --sparsity 0.5 \\
      --pretrained deit_small.pth --save_file mask.ckpt

Types:
  synflow -- 100 rounds of the exponential schedule on an all-ones input
  mag     -- magnitude, one global (or per-leaf, ``--scope local``)
             threshold
  taylor  -- |sum of grad * w| over ``--num_batches`` training batches
  sp      -- structured per-head / per-MLP-unit masks from one batch's
             gradients (also saved as ``<save_file>.structural``)

The flags are the JAX package's plus ``--device``.  The scorers compute in
the dtype of the device: bf16 on the card, where the fused sublayer
kernels take bf16 operands only (the JAX package's kernels cast f32
operands to bf16 too), and f32 on the CPU, where the plain versions hold
the port to the JAX package's f32 scoring.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.configs import get_config
from uvc_tpu_torch.interop import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("uvc_tpu_torch mask generation")
    p.add_argument("--type", required=True,
                   choices=["synflow", "mag", "taylor", "sp"])
    p.add_argument("--sparsity", default=0.5, type=float,
                   help="density to KEEP (reference naming quirk: "
                        "generating_mask.py:62 'density')")
    p.add_argument("--atten_density", default=0.5, type=float)
    p.add_argument("--mlp_density", default=0.5, type=float)
    p.add_argument("--scope", default="global", choices=["global", "local"])
    p.add_argument("--model_type", default="deit_tiny_patch16_224")
    p.add_argument("--pretrained", default=None, type=str,
                   help="checkpoint to score (.ckpt or torch .pth); "
                        "default: random init")
    p.add_argument("--save_file", required=True)
    p.add_argument("--data_dir", default="/data/imagenet")
    p.add_argument("--dataset", default="synthetic",
                   choices=["imagenet", "cifar10", "cifar100", "synthetic"])
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--num_batches", default=1, type=int,
                   help="scoring batches for taylor/sp")
    p.add_argument("--input_size", default=None, type=int,
                   help="default: the model config's native size")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scoring computes: the card (bf16), or "
                        "the plain PyTorch path on the CPU (f32)")
    return p


def load_scored_params(args, cfg):
    """(params on the CPU, cfg): ``--pretrained`` (a ``.ckpt`` scored with
    its own head's class count, else a converted ``.pth`` / ``.npz``) or a
    model drawn from ``--seed``."""
    from uvc_tpu_torch.cli.joint_train import load_weights
    from uvc_tpu_torch.models import get_model
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, params_of
    if not args.pretrained:
        gen = torch.Generator().manual_seed(args.seed)
        return get_model(cfg).init_params(gen, cfg, device="cpu"), cfg
    if not args.pretrained.endswith(".ckpt"):
        return load_weights(args.pretrained, cfg), cfg
    params = params_of(load_checkpoint(args.pretrained))
    # score with the checkpoint's own class count: labels past a narrower
    # head would make every gradient score meaningless
    head_classes = int(params["head"]["kernel"].shape[-1])
    if head_classes != cfg.num_classes:
        print(f"warning: checkpoint head has {head_classes} classes, "
              f"dataset implies {cfg.num_classes}; scoring with "
              f"{head_classes} (scoring batches are filtered to "
              f"labels the loaded head can express)")
        cfg = cfg.replace(num_classes=head_classes)
    return params, cfg


def scoring_batches(args, cfg, num_classes: int, dev):
    """The first ``--num_batches`` training batches, normalized on
    ``dev``, with the samples whose labels the head cannot express
    dropped (not aliased); SystemExit when none is left."""
    from uvc_tpu_torch.cli.joint_train import build_loaders
    from uvc_tpu_torch.data.pipeline import normalize_on_device
    ns = argparse.Namespace(
        dataset=args.dataset, data_dir=args.data_dir,
        train_batch_size=args.batch_size, eval_batch_size=args.batch_size,
        seed=args.seed, synthetic_steps=args.num_batches, num_workers=8,
        img_size=args.input_size)
    train, _ = build_loaders(ns, num_classes, args.input_size)
    out = []
    for i, (x, y) in enumerate(train):
        if i >= args.num_batches:
            break
        x, y = np.asarray(x), np.asarray(y)
        keep = y < cfg.num_classes
        if not keep.all():
            x, y = x[keep], y[keep]
        if y.size == 0:
            continue
        out.append((normalize_on_device(torch.from_numpy(x).to(dev)),
                    torch.from_numpy(y).long().to(dev)))
    if not out:
        raise SystemExit(
            f"no scoring samples have labels < the checkpoint head "
            f"width ({cfg.num_classes}); use a checkpoint matching "
            f"the dataset or score with --type mag/synflow")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    from uvc_tpu_torch.baselines import pruning
    from uvc_tpu_torch.models import get_model
    from uvc_tpu_torch.utils.checkpoint import save_checkpoint
    from uvc_tpu_torch.utils.tree import tree_map

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    num_classes = flags.num_classes_for(args.dataset)
    if args.input_size is None:
        args.input_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.input_size, num_classes=num_classes)
    params, cfg = load_scored_params(args, cfg)
    params = tree_map(lambda t: torch.as_tensor(t).float().to(dev), params)
    model = get_model(cfg)

    def loss_fn(p, x, y):
        out = model.apply(p, x, cfg, train=True, dtype=dtype)
        # scoring_batches keeps only labels the head can express
        return -torch.log_softmax(out.logits, dim=-1).gather(
            -1, y[:, None]).mean()

    def threshold(scores):
        if args.scope == "global":
            return pruning.global_threshold_mask(scores, args.sparsity)
        return pruning.local_threshold_mask(scores, args.sparsity)

    if args.type == "mag":
        masks = threshold(pruning.magnitude_scores(params))
    elif args.type == "synflow":
        ones = torch.ones(1, cfg.img_size, cfg.img_size, cfg.in_chans,
                          device=dev)

        def forward_sum(p):
            out = model.apply(p, ones, cfg, train=False, dtype=dtype)
            total = out.logits.sum()
            return total + out.logits_kd.sum() if cfg.distilled else total

        _, masks = pruning.synflow_scores(params, forward_sum,
                                          args.sparsity, epochs=100)
    elif args.type == "taylor":
        masks = threshold(pruning.taylor_scores(
            params, loss_fn, scoring_batches(args, cfg, num_classes, dev)))
    else:  # sp
        x, y = scoring_batches(args, cfg, num_classes, dev)[0]
        grads = pruning.tree_grad(loss_fn, params, x, y)
        structural = pruning.sp_structured_masks(
            params, grads, cfg, args.atten_density, args.mlp_density)
        masks = pruning.head_masks_to_weight_masks(
            structural["attn"], structural["mlp"], params, cfg)
        save_checkpoint(args.save_file + ".structural", structural)

    remain = pruning.mask_sparsity(masks)
    print(f"* remain weight = {remain * 100:.4f} %")
    save_checkpoint(args.save_file, pruning.masks_to_flat(masks))
    print(f"saved mask to {args.save_file}")


if __name__ == "__main__":
    main()
