"""Baseline pruning trainer CLI (counterpart of
``uvc_tpu/cli/baseline_train.py``).

  # one-shot mask fine-tune
  python -m uvc_tpu_torch.cli.baseline_train \\
      --model_type deit_small_patch16_224 --init_weight deit_small.pth \\
      --init_mask mask.ckpt --epochs 100

  # gradual magnitude pruning
  python -m uvc_tpu_torch.cli.baseline_train --gmp 1 --sparsity 0.5 \\
      --t_start 1000 --delta_t 500 --pruning_times 10

  # evaluation only
  python -m uvc_tpu_torch.cli.baseline_train --eval --resume ck.ckpt

The flags are the JAX package's plus ``--device``: the run computes on the
card unless ``--device cpu`` is given.  Across GPUs it runs as
``joint_train`` does (one process per GPU: torchrun, or ``--coordinator``
/ ``--num_processes`` / ``--process_id``), ``--mp`` the tensor-parallel
size.
"""

from __future__ import annotations

import argparse

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.configs import get_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("uvc_tpu_torch baseline pruning trainer")
    flags.add_common_flags(p)
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--init_mask", default=None, type=str,
                   help="precomputed mask .ckpt (main.py:291-298)")
    p.add_argument("--init_weight", default=None, type=str,
                   help="initial weights (main.py:283-290)")
    p.add_argument("--gmp", default=0, type=int,
                   help="gradual magnitude pruning (engine.py:88-141)")
    p.add_argument("--sparsity", default=0.5, type=float)
    p.add_argument("--t_start", default=1000, type=int)
    p.add_argument("--delta_t", default=500, type=int)
    p.add_argument("--pruning_times", default=10, type=int)
    p.add_argument("--token_selection", default=0, type=int,
                   help="learned token slimming baseline (engine.py:51-57)")
    p.add_argument("--token_number", default=0.7, type=float)
    p.add_argument("--model_ema", default=0, type=int)
    p.add_argument("--model_ema_decay", default=0.99996, type=float)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--repeated_aug", default=1, type=int,
                   help="RASampler 3x repeated augmentation (DeiT recipe)")
    p.add_argument("--aa", default="rand-m9-mstd0.5-inc1", type=str,
                   help="RandAugment policy; 'none' disables")
    p.add_argument("--color-jitter", default=0.4, type=float,
                   help="used only when --aa none (timm precedence)")
    p.add_argument("--train-interpolation", default="bicubic",
                   choices=["bilinear", "bicubic", "nearest"],
                   help="train crop resize filter; bilinear and bicubic "
                        "run on the native path, nearest selects the PIL "
                        "path")
    p.add_argument("--reprob", default=0.25, type=float,
                   help="random erasing probability (on-device, in-step)")
    p.add_argument("--remode", default="pixel", type=str,
                   choices=["pixel", "rand", "const"],
                   help="random-erasing fill: per-pixel gaussian / one "
                        "gaussian per channel / zeros (timm modes)")
    p.add_argument("--recount", default=1, type=int)
    p.add_argument("--drop_path", "--drop-path", default=0.1, type=float,
                   help="stochastic depth rate (main.py:56, :261-262)")
    p.add_argument("--dist-eval", default=1, type=int,
                   help="parity flag (main.py:221-227): each rank "
                        "evaluates its shard, padded with masked -1 "
                        "labels, and the totals are summed over the ranks")
    return p


def main(argv=None):
    p = build_parser()
    args = flags.parse_with_config(p, argv)
    if args.eval and not args.resume:
        p.error("--eval requires --resume <checkpoint>")

    from uvc_tpu_torch.cli.joint_train import setup_mesh, shutdown

    mesh = setup_mesh(args)
    try:
        _run(args, mesh)
    finally:
        shutdown()


def _run(args, mesh):
    from uvc_tpu_torch.baselines.finetune import (build_baseline_eval_step,
                                                  run_baseline)
    from uvc_tpu_torch.baselines.gmp import GMPSchedule
    from uvc_tpu_torch.baselines.pruning import masks_from_flat
    from uvc_tpu_torch.cli.joint_train import build_loaders, load_params
    from uvc_tpu_torch.data.augment import make_train_augment
    from uvc_tpu_torch.interop import resolve_device
    from uvc_tpu_torch.train.stage1 import eval_totals
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, params_of
    from uvc_tpu_torch.utils.logging import MetricLogger
    from uvc_tpu_torch.utils.tree import tree_map

    dev = resolve_device(args.device)
    num_classes = flags.num_classes_for(args.dataset)
    if args.img_size is None:
        args.img_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=num_classes)
    args.num_epochs = args.epochs

    train_loader, test_loader = build_loaders(args, num_classes,
                                              args.img_size, mesh)
    if args.repeated_aug and hasattr(train_loader, "repeated_aug"):
        train_loader.repeated_aug = True
    aug = make_train_augment(args.aa, args.color_jitter,
                             interpolation=args.train_interpolation)
    if aug is not None and hasattr(train_loader, "aug"):
        train_loader.aug = aug
    if hasattr(train_loader, "interpolation"):
        train_loader.interpolation = args.train_interpolation
    thp = flags.to_train_hparams(args, len(train_loader), num_classes)

    def on_device(tree):
        return tree_map(lambda t: t.to(dev), tree)

    t_args = argparse.Namespace(**vars(args))
    t_args.model_path = args.init_weight or args.model_path
    params = on_device(load_params(t_args, cfg))

    wmasks = None
    if args.init_mask:
        wmasks = masks_from_flat(load_checkpoint(args.init_mask), params)

    teacher = None
    if args.distillation_type != "none" and args.teacher_path:
        t_args.model_path = args.teacher_path
        teacher = load_params(t_args, cfg)

    logger = MetricLogger(args.output_dir, args.name,
                          enable_tensorboard=bool(args.enable_writer))
    try:
        logger.info(f"Baseline training parameters {args}")

        if args.eval:
            ck = load_checkpoint(args.resume)
            eval_params = on_device(params_of(ck))
            eval_masks = (masks_from_flat(ck["masks"], eval_params)
                          if ck.get("masks") else None)
            correct, _, count = eval_totals(
                build_baseline_eval_step(cfg, thp), eval_params, eval_masks,
                test_loader, dev, mesh)
            logger.info(f"Eval accuracy {correct / max(count, 1) * 100:.3f}%")
            return

        gmp = None
        if args.gmp:
            gmp = GMPSchedule(sparsity=args.sparsity, t_start=args.t_start,
                              delta_t=args.delta_t,
                              pruning_times=args.pruning_times)

        result = run_baseline(
            cfg, thp, train_loader=train_loader, test_loader=test_loader,
            params=params, wmasks=wmasks, teacher_params=teacher, gmp=gmp,
            token_selection=bool(args.token_selection),
            token_number=args.token_number,
            ema_decay=args.model_ema_decay if args.model_ema else 0.0,
            drop_path_rate=args.drop_path,
            re_prob=args.reprob, re_count=args.recount,
            re_mode=args.remode,
            seed=args.seed, output_dir=args.output_dir, name=args.name,
            resume=args.resume, start_epoch=args.start_epoch, mesh=mesh,
            mp=args.mp, logger=logger, device=dev)
        logger.info(f"Best accuracy: {result.best_acc * 100:.3f}%")
    finally:
        logger.close()


if __name__ == "__main__":
    main()
