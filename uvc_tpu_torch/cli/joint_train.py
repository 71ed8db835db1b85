"""Stage-1 CLI: joint UVC training, then the inline stage-2 fine-tune
(counterpart of ``uvc_tpu/cli/joint_train.py``).

  python -m uvc_tpu_torch.cli.joint_train \\
      --model_type deit_small_patch16_224 --dataset imagenet \\
      --data_dir /data/imagenet --budget 0.5 --num_epochs 30 \\
      --warmup_epochs 5 --train_batch_size 512

The flags are the JAX package's (``cli/flags.py``) plus ``--device``: the
run computes on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import torch

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.configs import get_config
from uvc_tpu_torch.train.stage1 import MULTI_DEVICE


def check_single_device(args) -> None:
    """Raise unless the run is single-device: ``--dp 1 --mp 1``, or one
    device visible with no mesh or process group asked for."""
    if (args.num_processes or 1) > 1 or args.coordinator:
        raise NotImplementedError(MULTI_DEVICE)
    if args.dp == 1 and args.mp == 1:
        return
    visible = torch.cuda.device_count() if args.device == "cuda" else 1
    if (args.dp or 1) > 1 or args.mp > 1 or visible > 1:
        raise NotImplementedError(MULTI_DEVICE)


def build_loaders(args, num_classes: int, img_size: int):
    from uvc_tpu_torch.data.pipeline import (ArrayLoader, FolderLoader,
                                             ProceduralLoader,
                                             SyntheticLoader, cifar_arrays)
    pid, pcount = 0, 1           # one process (ROADMAP.md queue A item 7)
    per_host_train = args.train_batch_size // pcount
    if args.dataset == "procedural":
        train = ProceduralLoader(per_host_train,
                                 num_batches=args.synthetic_steps,
                                 img_size=img_size,
                                 num_classes=num_classes, train=True,
                                 seed=args.seed, pid=pid, pcount=pcount)
        test = ProceduralLoader(args.eval_batch_size, num_batches=8,
                                img_size=img_size, num_classes=num_classes,
                                train=False, seed=args.seed)
        return train, test
    if args.dataset == "synthetic":
        train = SyntheticLoader(per_host_train,
                                num_batches=args.synthetic_steps,
                                img_size=img_size, num_classes=num_classes,
                                seed=args.seed)
        test = SyntheticLoader(args.eval_batch_size, num_batches=4,
                               img_size=img_size, num_classes=num_classes,
                               seed=args.seed + 1)
        return train, test
    if args.dataset in ("cifar10", "cifar100"):
        xtr, ytr = cifar_arrays(args.data_dir, args.dataset, train=True)
        xte, yte = cifar_arrays(args.data_dir, args.dataset, train=False)
        train = ArrayLoader(xtr, ytr, per_host_train, train=True,
                            img_size=img_size, seed=args.seed, pid=pid,
                            pcount=pcount)
        test = ArrayLoader(xte, yte, args.eval_batch_size, train=False,
                           img_size=img_size, pid=pid, pcount=pcount)
        return train, test
    train = FolderLoader(os.path.join(args.data_dir, "train"),
                         per_host_train, train=True, img_size=img_size,
                         seed=args.seed, num_workers=args.num_workers,
                         pid=pid, pcount=pcount)
    test = FolderLoader(os.path.join(args.data_dir, "val"),
                        args.eval_batch_size, train=False,
                        img_size=img_size, num_workers=args.num_workers,
                        pid=pid, pcount=pcount)
    return train, test


def load_weights(path: str, cfg):
    """The parameter tree of a weights file, on the CPU: a ``.ckpt`` of
    either package (its ``params``, lists rebuilt), an upstream ViT or
    R50+ViT ``.npz``, else a timm / torch ``.pth`` (both through
    ``models/convert.py``)."""
    from uvc_tpu_torch.models import convert
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, params_of
    if path.endswith(".ckpt"):
        return params_of(load_checkpoint(path))
    if path.endswith(".npz"):
        return convert.load_npz_checkpoint(path, cfg)
    return convert.load_torch_checkpoint(path, cfg)


def load_params(args, cfg, generator=None):
    """The weights of ``--model_path`` (``load_weights``) or, without it,
    a model drawn from ``generator`` (seeded from ``--seed``) on
    ``--device``."""
    from uvc_tpu_torch.models import get_model
    if args.pretrained and args.model_path:
        return load_weights(args.model_path, cfg)
    generator = generator or torch.Generator().manual_seed(args.seed)
    return get_model(cfg).init_params(
        generator, cfg,
        patch_gating=getattr(args, "enable_patch_gating", 0) == 1,
        device=args.device)


def load_teacher(args, cfg, params):
    """The distillation teacher: ``--teacher-path`` (else
    ``--model_path``) when distilling, else the student's weights."""
    teacher_path = args.teacher_path or args.model_path
    if args.distillation_type != "none" and teacher_path:
        t_args = argparse.Namespace(**vars(args))
        t_args.model_path = teacher_path
        return load_params(t_args, cfg)
    return params


def main(argv=None):
    parser = argparse.ArgumentParser("uvc_tpu_torch stage-1 joint training")
    flags.add_common_flags(parser)
    flags.add_uvc_flags(parser)
    args = flags.parse_with_config(parser, argv)
    check_single_device(args)

    num_classes = flags.num_classes_for(args.dataset)
    if args.img_size is None:
        args.img_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=num_classes,
        distilled=bool(args.enable_deit))

    train_loader, test_loader = build_loaders(args, num_classes,
                                              args.img_size)
    hp = flags.to_hparams(args)
    thp = flags.to_train_hparams(args, len(train_loader), num_classes)

    params = load_params(args, cfg)
    teacher = load_teacher(args, cfg, params)

    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.utils import profiler as prof
    from uvc_tpu_torch.utils.logging import MetricLogger
    logger = MetricLogger(args.output_dir, args.name,
                          enable_tensorboard=bool(args.enable_writer))
    logger.info(f"Training parameters {args}")
    profiler = prof.from_args(args, logger)
    result = run_stage1(cfg, hp, thp, train_loader=train_loader,
                        test_loader=test_loader, params=params,
                        teacher_params=teacher, seed=args.seed,
                        output_dir=args.output_dir, name=args.name,
                        log_interval=args.log_interval,
                        resume=args.resume,
                        use_orbax=bool(args.use_orbax),
                        steps_per_launch=args.steps_per_launch,
                        logger=logger, profiler=profiler,
                        device=args.device)

    # inline stage 2 (reference: joint_train.py:1032-1033)
    from uvc_tpu_torch.train.stage2 import run_stage2
    thp2 = flags.to_train_hparams(args, len(train_loader), num_classes,
                                  stage2=True)
    run_stage2(cfg, hp, thp2, params=result.state.params, masks=result.masks,
               teacher_params=teacher, train_loader=train_loader,
               test_loader=test_loader, seed=args.seed,
               output_dir=args.output_dir, name=args.name + "_post",
               eval_every=args.eval_every,
               world_batch=args.train_batch_size,
               steps_per_launch=args.steps_per_launch, logger=logger,
               device=args.device)


if __name__ == "__main__":
    main()
