"""CLI flag surface (counterpart of ``uvc_tpu/cli/flags.py``).

The same flags with the same defaults as the JAX package's parsers,
inert flags included (--patch_weight, --patch_l1_weight, --patchlr,
--patchloss, --num_steps, --pretrained_dir, --loss_scale, ...).  The
compile cache (--compilation_cache_dir, UVC_COMPILE_CACHE) is inert
here: the kernels' build is cached by nvcc's own output directory,
``build/uvc_tpu_torch/<source hash>/``.  The mesh and multi-process flags
keep their names and defaults, with the port's one process per GPU:
--num_processes counts ranks (GPUs, not hosts), --coordinator /
--process_id place this one (or torchrun's environment does), --mp is
the tensor-parallel size and --dp defaults to the world size over it.
One flag is the port's own: --device,
``cuda`` (the default) or ``cpu``, the counterpart of JAX_PLATFORMS.
"""

from __future__ import annotations

import argparse

import torch

from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import CONFIGS
from uvc_tpu_torch.train.state import TrainHParams
from uvc_tpu_torch.utils import yaml_config


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", default=None, type=str, metavar="FILE",
                   help="YAML file whose keys override flag defaults "
                        "(T2TViT/main.py:38-44 surface)")
    p.add_argument("--name", default="debug",
                   help="Name of this run. Used for monitoring.")
    p.add_argument("--dataset",
                   choices=["cifar10", "cifar100", "imagenet", "synthetic",
                            "procedural"],
                   default="imagenet")
    p.add_argument("--data_dir", default="/data/imagenet")
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run computes: the card, or the plain "
                        "PyTorch path on the CPU")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="INERT (the kernels' build is cached in "
                        "build/uvc_tpu_torch/<source hash>/)")
    p.add_argument("--model_type", choices=sorted(CONFIGS),
                   default="deit_tiny_distilled_patch16_224")
    p.add_argument("--model_path", default=None,
                   help="Pretrained checkpoint (torch .pth or uvc_tpu .ckpt)")
    p.add_argument("--pretrained_dir", type=str, default=None,
                   help="INERT (reference parity)")
    p.add_argument("--pretrained", type=int, default=1)
    p.add_argument("--output_dir", default="output/uvc_train", type=str)
    p.add_argument("--img_size", default=None, type=int,
                   help="default: the model config's native size")
    p.add_argument("--train_batch_size", default=1024, type=int)
    p.add_argument("--eval_batch_size", default=64, type=int)
    p.add_argument("--eval_every", default=1000, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--num_steps", default=10000, type=int,
                   help="INERT (printed but not enforced in the reference)")
    p.add_argument("--num_epochs", default=20, type=int)
    p.add_argument("--decay_type", choices=["cosine", "linear"],
                   default="cosine")
    p.add_argument("--warmup_steps", default=500, type=int)
    p.add_argument("--max_grad_norm", default=1.0, type=float)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--fp16", action="store_true",
                   help="INERT (the compute dtype is bfloat16)")
    p.add_argument("--fp16_opt_level", type=str, default="O2",
                   help="INERT (apex legacy)")
    p.add_argument("--loss_scale", type=float, default=0,
                   help="INERT (bf16 needs no loss scaling)")
    # mixup family
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
    p.add_argument("--mixup-prob", type=float, default=0.8)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", type=str, default="batch")
    # distillation
    p.add_argument("--teacher-model", default=None, type=str)
    p.add_argument("--teacher-path", type=str, default=None)
    p.add_argument("--distillation-type", default="hard",
                   choices=["none", "soft", "hard"])
    p.add_argument("--distillation-alpha", default=0.5, type=float)
    p.add_argument("--distillation-tau", default=1.0, type=float)
    p.add_argument("--smoothing", type=float, default=0.1)
    # distribution: one process per GPU (parallel/mesh.py)
    p.add_argument("--use_distribute", default=1, type=int)
    p.add_argument("--enable_writer", default=0, type=int)
    # device trace capture (utils/profiler.py, torch.profiler)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="capture a TensorBoard-loadable trace here")
    p.add_argument("--profile_start", default=10, type=int,
                   help="global step to start the trace (post-compile)")
    p.add_argument("--profile_steps", default=5, type=int,
                   help="number of steps to trace")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh size (default: all devices)")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel mesh size")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--synthetic_steps", type=int, default=50,
                   help="steps per epoch for --dataset synthetic")
    p.add_argument("--resume", type=str, default=None,
                   help="resume full training state from a .ckpt file "
                        "(either package's) or a checkpoint directory "
                        "written with --use_orbax 1")
    p.add_argument("--use_orbax", default=0, type=int,
                   help="keep the checkpoints in a directory that holds "
                        "the latest 3 (<step>.ckpt) instead of one file "
                        "an epoch")
    p.add_argument("--steps_per_launch", default=1, type=int,
                   help="INERT (the eager step has no multi-step "
                        "program; logged as ignored)")


def add_uvc_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--uvc_train", action="store_true", default=True)
    p.add_argument("--soptim", default="sgd",
                   choices=["sgd", "adam", "rmsprop"])
    p.add_argument("--roptim", default="sgd",
                   choices=["sgd", "adam", "rmsprop"])
    p.add_argument("--zlr_schedule_list", default="10,20,30,40,50", type=str)
    p.add_argument("--ylr", default=1e-4, type=float)
    p.add_argument("--plr", default=1e-4, type=float)
    p.add_argument("--slr", default=0.02, type=float)
    p.add_argument("--rlr", default=0.02, type=float)
    p.add_argument("--glr", default=1e-3, type=float)
    p.add_argument("--log_interval", default=2000, type=int)
    p.add_argument("--save_budgets", default="0.6, 0.5, 0.4",
                   help="INERT (parsed and threaded but never consumed in the reference: uvc_optimizer.py:37 takes save_budgets and ignores it)")
    p.add_argument("--budget", default=0.5)
    p.add_argument("--sl2wd", default=0.0, type=float)
    p.add_argument("--verbose", default=True, action="store_true")
    p.add_argument("--flops_with_mhsa", type=int, default=1)
    p.add_argument("--enable_block_gating", type=int, default=1)
    p.add_argument("--enable_part_gating", type=int, default=0)
    p.add_argument("--enable_jumping", type=int, default=0)
    p.add_argument("--enable_deit", type=int, default=0)
    p.add_argument("--enable_pruning", type=int, default=1)
    p.add_argument("--enable_patch_gating", type=int, default=2)
    p.add_argument("--patch_ratio", type=float, default=0.9)
    p.add_argument("--z_grad_clip", default=0.5, type=float)
    p.add_argument("--gating_interval", default=100, type=int)
    p.add_argument("--gating_weight", default=5, type=float,
                   help="resource-pressure multiplier on the gating grad "
                        "(reference default 5; the published DeiT-Tiny/"
                        "Small runs use 5e-4 — log Namespace)")
    p.add_argument("--patch_weight", default=5, type=float,
                   help="INERT (reference parity)")
    p.add_argument("--patch_l1_weight", default=0.01, type=float,
                   help="INERT (reference parity)")
    p.add_argument("--patchlr", default=0.01, type=float,
                   help="INERT (reference parity)")
    p.add_argument("--patchloss", default="l1", type=str,
                   help="INERT (reference parity)")
    p.add_argument("--use_gumbel", default=1, type=int)
    p.add_argument("--eps", default=0.1, type=float)
    p.add_argument("--eps_decay", default=0.92, type=float)
    p.add_argument("--enable_warmup", default=1, type=int)
    p.add_argument("--warmup_epochs", default=5, type=int)
    p.add_argument("--warmup_lr", default=1e-4, type=float)
    p.add_argument("--warmup_reset", default=0, type=int,
                   help="INERT (scheduler reset quirk not replicated)")
    # post-training args carried on the stage-1 parser (reference parity)
    p.add_argument("--post_learning_rate", default=1e-3, type=float)
    p.add_argument("--post_weight_decay", default=0.05, type=float)
    p.add_argument("--post_num_epochs", default=100, type=int)


def add_stage2_flags(p: argparse.ArgumentParser) -> None:
    """Stage-2 timm ``create_scheduler`` surface (post_train.py:469-482).

    The reference steps the timm scheduler once per epoch
    (post_train.py:350); cosine and step are implemented
    (utils/schedules.py timm_epoch_schedule), the remaining knobs are
    accepted INERT for flag parity.  timm's ``--warmup-lr`` is exposed as
    --sched_warmup_lr because --warmup_lr is already the stage-1 UVC
    constant warmup lr (a different quantity)."""
    p.add_argument("--compact_train", action="store_true",
                   help="fine-tune the PHYSICALLY COMPACTED model "
                        "(train/compact_ft.py): dropped blocks removed, "
                        "pruned heads sliced, kept MLP units lane-padded "
                        "— same kept-coordinate update trajectory as the "
                        "masked-dense step at reduced FLOPs; checkpoints "
                        "stay dense-layout (beyond reference: "
                        "post_train.py computes stage 2 dense)")
    p.add_argument("--sched", default=None, choices=["cosine", "step"],
                   help="per-epoch timm lr schedule; default None keeps "
                        "the per-step warmup schedule (--decay_type)")
    p.add_argument("--min-lr", dest="min_lr", default=1e-5, type=float,
                   help="cosine floor (timm lr_min)")
    p.add_argument("--decay-epochs", dest="decay_epochs", default=30.0,
                   type=float, help="epoch interval for --sched step")
    p.add_argument("--decay-rate", "--dr", dest="decay_rate", default=0.1,
                   type=float, help="decay factor for --sched step")
    p.add_argument("--sched_warmup_lr", default=1e-6, type=float,
                   help="timm --warmup-lr: lr at epoch 0 of the sched "
                        "warmup leg")
    p.add_argument("--cooldown-epochs", dest="cooldown_epochs", default=10,
                   type=int,
                   help="INERT (reference discards create_scheduler's "
                        "extended epoch count: post_train.py:302)")
    p.add_argument("--patience-epochs", dest="patience_epochs", default=10,
                   type=int, help="INERT (plateau sched not selectable)")
    p.add_argument("--lr-noise", dest="lr_noise", type=float, nargs="+",
                   default=None, help="INERT (timm lr noise not replicated)")
    # timm create_optimizer surface (post_train.py:455-466)
    p.add_argument("--opt", default="adamw",
                   choices=["adamw", "sgd", "momentum"],
                   help="weight optimizer family (timm create_optimizer)")
    p.add_argument("--opt-eps", dest="opt_eps", default=1e-8, type=float)
    p.add_argument("--opt-betas", dest="opt_betas", type=float, nargs="+",
                   default=None)
    p.add_argument("--momentum", default=0.9, type=float)


def to_hparams(args) -> MinimaxHParams:
    zlr = tuple(int(v) for v in str(args.zlr_schedule_list).split(","))
    return MinimaxHParams(
        budget=float(args.budget), slr=args.slr, rlr=args.rlr, glr=args.glr,
        ylr=args.ylr, plr=args.plr, zlr_schedule=zlr, sl2wd=args.sl2wd,
        z_grad_clip=args.z_grad_clip, gating_weight=args.gating_weight,
        gating_interval=args.gating_interval, soptim=args.soptim,
        roptim=args.roptim,
        flops_with_mhsa=bool(getattr(args, "flops_with_mhsa", 1)),
        use_gumbel=bool(args.use_gumbel), eps=args.eps,
        eps_decay=args.eps_decay,
        enable_block_gating=bool(args.enable_block_gating),
        enable_part_gating=bool(args.enable_part_gating),
        enable_patch_gating=args.enable_patch_gating,
        enable_jumping=bool(args.enable_jumping),
        enable_pruning=bool(args.enable_pruning),
        patch_ratio=args.patch_ratio)


def to_train_hparams(args, steps_per_epoch: int, num_classes: int,
                     stage2: bool = False) -> TrainHParams:
    lr = args.post_learning_rate if stage2 and \
        hasattr(args, "post_learning_rate") else args.learning_rate
    wd = args.post_weight_decay if stage2 and \
        hasattr(args, "post_weight_decay") else args.weight_decay
    epochs = args.post_num_epochs if stage2 and \
        hasattr(args, "post_num_epochs") else args.num_epochs
    gas = max(1, getattr(args, "gradient_accumulation_steps", 1))
    return TrainHParams(
        learning_rate=lr, weight_decay=wd,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.warmup_steps,
        # the lr schedule ticks on accumulation boundaries
        # (scheduler.step() inside the boundary branch, joint_train.py:427)
        t_total=(steps_per_epoch // gas) * epochs,
        decay_type=args.decay_type,
        accum_steps=gas,
        num_epochs=epochs,
        warmup_epochs=getattr(args, "warmup_epochs", 0),
        warmup_lr=getattr(args, "warmup_lr", lr),
        mixup=args.mixup, cutmix=args.cutmix,
        mixup_prob=getattr(args, "mixup_prob", 0.8),
        mixup_switch_prob=getattr(args, "mixup_switch_prob", 0.5),
        mixup_mode=getattr(args, "mixup_mode", "batch"),
        cutmix_minmax=(tuple(args.cutmix_minmax)
                       if getattr(args, "cutmix_minmax", None) else None),
        smoothing=args.smoothing, num_classes=num_classes,
        distillation_type=(None if args.distillation_type == "none"
                           else args.distillation_type),
        distillation_alpha=args.distillation_alpha,
        distillation_tau=args.distillation_tau,
        # stage-2 timm scheduler surface (absent on the stage-1 parser ->
        # defaults keep the per-step schedule)
        sched=getattr(args, "sched", None),
        min_lr=getattr(args, "min_lr", 1e-5),
        sched_warmup_lr=getattr(args, "sched_warmup_lr", 1e-6),
        decay_epochs=getattr(args, "decay_epochs", 30.0),
        decay_rate=getattr(args, "decay_rate", 0.1),
        steps_per_epoch=steps_per_epoch // gas,
        opt=getattr(args, "opt", "adamw"),
        opt_eps=getattr(args, "opt_eps", 1e-8),
        opt_betas=(tuple(args.opt_betas)
                   if getattr(args, "opt_betas", None) else None),
        momentum=getattr(args, "momentum", 0.9),
        compute_dtype=torch.bfloat16)


def num_classes_for(dataset: str) -> int:
    return {"cifar10": 10, "cifar100": 100, "procedural": 10}.get(
        dataset, 1000)


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """Two-phase parse: --config YAML values become new defaults, CLI flags
    still win (the timm/T2TViT pattern, T2TViT/main.py:38-58).  The file
    is read by ``utils/yaml_config.py``, which returns what
    ``yaml.safe_load`` returns on the YAML a config file uses and raises
    ``ValueError`` (file:line:col) on the rest."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-c", "--config", default=None, type=str)
    known, _ = pre.parse_known_args(argv)
    if known.config:
        overrides = yaml_config.load(known.config) or {}
        valid = {a.dest for a in parser._actions}
        unknown = sorted(set(overrides) - valid)
        if unknown:
            parser.error(f"unknown config keys in {known.config}: "
                         f"{', '.join(unknown)}")
        parser.set_defaults(**overrides)
    return parser.parse_args(argv)
