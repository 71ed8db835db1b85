"""Stage-2 CLI: mask-frozen distillation fine-tune from a stage-1
checkpoint (counterpart of ``uvc_tpu/cli/post_train.py``).

  python -m uvc_tpu_torch.cli.post_train \\
      --model_type deit_small_patch16_224 \\
      --checkpoint_dir output/uvc_train/debug/deit_small_patch16_224_30.ckpt \\
      --dataset imagenet --data_dir /data/imagenet --num_epochs 100

The checkpoint is a ``.ckpt`` of either package, with its masks or with
the minimax state they are rebuilt from, or a reference (torch) stage-1
``.pth`` / ``.pth.tar``: its weights through ``models/convert.py`` and its
masks from the binary ``*.mask`` buffers its weighted modules carry
(``masks_from_torch_state_dict``).  Its pruned coordinates hold shrunken
nonzero weights, so the masks are never taken as all ones.  Across GPUs
it runs as ``joint_train`` does (torchrun, ``cli/slurm_launch.py
--stage2``, or ``--coordinator`` / ``--num_processes`` /
``--process_id``).
"""

from __future__ import annotations

import argparse

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.cli.joint_train import (build_loaders, load_teacher,
                                           setup_mesh, shutdown)
from uvc_tpu_torch.configs import get_config


def stage1_params_and_masks(path: str, cfg):
    """The params and masks of a stage-1 checkpoint, on the CPU: of a
    ``.ckpt``, its ``masks`` where it holds them, else rebuilt from its
    ``cstate``'s ``s`` and ``r``; of a torch ``.pth`` / ``.pth.tar``, the
    converted weights and the masks of its ``*.mask`` buffers."""
    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.models import convert
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, params_of
    if not path.endswith(".ckpt"):
        sd = convert.read_torch_state_dict(path)
        return (convert.params_from_state_dict(sd, cfg),
                convert.masks_from_torch_state_dict(sd, cfg))
    ck = load_checkpoint(path)
    params = params_of(ck)
    if ck.get("masks") is not None:
        masks = {k: v.float() for k, v in ck["masks"].items()}
    else:
        cs = ck["cstate"]
        masks = build_masks(params, cs["s"].float(), cs["r"].float(), cfg)
    return params, masks


def main(argv=None):
    parser = argparse.ArgumentParser("uvc_tpu_torch stage-2 post training")
    flags.add_common_flags(parser)
    flags.add_uvc_flags(parser)
    flags.add_stage2_flags(parser)
    parser.add_argument("--checkpoint_dir", required=True,
                        help="stage-1 checkpoint to fine-tune")
    args = flags.parse_with_config(parser, argv)
    mesh = setup_mesh(args)
    try:
        _run(args, mesh)
    finally:
        shutdown()


def _run(args, mesh):
    num_classes = flags.num_classes_for(args.dataset)
    if args.img_size is None:
        args.img_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=num_classes,
        distilled=bool(args.enable_deit))
    hp = flags.to_hparams(args)
    params, masks = stage1_params_and_masks(args.checkpoint_dir, cfg)

    train_loader, test_loader = build_loaders(args, num_classes,
                                              args.img_size, mesh)
    thp = flags.to_train_hparams(args, len(train_loader), num_classes)
    teacher = load_teacher(args, cfg, params)

    from uvc_tpu_torch.train.stage2 import run_stage2
    from uvc_tpu_torch.utils import profiler as prof
    run_stage2(cfg, hp, thp, params=params, masks=masks,
               teacher_params=teacher, train_loader=train_loader,
               test_loader=test_loader, seed=args.seed,
               output_dir=args.output_dir, name=args.name,
               eval_every=args.eval_every, mesh=mesh, mp=args.mp,
               world_batch=args.train_batch_size,
               steps_per_launch=args.steps_per_launch,
               resume=args.resume, use_orbax=bool(args.use_orbax),
               compact=bool(args.compact_train),
               profiler=prof.from_args(args), device=args.device)


if __name__ == "__main__":
    main()
