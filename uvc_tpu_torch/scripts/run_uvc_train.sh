#!/usr/bin/env bash
# Stage-1 joint UVC training on an NVIDIA GPU: the flags and values of
# scripts/run_uvc_train.sh (the reference's UVC/run_uvc_train.sh) through
# the port's CLI, which computes on the card (--device cuda, its default).
# One process drives one GPU; several GPUs run one process each
# (run_multihost.sh, run_slurm.sbatch).
set -e
python -m uvc_tpu_torch.cli.joint_train \
  --model_type deit_tiny_patch16_224 \
  --model_path deit_tiny_patch16_224-a1311bcf.pth \
  --dataset imagenet --data_dir /data/imagenet \
  --distillation-type soft \
  --distillation-alpha 0.1 \
  --train_batch_size 512 \
  --num_epochs 30 \
  --eval_every 1000 \
  --flops_with_mhsa 1 \
  --zlr_schedule_list "1,5,9,13,17" \
  --learning_rate 1e-4 \
  --enable_deit 0 \
  --budget 0.5 \
  --enable_pruning 1 \
  --enable_block_gating 1 \
  --enable_patch_gating 1 \
  --gating_weight 5e-4 \
  --use_gumbel 1 \
  --glr 0.1 \
  --num_workers 64 \
  --seed 730 \
  --output_dir mc_deit_tiny_patch16_224_with_patch \
  --log_interval 1000 \
  --eps 0.1 --eps_decay 0.92 \
  --enable_warmup 1 --warmup_epochs 5 --warmup_lr 1e-4 \
  --z_grad_clip 0.5 \
  --gating_interval 50 \
  "$@"
