#!/usr/bin/env bash
# One-shot mask generation + masked fine-tuning baseline on an NVIDIA GPU:
# the flags and values of scripts/run_mask_finetune.sh (the reference's
# generating_mask.py + main.py --init_mask) through the port's CLIs.
set -e
python -m uvc_tpu_torch.cli.generate_mask \
  --type synflow --model_type deit_small_patch16_224 \
  --sparsity 0.5 --save_file /tmp/synflow_mask.ckpt
python -m uvc_tpu_torch.cli.baseline_train \
  --model_type deit_small_patch16_224 \
  --dataset imagenet --data_dir /data/imagenet \
  --init_mask /tmp/synflow_mask.ckpt \
  --epochs 100 --train_batch_size 1024 \
  --output_dir output/oneshot --name synflow_small \
  "$@"
