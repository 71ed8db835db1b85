#!/usr/bin/env bash
# Gradual magnitude pruning baseline on an NVIDIA GPU: the flags and
# values of scripts/run_baseline_gmp.sh (the reference's
# UVC/Baseline_pruning/script/**) through the port's CLI.
set -e
python -m uvc_tpu_torch.cli.baseline_train \
  --model_type deit_small_patch16_224 \
  --dataset imagenet --data_dir /data/imagenet \
  --gmp 1 --sparsity 0.5 --t_start 1000 --delta_t 500 --pruning_times 10 \
  --epochs 100 --train_batch_size 1024 --model_ema 1 \
  --output_dir output/gmp --name gmp_small \
  "$@"
