#!/usr/bin/env bash
# Stage-2 mask-frozen fine-tuning on an NVIDIA GPU: the flags and values
# of scripts/run_post_train.sh (the reference's UVC/run_post_train.sh)
# through the port's CLI.
set -e
python -m uvc_tpu_torch.cli.post_train \
  --model_type deit_tiny_patch16_224 \
  --checkpoint_dir output/uvc_train/debug/deit_tiny_patch16_224_30.ckpt \
  --dataset imagenet --data_dir /data/imagenet \
  --distillation-type soft \
  --distillation-alpha 0.1 \
  --train_batch_size 128 \
  --num_epochs 120 \
  --eval_every 1000 \
  --output_dir finetuning/ft_deit_tiny_patch16_224 \
  --num_workers 64 \
  --learning_rate 1e-4 \
  "$@"
