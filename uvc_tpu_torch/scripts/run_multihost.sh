#!/usr/bin/env bash
# Multi-host launch on NVIDIA GPUs: the flags and values of
# scripts/run_multihost.sh through the port's CLI, one process per GPU.
# torchrun starts GPUS_PER_HOST processes on this host and hands each its
# rank in its environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT), which the CLI reads in place of --coordinator /
# --num_processes / --process_id; each process takes the card of its
# LOCAL_RANK.  Run once per host with HOST_ID=0..N-1;
# COORDINATOR=<host0-ip>:<port>.
set -e
: "${COORDINATOR:?set COORDINATOR=<host0-ip>:<port>}"
: "${NUM_HOSTS:?set NUM_HOSTS}"
: "${HOST_ID:?set HOST_ID}"
: "${GPUS_PER_HOST:=8}"
torchrun \
  --nnodes "$NUM_HOSTS" \
  --node_rank "$HOST_ID" \
  --nproc_per_node "$GPUS_PER_HOST" \
  --master_addr "${COORDINATOR%:*}" \
  --master_port "${COORDINATOR##*:}" \
  -m uvc_tpu_torch.cli.joint_train \
  --model_type deit_small_patch16_224 \
  --dataset imagenet --data_dir /data/imagenet \
  --train_batch_size 1024 --num_epochs 30 --budget 0.5 \
  "$@"
