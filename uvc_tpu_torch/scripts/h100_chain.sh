#!/bin/bash
# The H100 record chain (counterpart of scripts/r5_chain.sh): the card's
# kernel parity and the evidence harnesses one after another, each bounded
# by a timeout; a failure does not stop the chain.  Run from anywhere:
# it works in the checkout that holds it and appends to $LOG
# (h100_chain.log there unless set).
cd "$(dirname "$0")/../.."
log=${LOG:-h100_chain.log}
mkdir -p "$(dirname "$log")"
echo "=== h100 chain start $(date) ===" >> "$log"

run() {
  name=$1; shift
  echo "--- $name start $(date) ---" >> "$log"
  "$@" >> "$log" 2>&1
  echo "--- $name exit=$? $(date) ---" >> "$log"
}

run kparity  timeout 1200 python3 chip_smoke.py --kernels-only
run fidelity timeout 1800 python3 -m uvc_tpu_torch.scripts.trajectory_fidelity --out FIDELITY_h100.json
run e2e_s0   timeout 1800 python3 -m uvc_tpu_torch.scripts.e2e_accuracy --seed 0 --out E2EACC_h100_seed0.json
run e2e_s1   timeout 1800 python3 -m uvc_tpu_torch.scripts.e2e_accuracy --seed 1 --out E2EACC_h100_seed1.json
run e2e_s2   timeout 1800 python3 -m uvc_tpu_torch.scripts.e2e_accuracy --seed 2 --out E2EACC_h100_seed2.json
echo "=== h100 chain done $(date) ===" >> "$log"
