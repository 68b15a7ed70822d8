#!/usr/bin/env bash
# Learning-bar run of the PyTorch port (BASELINE.md: Pendulum to a
# deterministic return of at least -200), on the card:
#
#   scripts/learning_bar_torch.sh [config] [train phases] [out dir] [train flags...]
#
# Trains with a final checkpoint only (--checkpoint-every -1), a CSV of
# the log rows (wall_seconds per row) and a 10-episode eval every 2,000
# train phases, then scores the final checkpoint with the eval CLI
# (3 rounds of 10 episodes).  Flags after the third argument go to the
# train CLI (e.g. --pipeline 1).  The last line is one JSON object with the
# config, the phases, those flags and the training's wall seconds.
set -euo pipefail
cfg=${1:-pendulum_ddpg}
phases=${2:-10000}
out=${3:-runs/learning_bar_torch}
shift $(( $# < 3 ? $# : 3 ))
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s.%N)
python3 -m r2d2dpg_torch.train --config "$cfg" --phases "$phases" \
    --checkpoint-dir "$out/ckpt" --checkpoint-every -1 \
    --log-every 1000 --eval-every 2000 --logdir "$out" "$@"
t1=$(date +%s.%N)
python3 -m r2d2dpg_torch.eval --config "$cfg" --checkpoint-dir "$out/ckpt" --rounds 3
python3 -c "import json, sys; print(json.dumps({'config': '$cfg', 'phases': $phases, 'flags': sys.argv[1:], 'train_wall_seconds': $t1 - $t0}))" "$@"
