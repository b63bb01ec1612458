#!/bin/bash
# ANN data generator job on the H100 port (two-job compat mode): polls the
# trainer's checkpoint dir, re-encodes the corpus, refreshes the index,
# mines negatives (commands/run_ann_data_gen.sh; reference
# commands/run_ann_data_gen.sh).
#
# RANKS processes (one a card, rank r on cuda:r; default 1) run each pass
# over a grid of ranks; the script's own arguments pass through to the
# command, e.g. tensor parallelism over 2 of 4 ranks:
#   RANKS=4 bash run_ann_data_gen.sh --tensor_parallel 2 --attention xla
# Ranks that share one card need DIST_BACKEND=gloo.
set -euo pipefail

OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_data}
ANN_DIR=${ANN_DIR:-ann_data}
CKPT_DIR=${CKPT_DIR:-checkpoints}
MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
SEQ_LEN=${SEQ_LEN:-128}
QUERY_LEN=${QUERY_LEN:-64}
DEVICE=${DEVICE:-cuda}
RANKS=${RANKS:-1}
DIST_BACKEND=${DIST_BACKEND:-nccl}

while true; do
  PORT=$((20000 + RANDOM % 20000))
  pids=()
  for ((r = 0; r < RANKS; r++)); do
    python -m ance_tpu_torch.cli generate \
        --model_type "$MODEL_TYPE" --data_dir "$OUT_DATA_DIR" \
        --training_dir "$CKPT_DIR" --output_dir "$ANN_DIR" \
        --topk_training "${TOPK:-200}" --negative_sample "${NEG:-20}" \
        --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" --bf16 \
        --device "$DEVICE" --num_processes "$RANKS" \
        --coordinator_address "127.0.0.1:$PORT" --process_id "$r" \
        --dist_backend "$DIST_BACKEND" "$@" &
    pids+=($!)
  done
  for p in "${pids[@]}"; do wait "$p"; done
  sleep 60   # reference poll cadence (run_ann_data_gen.py:684-685)
done
