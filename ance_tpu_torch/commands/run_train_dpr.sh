#!/bin/bash
# DPR trainer job on the H100 port (commands/run_train_dpr.sh; reference
# commands/run_train_dpr.sh): BiEncoder with in-batch negatives, polling
# ann_dir for fresh mined data — or, with NUM_EPOCH set, the fixed-epoch
# mode over the preprocessed train-data file (reference
# run_ann_dpr.py:179-211).
set -euo pipefail

OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_dpr_data}
ANN_DIR=${ANN_DIR:-ann_data_dpr}
CKPT_DIR=${CKPT_DIR:-checkpoints_dpr}
INIT_MODEL_DIR=${INIT_MODEL_DIR:-}   # DPR CheckpointState dir for warm start
SEQ_LEN=${SEQ_LEN:-256}
BATCH=${BATCH:-16}
LR=${LR:-1e-5}
NUM_EPOCH=${NUM_EPOCH:-0}            # >0 switches to fixed-epoch mode
DEV_DATA=${DEV_DATA:-}               # dev triples for per-epoch eval
DEVICE=${DEVICE:-cuda}

extra=()
if [ "$NUM_EPOCH" -gt 0 ]; then
  extra+=(--num_epoch "$NUM_EPOCH")
  [ -n "$DEV_DATA" ] && extra+=(--dev_data "$DEV_DATA")
else
  extra+=(--ann_dir "$ANN_DIR")
fi
[ -n "$INIT_MODEL_DIR" ] && extra+=(--model_name_or_path "$INIT_MODEL_DIR")

python -m ance_tpu_torch.cli train \
    --model_type dpr --data_dir "$OUT_DATA_DIR" \
    --output_dir "$CKPT_DIR" \
    --max_seq_length "$SEQ_LEN" --per_device_train_batch_size "$BATCH" \
    --optimizer lamb --learning_rate "$LR" \
    --warmup_steps "${WARMUP_STEPS:-1000}" --max_steps "${MAX_STEPS:-100000}" \
    --save_steps "${SAVE_STEPS:-1000}" --bf16 "${extra[@]}" \
    --device "$DEVICE"
