#!/bin/bash
# Single-program pipelined ANCE on the H100 port (commands/run_pipelined.sh).
#
# Replaces the reference's two cooperating jobs (run_train.sh +
# run_ann_data_gen.sh polling each other through the filesystem) with ONE
# program: every generator stage — corpus re-encode, dev eval, mining —
# runs as bounded work items interleaved between train steps, and corpus
# embeddings refresh in place in the card's memory
# (ance_tpu_torch/train/pipelined.py). Restarts resume from the newest
# complete checkpoint automatically.
#
# Expects preprocessed caches in $OUT_DATA_DIR (see run_train.sh step 1).
set -euo pipefail

OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_data}
CKPT_DIR=${CKPT_DIR:-checkpoints_pipelined}
WARMUP_CKPT=${WARMUP_CKPT:-}      # BM25 warmup checkpoint to warm-start from
DEVICE=${DEVICE:-cuda}

# ---- FirstP passage preset (paper settings; reference run_train.sh:25-40) --
MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
SEQ_LEN=${SEQ_LEN:-128}
QUERY_LEN=${QUERY_LEN:-64}
LR=${LR:-1e-6}
TOPK=${TOPK:-200}
NEG=${NEG:-20}
MAX_STEPS=${MAX_STEPS:-600000}

# staleness/throughput knobs: one work item runs every
# TRAIN_STEPS_PER_SLICE train steps; smaller = fresher negatives, more
# encode interleave overhead
TRAIN_STEPS_PER_SLICE=${TRAIN_STEPS_PER_SLICE:-8}
ENCODE_SLICE=${ENCODE_SLICE:-65536}

python -m ance_tpu_torch.cli ance-loop \
    --model_type "$MODEL_TYPE" \
    ${WARMUP_CKPT:+--model_name_or_path "$WARMUP_CKPT"} \
    --data_dir "$OUT_DATA_DIR" --output_dir "$CKPT_DIR" \
    --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" \
    --learning_rate "$LR" --optimizer lamb \
    --max_steps "$MAX_STEPS" \
    --topk_training "$TOPK" --negative_sample "$NEG" \
    --train_steps_per_slice "$TRAIN_STEPS_PER_SLICE" \
    --encode_slice_size "$ENCODE_SLICE" \
    --log_trust_ratios --device "$DEVICE"
