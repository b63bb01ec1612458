#!/bin/bash
# ANCE FirstP passage training pipeline on the H100 port: preprocess →
# initial ANN generation → trainer (two-job compat mode, as
# commands/run_train.sh; see also `ance-loop` for the single-program
# pipelined mode).
#
# Experiment presets mirror the reference configurations
# (reference commands/run_train.sh:24-67):
#   FirstP passage: seq 128 / query 64, LAMB lr 1e-6...  (paper settings)
#   FirstP doc:     seq 512 / query 64, data_type 0
#   MaxP doc:       rdot_nll_multi_chunk, seq 2048 (4×512 chunks)
# Raw data: bash ance_tpu_torch/commands/data_download.sh "$DATA_DIR"
set -euo pipefail

DATA_DIR=${DATA_DIR:-raw_data}
OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_data}
ANN_DIR=${ANN_DIR:-ann_data}
CKPT_DIR=${CKPT_DIR:-checkpoints}
WARMUP_CKPT=${WARMUP_CKPT:-}       # BM25 warmup checkpoint to warm-start from
DEVICE=${DEVICE:-cuda}

# ---- FirstP passage preset ----
MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
SEQ_LEN=${SEQ_LEN:-128}
QUERY_LEN=${QUERY_LEN:-64}
DATA_TYPE=${DATA_TYPE:-1}
LR=${LR:-1e-6}
TOPK=${TOPK:-200}
NEG=${NEG:-20}

python -m ance_tpu_torch.cli preprocess \
    --model_type "$MODEL_TYPE" --data_dir "$DATA_DIR" \
    --out_data_dir "$OUT_DATA_DIR" --data_type "$DATA_TYPE" \
    --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN"

python -m ance_tpu_torch.cli generate \
    --model_type "$MODEL_TYPE" --data_dir "$OUT_DATA_DIR" \
    --training_dir "$CKPT_DIR" ${WARMUP_CKPT:+--init_model_dir "$WARMUP_CKPT"} \
    --output_dir "$ANN_DIR" --topk_training "$TOPK" --negative_sample "$NEG" \
    --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" --bf16 \
    --device "$DEVICE"

python -m ance_tpu_torch.cli train \
    --model_type "$MODEL_TYPE" --data_dir "$OUT_DATA_DIR" \
    --ann_dir "$ANN_DIR" --output_dir "$CKPT_DIR" \
    --optimizer lamb --learning_rate "$LR" \
    --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" --bf16 \
    --device "$DEVICE"
