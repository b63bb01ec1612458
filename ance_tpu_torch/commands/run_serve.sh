#!/bin/bash
# Online serving preset on the H100 port (commands/run_serve.sh): load (or
# build) the exact index and serve over HTTP. Presets:
#   saved index (production restart): SAVED_INDEX=idx  → instant start,
#     int8 stays int8 on disk, ids already in real pid space
#   fresh build: DATA_DIR=preprocessed_data → encodes {DATA_DIR}/passages
#     with the newest checkpoint under CKPT_DIR (QUANTIZE=dims for the
#     int8 index, a quarter of the fp32 index's bytes)
set -euo pipefail

CKPT_DIR=${CKPT_DIR:-checkpoints}
MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
MODEL_NAME=${MODEL_NAME:-roberta-base}
HTTP_ADDR=${HTTP_ADDR:-0.0.0.0:8080}
TOPK=${TOPK:-10}
SAVED_INDEX=${SAVED_INDEX:-}
DATA_DIR=${DATA_DIR:-}
QUANTIZE=${QUANTIZE:-none}
DEVICE=${DEVICE:-cuda}

if [[ -n "$SAVED_INDEX" ]]; then
  exec python -m ance_tpu_torch.cli serve \
    --model_type "$MODEL_TYPE" --model_name_or_path "$MODEL_NAME" \
    --training_dir "$CKPT_DIR" --load_index "$SAVED_INDEX" \
    --http "$HTTP_ADDR" --topk "$TOPK" --bf16 --device "$DEVICE"
fi

[[ -n "$DATA_DIR" ]] || { echo "set SAVED_INDEX or DATA_DIR" >&2; exit 2; }
exec python -m ance_tpu_torch.cli serve \
  --model_type "$MODEL_TYPE" --model_name_or_path "$MODEL_NAME" \
  --training_dir "$CKPT_DIR" --data_dir "$DATA_DIR" \
  --quantize "$QUANTIZE" --save_index "${SAVE_INDEX:-serving_index}" \
  --http "$HTTP_ADDR" --topk "$TOPK" --bf16 --device "$DEVICE"
