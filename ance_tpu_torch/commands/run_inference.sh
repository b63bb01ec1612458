#!/bin/bash
# Inference-only job on the H100 port (commands/run_inference.sh; reference
# commands/run_inference.sh): encode the corpus + dev queries with a
# released/trained checkpoint, stop after the encode (reference
# --inference, run_ann_data_gen.py:256-257), and dump the embedding shards
# the offline eval consumes (`eval-full`).
#
# Experiment presets mirror the reference header blocks:
#   Passage FirstP: MODEL_TYPE=rdot_nll             SEQ_LEN=512
#   Doc FirstP:     MODEL_TYPE=rdot_nll             SEQ_LEN=512 (doc caches)
#   Doc MaxP:       MODEL_TYPE=rdot_nll_multi_chunk SEQ_LEN=2048
# RANKS processes (one a card; default 1) share the encode; the script's
# own arguments pass through to infer (e.g. --tensor_parallel 2
# --attention xla).
set -euo pipefail

OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_data}
EMB_DIR=${EMB_DIR:-emb_dump}
CKPT_DIR=${CKPT_DIR:-checkpoints}
INIT_MODEL_DIR=${INIT_MODEL_DIR:-}   # released ANCE checkpoint dir
MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
SEQ_LEN=${SEQ_LEN:-512}
QUERY_LEN=${QUERY_LEN:-64}
DEVICE=${DEVICE:-cuda}
RANKS=${RANKS:-1}
DIST_BACKEND=${DIST_BACKEND:-nccl}

extra=()
[ -n "$INIT_MODEL_DIR" ] && extra+=(--init_model_dir "$INIT_MODEL_DIR")

PORT=$((20000 + RANDOM % 20000))
pids=()
for ((r = 0; r < RANKS; r++)); do
  python -m ance_tpu_torch.cli infer \
      --model_type "$MODEL_TYPE" --data_dir "$OUT_DATA_DIR" \
      --training_dir "$CKPT_DIR" --output_dir "$EMB_DIR" \
      --per_device_eval_batch_size "${EVAL_BATCH:-128}" \
      --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" \
      --bf16 "${extra[@]}" \
      --device "$DEVICE" --num_processes "$RANKS" \
      --coordinator_address "127.0.0.1:$PORT" --process_id "$r" \
      --dist_backend "$DIST_BACKEND" "$@" &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done

echo "embedding shards in $EMB_DIR; score with:"
echo "  python -m ance_tpu_torch.cli eval-full --device $DEVICE --query_prefix $EMB_DIR/step0_dev_query_emb_p_ ..."
