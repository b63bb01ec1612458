#!/bin/bash
# DPR preprocessing + ANN data generator job on the H100 port
# (commands/run_ann_data_gen_dpr.sh; reference
# commands/run_ann_data_gen_dpr.sh:1-44): tokenize the wiki corpus + DPR
# question/answer files, then loop the answer-filtered mining generator
# against the trainer's checkpoint dir.
#
# RANKS processes (one a card; default 1) run each pass over a grid of
# ranks; the script's own arguments pass through to generate-dpr, e.g.
#   RANKS=2 bash run_ann_data_gen_dpr.sh --tensor_parallel 2 --attention xla
set -euo pipefail

WIKI_DIR=${WIKI_DIR:-dpr_data/wikipedia_split}    # holds psgs_w100.tsv
QUESTION_DIR=${QUESTION_DIR:-dpr_data/retriever}  # DPR training json dir
ANS_DIR=${ANS_DIR:-dpr_data/retriever/qas}        # question/answer csv dir
DATA_TYPE=${DATA_TYPE:-0}                         # 0=NQ 1=TriviaQA 2=both
OUT_DATA_DIR=${OUT_DATA_DIR:-preprocessed_dpr_data}
ANN_DIR=${ANN_DIR:-ann_data_dpr}
CKPT_DIR=${CKPT_DIR:-checkpoints_dpr}
INIT_MODEL_DIR=${INIT_MODEL_DIR:-}
SEQ_LEN=${SEQ_LEN:-256}
DEVICE=${DEVICE:-cuda}
RANKS=${RANKS:-1}
DIST_BACKEND=${DIST_BACKEND:-nccl}

if [ ! -f "$OUT_DATA_DIR/passages_meta" ]; then
  python -m ance_tpu_torch.cli preprocess-dpr \
      --model_type dpr --wiki_dir "$WIKI_DIR" \
      --question_dir "$QUESTION_DIR" --answer_dir "$ANS_DIR" \
      --data_type "$DATA_TYPE" --out_data_dir "$OUT_DATA_DIR" \
      --max_seq_length "$SEQ_LEN"
fi

extra=()
[ -n "$INIT_MODEL_DIR" ] && extra+=(--init_model_dir "$INIT_MODEL_DIR")

while true; do
  PORT=$((20000 + RANDOM % 20000))
  pids=()
  for ((r = 0; r < RANKS; r++)); do
    python -m ance_tpu_torch.cli generate-dpr \
        --model_type dpr --data_dir "$OUT_DATA_DIR" \
        --wiki_path "$WIKI_DIR/psgs_w100.tsv" \
        --test_qas "${TEST_QAS:-$ANS_DIR/nq-test.csv}" \
        --trivia_qas "${TRIVIA_QAS:-$ANS_DIR/trivia-test.csv}" \
        --training_dir "$CKPT_DIR" --output_dir "$ANN_DIR" \
        --topk_training "${TOPK:-200}" --negative_sample "${NEG:-100}" \
        --max_seq_length "$SEQ_LEN" --bf16 "${extra[@]}" \
        --device "$DEVICE" --num_processes "$RANKS" \
        --coordinator_address "127.0.0.1:$PORT" --process_id "$r" \
        --dist_backend "$DIST_BACKEND" "$@" &
    pids+=($!)
  done
  for p in "${pids[@]}"; do wait "$p"; done
  sleep 60   # reference poll cadence (run_ann_data_gen_dpr.py outer loop)
done
