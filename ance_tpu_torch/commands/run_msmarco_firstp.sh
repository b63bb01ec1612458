#!/bin/bash
# MS MARCO passage FirstP on the H100 port: the full reference reproduction
# as ONE command (commands/run_msmarco_firstp.sh, docs/MSMARCO_RUNBOOK.md
# made executable). Stages: preprocess → BM25
# warmup → pipelined ANCE loop → embedding dump + full ranking → serve +
# official scorer, with the reference's acceptance gates
# (warmup MRR@10 ≥ 0.311, final dev MRR@10 ≥ 0.33 — reference
# README.md:177-194).
#
# Real mode needs the MS MARCO blobs + roberta-base on disk (see runbook
# step 0; ance_tpu_torch/commands/data_download.sh fetches the blobs):
#   RAW_DATA=raw_data MODEL=roberta-base \
#     bash ance_tpu_torch/commands/run_msmarco_firstp.sh
#
# --dry-run runs the IDENTICAL command sequence against a self-contained
# learnable synthetic miniature on the CPU (a few minutes), with scaled
# gates (final MRR@10 ≥ 0.5 where chance is ~1/64) —
# tests/test_torch_commands.py runs it, so the first real-data run is one
# command whose plumbing is already proven end to end.
set -euo pipefail

DRY=0
if [[ "${1:-}" == "--dry-run" ]]; then DRY=1; shift; fi

if [[ $DRY == 1 ]]; then
  WORK=${WORK:-$(mktemp -d)}
  cd "$WORK"
  DEVICE=${DEVICE:-cpu}
  RAW_DATA=raw
  MODEL="$WORK"                       # wordpiece vocab dir (offline)
  MODEL_TYPE=seeddot_nll
  # dropout 0 on the 32-dim miniature: at this scale the production 0.1
  # swamps the signal (same choice as the learning-dynamics tests)
  OVERRIDES='{"hidden_size":32,"num_layers":2,"num_heads":4,"intermediate_size":64,"hidden_dropout":0.0,"attention_dropout":0.0}'
  SEQ_LEN=24; QUERY_LEN=12
  WARMUP_STEPS=40; LOOP_STEPS=192; SLICE=32; TSPS=4
  TOPK=16; NEG=4; EVAL_B=32; TRAIN_B=8
  LR_WARM=5e-3; LR_LOOP=5e-3
  # short runs must leave the lr ramp (the flag default 1000 would keep
  # the whole dry-run inside warmup at ~0 lr)
  SCHED_WARMUP=8
  GATE_WARMUP=0.0                     # tiny warmup only proves plumbing
  GATE_FINAL=0.5                      # chance ≈ 1/64 on the synthetic task
  mkdir -p raw
  python - << 'EOF'
import random
words = [f"w{i:03d}" for i in range(60)]
with open("vocab.txt", "w") as f:
    for t in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words:
        f.write(t + "\n")
rs = random.Random(0)
# class-based task (same shape as docs/tpu_demo.py): dev queries reuse
# TRAINED classes with fresh noise — a per-qid task cannot generalize
# because dev signature words would never appear in training
n_classes, n_p, n_train, n_dev = 48, 64, 96, 16
sig = lambda c: words[c]
filler = lambda: rs.choice(words[48:])
with open("raw/collection.tsv", "w") as f:
    for pid in range(n_p):
        toks = [sig(pid)] * 4 + [filler(), filler()] if pid < n_classes \
            else [filler() for _ in range(6)]
        f.write(f"{pid}\t{' '.join(toks)}\n")
def write_queries(split, qids):
    with open(f"raw/queries.{split}.tsv", "w") as f:
        for qid in qids:
            f.write(f"{qid}\t{sig(qid % n_classes)} "
                    f"{sig(qid % n_classes)} {filler()}\n")
    with open(f"raw/qrels.{split}.tsv", "w") as f:
        for qid in qids:
            f.write(f"{qid}\t0\t{qid % n_classes}\t1\n")
write_queries("train", range(n_train))
write_queries("dev.small", range(1000, 1000 + n_dev))
# BM25-style raw-text triples for the warmup stage
with open("raw/triples.train.small.tsv", "w") as f:
    for _ in range(8):
        for qid in range(n_train):
            c = qid % n_classes
            neg = rs.choice([p for p in range(n_classes) if p != c])
            f.write(f"{sig(c)} {sig(c)} {filler()}\t"
                    f"{sig(c)} {sig(c)} {sig(c)} {filler()}\t"
                    f"{sig(neg)} {sig(neg)} {sig(neg)} {filler()}\n")
EOF
else
  RAW_DATA=${RAW_DATA:-raw_data}
  MODEL=${MODEL:-roberta-base}
  DEVICE=${DEVICE:-cuda}
  MODEL_TYPE=${MODEL_TYPE:-rdot_nll}
  OVERRIDES=""
  SEQ_LEN=${SEQ_LEN:-128}; QUERY_LEN=${QUERY_LEN:-64}
  WARMUP_STEPS=${WARMUP_STEPS:-60000}; LOOP_STEPS=${LOOP_STEPS:-600000}
  SLICE=${ENCODE_SLICE:-65536}; TSPS=${TRAIN_STEPS_PER_SLICE:-8}
  TOPK=${TOPK:-200}; NEG=${NEG:-20}; EVAL_B=${EVAL_B:-256}
  TRAIN_B=${TRAIN_B:-64}
  LR_WARM=${LR_WARM:-2e-4}; LR_LOOP=${LR_LOOP:-1e-6}
  GATE_WARMUP=${GATE_WARMUP:-0.311}   # reference README.md:192-194
  GATE_FINAL=${GATE_FINAL:-0.33}      # reference README.md:177-179
  SCHED_WARMUP=${SCHED_WARMUP:-1000}
  WORK=${WORK:-$PWD/msmarco_firstp}
  mkdir -p "$WORK"; cd "$WORK"
fi

COMMON=(--model_type "$MODEL_TYPE" --model_name_or_path "$MODEL"
        --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN")
if [[ -n "$OVERRIDES" ]]; then COMMON+=(--encoder_overrides "$OVERRIDES"); fi
if [[ $DRY == 0 ]]; then COMMON+=(--bf16); fi

gate () {  # gate <name> <value> <min>
  python - "$1" "$2" "$3" << 'EOF'
import sys
name, value, lo = sys.argv[1], float(sys.argv[2]), float(sys.argv[3])
ok = value >= lo
print(f"GATE {name}: {value:.4f} {'>=' if ok else '<'} {lo} "
      f"{'PASS' if ok else 'FAIL'}")
sys.exit(0 if ok else 1)
EOF
}

# ---- 1. preprocess → binary token caches --------------------------------
if [[ ! -f data/passages_meta ]]; then
  python -m ance_tpu_torch.cli preprocess "${COMMON[@]:0:4}" \
    --model_name_or_path "$MODEL" \
    --data_dir "$RAW_DATA" --out_data_dir data --data_type 1 \
    --max_seq_length "$SEQ_LEN" --max_query_length "$QUERY_LEN" \
    --num_processes "${NUM_PROC:-2}"
fi

# ---- 2. BM25 warmup ------------------------------------------------------
python -m ance_tpu_torch.cli warmup "${COMMON[@]}" --device "$DEVICE" \
  --train_file "$RAW_DATA/triples.train.small.tsv" \
  --per_device_train_batch_size "$TRAIN_B" --learning_rate "$LR_WARM" \
  --optimizer lamb --max_steps "$WARMUP_STEPS" \
  --warmup_steps "$SCHED_WARMUP" \
  --save_steps "$WARMUP_STEPS" --output_dir ckpts_warmup \
  | tee warmup.out
test -d ckpts_warmup/checkpoint-"$WARMUP_STEPS" \
  || { echo "warmup checkpoint missing"; exit 1; }

# ---- 2b. warmup acceptance gate: full-ranking dev MRR@10 of the warmup
# checkpoint, measured with the SAME infer + eval-full path as the final
# gate (the reference's 0.311 post-warmup number is this metric,
# README.md:192-194). Runs in dry mode too (gate 0.0) so CI proves the
# plumbing; in real mode this costs one corpus encode (~25 min at 8.8M).
python -m ance_tpu_torch.cli infer "${COMMON[@]}" --device "$DEVICE" \
  --data_dir data --training_dir ckpts_warmup --output_dir emb_warmup \
  --per_device_eval_batch_size "$EVAL_B" \
  --topk_training "$TOPK" --negative_sample "$NEG" --ann_chunk_factor 1
python -m ance_tpu_torch.cli eval-full --device "$DEVICE" \
  --query_prefix emb_warmup/step0_dev_query_emb_p_ \
  --query_id_prefix emb_warmup/step0_dev_query_embid_p_ \
  --passage_prefix emb_warmup/step0_passage_emb_p_ \
  --passage_id_prefix emb_warmup/step0_passage_embid_p_ \
  --qrels data/dev-qrel.tsv --topn "$TOPK" | tee evalwarm.out
WMRR=$(python -c "
import json; print(json.loads(open('evalwarm.out').read().strip()
                              .splitlines()[-1])['mrr_10'])")
gate warmup_full_mrr "$WMRR" "$GATE_WARMUP"

# ---- 3. pipelined ANCE loop ---------------------------------------------
python -m ance_tpu_torch.cli ance-loop "${COMMON[@]}" --device "$DEVICE" \
  --model_name_or_path ckpts_warmup/checkpoint-"$WARMUP_STEPS" \
  ${OVERRIDES:+--encoder_overrides "$OVERRIDES"} \
  --data_dir data --output_dir ckpts_ance \
  --max_steps "$LOOP_STEPS" --learning_rate "$LR_LOOP" --optimizer lamb \
  --warmup_steps "$SCHED_WARMUP" \
  --per_device_train_batch_size "$TRAIN_B" \
  --per_device_eval_batch_size "$EVAL_B" \
  --train_steps_per_slice "$TSPS" --encode_slice_size "$SLICE" \
  --topk_training "$TOPK" --negative_sample "$NEG" --ann_chunk_factor 1 \
  --save_steps "$LOOP_STEPS" \
  | tee loop.out

# ---- 4. embedding dump + full ranking -----------------------------------
python -m ance_tpu_torch.cli infer "${COMMON[@]}" --device "$DEVICE" \
  --data_dir data --training_dir ckpts_ance --output_dir emb_dump \
  --per_device_eval_batch_size "$EVAL_B" \
  --topk_training "$TOPK" --negative_sample "$NEG" --ann_chunk_factor 1
python -m ance_tpu_torch.cli eval-full --device "$DEVICE" \
  --query_prefix emb_dump/step0_dev_query_emb_p_ \
  --query_id_prefix emb_dump/step0_dev_query_embid_p_ \
  --passage_prefix emb_dump/step0_passage_emb_p_ \
  --passage_id_prefix emb_dump/step0_passage_embid_p_ \
  --qrels data/dev-qrel.tsv --topn "$TOPK" | tee evalfull.out
FULL_MRR=$(python -c "
import json; print(json.loads(open('evalfull.out').read().strip()
                              .splitlines()[-1])['mrr_10'])")

# ---- 5. serve → rankings → official scorer ------------------------------
python -m ance_tpu_torch.cli serve "${COMMON[@]}" --device "$DEVICE" \
  --training_dir ckpts_ance --data_dir data \
  --queries "$RAW_DATA/queries.dev.small.tsv" \
  --topk "$TOPK" --output rankings.tsv
python -m ance_tpu_torch.cli eval "$RAW_DATA/qrels.dev.small.tsv" rankings.tsv \
  | tee eval.out
MRR=$(sed -n 's/^MRR @10: //p' eval.out)

gate final_fullrank_mrr "$FULL_MRR" "$GATE_FINAL"
gate final_official_mrr "$MRR" "$GATE_FINAL"
echo "run_msmarco_firstp $( [[ $DRY == 1 ]] && echo DRY-RUN ) OK (workdir: $WORK)"
