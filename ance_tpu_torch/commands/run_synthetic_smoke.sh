#!/bin/bash
# Self-contained end-to-end smoke of the H100 port
# (commands/run_synthetic_smoke.sh): builds a tiny synthetic corpus + vocab,
# then drives preprocess → generate (encode/index/mine + dev NDCG) → infer
# (embedding dump) → eval-full (offline ranking metrics) on the CPU
# (DEVICE=cuda for the card).
#
# The two independent NDCG code paths (generate's in-loop dev_ndcg and
# eval-full's ndcg_10 over the dumped embeddings) must agree exactly —
# that cross-check is the point of the drive.
set -euo pipefail

WORK=${WORK:-$(mktemp -d)}
cd "$WORK"
mkdir -p raw
DEVICE=${DEVICE:-cpu}   # a correctness smoke: the CPU unless asked

python - << 'EOF'
import random
words = [f"w{i:03d}" for i in range(60)]
with open("vocab.txt", "w") as f:
    for t in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words:
        f.write(t + "\n")
rs = random.Random(0)
with open("raw/collection.tsv", "w") as f:
    for pid in range(40):
        toks = [words[pid]] * 3 + rs.sample(words, 4)
        f.write(f"{pid}\t{' '.join(toks)}\n")
for split, n0, n1 in [("train", 0, 30), ("dev.small", 30, 40)]:
    with open(f"raw/queries.{split}.tsv", "w") as f:
        for qid in range(n0, n1):
            f.write(f"{qid}\t{words[qid]} {rs.choice(words)}\n")
    with open(f"raw/qrels.{split}.tsv", "w") as f:
        for qid in range(n0, n1):
            f.write(f"{qid}\t0\t{qid}\t1\n")
EOF

TINY='{"hidden_size":32,"num_layers":2,"num_heads":4,"intermediate_size":64}'

python -m ance_tpu_torch.cli preprocess \
    --model_type seeddot_nll --model_name_or_path "$WORK" \
    --data_dir raw --out_data_dir data --data_type 1 \
    --max_seq_length 32 --max_query_length 16 --num_processes 2

python -m ance_tpu_torch.cli generate --device "$DEVICE" \
    --model_type seeddot_nll --model_name_or_path "$WORK" \
    --data_dir data --training_dir ckpts --output_dir ann_data \
    --topk_training 32 --negative_sample 4 --ann_chunk_factor 1 \
    --per_device_eval_batch_size 32 \
    --max_seq_length 32 --max_query_length 16 \
    --encoder_overrides "$TINY"

python -m ance_tpu_torch.cli infer --device "$DEVICE" \
    --model_type seeddot_nll --model_name_or_path "$WORK" \
    --data_dir data --training_dir ckpts --output_dir emb_dump \
    --topk_training 32 --negative_sample 4 --ann_chunk_factor 1 \
    --per_device_eval_batch_size 32 \
    --max_seq_length 32 --max_query_length 16 \
    --encoder_overrides "$TINY"

python -m ance_tpu_torch.cli eval-full --device "$DEVICE" \
    --query_prefix emb_dump/step0_dev_query_emb_p_ \
    --query_id_prefix emb_dump/step0_dev_query_embid_p_ \
    --passage_prefix emb_dump/step0_passage_emb_p_ \
    --passage_id_prefix emb_dump/step0_passage_embid_p_ \
    --qrels data/dev-qrel.tsv --topn 32

echo "smoke OK (workdir: $WORK)"
