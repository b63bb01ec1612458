#!/bin/bash
# BM25 warmup training on triples.train.small.tsv on the H100 port
# (commands/run_train_warmup.sh; reference commands/run_train_warmup.sh).
set -euo pipefail

python -m ance_tpu_torch.cli warmup \
    --model_type rdot_nll \
    --train_file "${TRIPLES:-raw_data/triples.train.small.tsv}" \
    --output_dir "${CKPT_DIR:-checkpoints/warmup}" \
    --optimizer lamb --learning_rate "${LR:-2e-4}" \
    --max_seq_length "${SEQ_LEN:-128}" --num_train_epochs 1 \
    --max_steps "${MAX_STEPS:-60000}" --save_steps 5000 --bf16 \
    --device "${DEVICE:-cuda}"
