"""Official MS MARCO ranking scorer — file-level parity: the port's own
copy of ``ance_tpu/evaluation/msmarco_eval.py``.

Reference: utils/msmarco_eval.py (the verbatim official script). Loaders,
quality checks, and MRR@10 semantics are identical; the math lives in
:mod:`ance_tpu_torch.evaluation.metrics`.
"""

from __future__ import annotations

import sys
from typing import Mapping, TextIO

from ance_tpu_torch.evaluation.metrics import mrr_at_k, quality_checks

MaxMRRRank = 10


def load_reference_from_stream(f: TextIO) -> dict[int, list[int]]:
    """qrels: ``qid\\t_\\tpid\\t...`` (reference msmarco_eval.py:19-36)."""
    out: dict[int, list[int]] = {}
    for line in f:
        try:
            cells = line.strip().split("\t")
            out.setdefault(int(cells[0]), []).append(int(cells[2]))
        except Exception:
            raise IOError(f'"{line}" is not valid format')
    return out


def load_reference(path: str) -> dict[int, list[int]]:
    with open(path) as f:
        return load_reference_from_stream(f)


def load_candidate_from_stream(f: TextIO) -> dict[int, list[int]]:
    """candidates: ``qid\\tpid\\trank``; 1000 slots, 0 = unfilled
    (reference msmarco_eval.py:47-68)."""
    out: dict[int, list[int]] = {}
    for line in f:
        try:
            qid_s, pid_s, rank_s = line.strip().split("\t")
            qid, pid, rank = int(qid_s), int(pid_s), int(rank_s)
            if qid not in out:
                out[qid] = [0] * 1000
            out[qid][rank - 1] = pid
        except Exception:
            raise IOError(f'"{line}" is not valid format')
    return out


def load_candidate(path: str) -> dict[int, list[int]]:
    with open(path) as f:
        return load_candidate_from_stream(f)


def compute_metrics(qids_to_relevant_passageids: Mapping[int, list[int]],
                    qids_to_ranked_candidate_passages: Mapping[int, list[int]]
                    ) -> dict:
    return mrr_at_k(qids_to_relevant_passageids,
                    qids_to_ranked_candidate_passages, k=MaxMRRRank)


def compute_metrics_from_files(path_to_reference: str,
                               path_to_candidate: str,
                               perform_checks: bool = True) -> dict:
    qrels = load_reference(path_to_reference)
    candidates = load_candidate(path_to_candidate)
    if perform_checks:
        allowed, message = quality_checks(candidates)
        if message:
            print(message)
    return compute_metrics(qrels, candidates)


def main() -> None:
    if len(sys.argv) == 3:
        metrics = compute_metrics_from_files(sys.argv[1], sys.argv[2])
        print("#####################")
        for metric in sorted(metrics):
            print(f"{metric}: {metrics[metric]}")
        print("#####################")
    else:
        print("Usage: msmarco_eval.py <reference ranking> <candidate ranking>")
        sys.exit(1)


if __name__ == "__main__":
    main()
