"""The HTTP/JSON tax on the serving path (the port of
``docs/perf_http_r4.py``).

What the online layer adds on top of the in-process search: the JSON
parse of the request, the server's device lock, the JSON of the [B, k]
results and the localhost HTTP hop, everything in ``serve_http.py`` that
is not device work. A null-device ``Retriever`` (the encoder is the
one-hot of each query's second token over 8 dims, on the device; the
index an 8-dim ``FlatIPIndex(method="scan")`` holding ``eye(8)``) keeps
the device time near zero, so the per-batch wall time of a POST is the
HTTP layer. Token mode (ids and mask arrays), the production client's
shape. A line a batch, with the JAX script's keys (``direct_ms``,
``http_ms``, ``http_overhead_ms``, ``overhead_us_per_query``,
``http_qps_ceiling``), and ``answers_equal``: every HTTP answer of the
batch equal to the direct call's. The first line is the card's and the
host's (CPU model, cores): the layer is host code, and the JAX run was
on a 1-core host.

    python -m ance_tpu_torch.experiments.perf_http --device cuda
        [--batches 64,512,2048] [--reps 20] [--log http.jsonl]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import urllib.request
from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.experiments.demo import Log
from ance_tpu_torch.experiments.perf_feed import host_info
from ance_tpu_torch.experiments.perf_refresh8m8 import card
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.serve import Retriever
from ance_tpu_torch.serve_http import RetrieverHTTPServer

K = 10
REPS = 20
BATCHES = (64, 512, 2048)
SEQ = 16
NULL_DIM = 8
MAX_BATCH = 8192


def cuda_device(name: str) -> torch.device:
    """``name`` as a device; exits non-zero when it asks for a card and
    none is there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device")
    return device


def start_line(log: Log, device: torch.device, **fields) -> dict:
    """The log's first line: the card's name and power limit, and the
    host's CPU model and cores."""
    host = host_info(tempfile.gettempdir())
    return log(stage="device", **card(device),
               host={"cpu": host["cpu"], "cores": host["cores"]}, **fields)


def null_retriever(device) -> Retriever:
    """The JAX script's null-device retriever: one-hot of ``ids[:, 1]``
    over an 8-dim scan index holding ``eye(8)``."""
    device = torch.device(device)
    index = FlatIPIndex(NULL_DIM, device=device, method="scan")
    index.add(np.eye(NULL_DIM, dtype=np.float32))

    def encode(ids, mask):
        ids = torch.as_tensor(ids).to(device, torch.int64)
        return torch.nn.functional.one_hot(ids[:, 1], NULL_DIM).float()
    return Retriever(encode, index)


def token_batch(B: int) -> tuple[np.ndarray, np.ndarray]:
    """The script's batch: zeros but ``ids[:, 1] = arange(B) % 8``."""
    ids = np.zeros((B, SEQ), np.int32)
    ids[:, 1] = np.arange(B) % NULL_DIM
    return ids, np.ones_like(ids)


def post(url: str, payload: bytes) -> dict:
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def answers_equal(reply: dict, scores: np.ndarray, pids: np.ndarray) -> bool:
    """The HTTP results against the direct call's arrays (the server
    leaves out −1 slots)."""
    want = [[{"pid": int(p), "score": float(s)}
             for p, s in zip(prow, srow) if p >= 0]
            for prow, srow in zip(pids, scores)]
    return reply["results"] == want


def measure(r: Retriever, url: str, B: int, reps: int, k: int = K) -> dict:
    """One batch width: the direct call and the POST, each warmed once
    and timed over ``reps`` calls back to back."""
    ids, mask = token_batch(B)
    payload = json.dumps({"ids": ids.tolist(), "mask": mask.tolist(),
                          "k": k}).encode()
    scores, pids = r.search_tokens(ids, mask, k)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        r.search_tokens(ids, mask, k)
    direct_ms = (time.perf_counter() - t0) / reps * 1000

    equal = answers_equal(post(url, payload), scores, pids)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        reply = post(url, payload)
    http_ms = (time.perf_counter() - t0) / reps * 1000
    equal = equal and answers_equal(reply, scores, pids)
    overhead = http_ms - direct_ms
    return {"stage": "http", "batch": B, "k": k, "reps": reps,
            "direct_ms": direct_ms, "http_ms": http_ms,
            "http_overhead_ms": overhead,
            "overhead_us_per_query": overhead * 1000 / B,
            "http_qps_ceiling": B / http_ms * 1000,
            "answers_equal": equal}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batches", default=",".join(map(str, BATCHES)),
                   help="comma-separated batch widths")
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--log", default=None,
                   help="JSON-lines file the lines are appended to")
    return p.parse_args(argv)


def run(args, log: Optional[Log] = None) -> dict:
    """→ {"device": the start line, "http": [a line a batch]}."""
    log = log or Log(args.log)
    device = cuda_device(args.device)
    out = {"device": start_line(log, device), "http": []}
    r = null_retriever(device)
    srv = RetrieverHTTPServer(r, port=0, max_batch=MAX_BATCH).start()
    host, port = srv.address
    url = f"http://{host}:{port}/search"
    try:
        for B in (int(b) for b in args.batches.split(",")):
            out["http"].append(log(measure(r, url, B, args.reps)))
    finally:
        srv.shutdown()
    out["done"] = log(stage="done", done=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
