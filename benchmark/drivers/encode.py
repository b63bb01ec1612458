"""Corpus encode into the exact index: a refresh's E item.

Set-up writes the stream's token cache, makes the weights on the device,
builds the port's ``RobertaDot`` (eval, no dropout), allocates the fp32
``FlatIPIndex`` for the whole corpus (``index_records`` records, ``chunks``
rows each) and warms the encode batch's shape up. The window then encodes
whole slices of ``slice_records`` records through
``train/encode.py::encode_cache_to_device`` at the cell's batch and writes
each by ``FlatIPIndex.update_slice`` into the next slot of the index, as
``train/pipelined.py`` does, until ``seconds`` have passed; the cache's
slices are taken in turn. ``encode_docs_per_s`` is the records of every
slice over the window, which ends with a synchronize.

The check reads ``sample`` rows of the index the window wrote, drawn from
the seed, and compares each with the plain fp32 reference's embedding of
the same tokens: ``emb_rel_err`` is the largest ‖port − ref‖ / ‖ref‖.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import common, flops
from benchmark.harness import Check, Outcome
from benchmark.reference import encoder as ref
from benchmark.trace import TracedSlice
from benchmark.generator import load_streams
from benchmark.weights import make_weights


def record_rows(stream, records: np.ndarray, p: dict):
    """(ids [n·chunks, chunk_len], mask) of the records' rows, a record's
    chunks in order."""
    chunks, width = p["chunks"], stream.width
    ids = stream.tokens(records).reshape(len(records) * chunks,
                                         width // chunks)
    mask = ref.mask_from_lengths(stream.lengths[records], width).reshape(
        len(records) * chunks, width // chunks)
    return ids, mask


def work_lengths(stream, start: int, stop: int, p: dict) -> np.ndarray:
    """Real lengths of the sequences the encoder runs for records
    [start, stop): a record, or each chunk of a record."""
    lengths = stream.lengths[start:stop]
    if p["chunks"] == 1:
        return lengths
    return flops.chunk_lengths(lengths, stream.width // p["chunks"],
                               p["chunks"])


def run(cell):
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             make_encode_fn)
    cfg, p, dev = cell.config, cell.params, cell.device
    stream = load_streams(cell.traffic, cell.seed, cfg)[p["stream"]]
    path = stream.write_cache(cell.tmpdir)
    weights = make_weights(cfg, cell.seed, dev)
    model = common.port_model(cfg, weights, dev)
    del weights
    fn = make_encode_fn(model, getattr(RobertaDot, p["method"]), dev)
    probe = common.CacheProbe(TokenCache(path).open())
    multichunk = p["chunks"] > 1
    rows_per, per_slice = p["chunks"], p["slice_records"]
    slice_rows = per_slice * rows_per
    out_dim = cfg["embedding_head"]["out_dim"]
    index = FlatIPIndex(dim=out_dim, device=dev)
    index.allocate(p["index_records"] * rows_per, out_dim,
                   slice_rows=slice_rows)
    n_slots = index.rows_per_shard // slice_rows
    cache_slices = len(stream) // per_slice
    B = p["batch"]

    def encode_slice(start, stop, slot):
        emb, _ = encode_cache_to_device(fn, probe, B, multichunk=multichunk,
                                        start=start, stop=stop)
        index.update_slice(slot * slice_rows, emb)

    encode_slice(0, B * p["warmup_batches"], 0)
    common.sync(dev)
    probe.ms.clear()

    cell.window_opens()
    t0 = time.perf_counter()
    written = []  # (slot, first record) of each slice, in window order
    while True:
        j = len(written)
        start = (j % cache_slices) * per_slice
        encode_slice(start, start + per_slice, j % n_slots)
        written.append((j % n_slots, start))
        if time.perf_counter() - t0 >= cell.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    records = len(written) * per_slice
    model_flops = 0.0
    for _, start in written:
        lens = work_lengths(stream, start, start + per_slice, p)
        model_flops += flops.encoder_flops(lens, cfg,
                                           head_rows=int((lens > 0).sum()))
    obs = {"spans": {"feed": list(probe.ms)}, "window_s": window_s,
           "model_flops": model_flops}

    if cell.trace and dev.type == "cuda":
        n = p["trace_records"]
        with common.attention_range(), TracedSlice(
                os.path.join(cell.tmpdir, "trace.json"),
                ranges=("bench.attention",)) as traced:
            encode_slice(0, n, len(written) % n_slots)
        obs["trace"] = traced.summary
        obs["range_work"] = {"bench.attention": flops.attention_work(
            work_lengths(stream, 0, n, p), cfg)}
    peak = common.peak_bytes(dev)

    # the check: sampled rows of what the window wrote, then the reference
    # every slot as its last write left it (a long window wraps round)
    live = sorted(dict(written).items())
    pick = common.sample(cell.seed, 1, len(live) * slice_rows, p["sample"])
    w_slice, local = pick // slice_rows, pick % slice_rows
    slots = np.array([live[w][0] for w in w_slice])
    got = index._emb[torch.as_tensor(slots * slice_rows + local)].cpu()
    firsts = np.array([live[w][1] for w in w_slice])
    rec = firsts + local // rows_per
    chunk = local % rows_per
    del model, fn, index
    common.release(dev)
    checks, failed = compare(cell, stream, rec, chunk, got)
    return Outcome(attempted=records, failed=failed,
                   e2e={"encode_docs_per_s": records / window_s},
                   checks=checks, memory_peak_bytes=peak, obs=obs)


def reference_rows(cell, stream, rec, chunk, precision="fp32"):
    """The plain reference's embeddings of record ``rec``'s chunk
    ``chunk`` for each sampled row."""
    p = cell.params
    weights = make_weights(cell.config, cell.seed, cell.device)
    uniq, inv = np.unique(rec, return_inverse=True)
    ids, mask = record_rows(stream, uniq, p)
    rows = inv * p["chunks"] + chunk
    out = ref.encode_rows(weights, ids[rows], mask[rows], cell.config,
                          cell.device, precision=precision)
    return out.cpu()


def compare(cell, stream, rec, chunk, got):
    want = reference_rows(cell, stream, rec, chunk)
    err = common.rel_err_rows(got, want)
    limit = cell.params["limits"]["emb_rel_err"]
    return [Check("emb_rel_err", float(err.max()), limit)], \
        int((err > limit).sum())


def control(cell) -> dict:
    """The control's reading: the reference at float8 in the port's place,
    on the rows a run would sample from its first slices."""
    cfg, p = cell.config, cell.params
    stream = load_streams(cell.traffic, cell.seed, cfg)[p["stream"]]
    pick = common.sample(cell.seed, 1, len(stream) * p["chunks"],
                         p["sample"])
    rec, chunk = pick // p["chunks"], pick % p["chunks"]
    got = reference_rows(cell, stream, rec, chunk, precision="fp8")
    want = reference_rows(cell, stream, rec, chunk)
    return {"emb_rel_err": float(common.rel_err_rows(got, want).max())}
