"""Corpus encode into the exact index with the DeepSeek-V2 dual encoder
(``dsv2dot_nll``): a refresh's E item over an MoE + MLA decoder.

The encode driver's window and check (``drivers/encode.py``) with the
model built from the registry's ``dsv2dot_nll``. Set-up looks the model
type up first (a port without it fails here, before any other set-up),
writes the stream's token cache, makes the weights on the device a leaf at
a time (``weights_dsv2.py``) and hands them to the model built on the meta
device (no copy), allocates the fp32 ``FlatIPIndex`` for the whole corpus
and warms the batch's shape up (the grouped kernels compile there). The
window encodes whole slices of ``slice_records`` records through
``train/encode.py::encode_cache_to_device`` at the cell's batch and writes
each by ``FlatIPIndex.update_slice`` into the next slot of the index until
``seconds`` have passed. ``encode_docs_per_s`` is the records of every
slice over the window, which ends with a synchronize.

A traced run profiles ``trace_records`` more records and reads the device
time of the kernels launched inside the program's ``encoder.moe.experts``
spans (``experts_roofline``) and, from the spans' own store, the device ms
of ``encoder.moe.route`` a batch (``route_ms.encode``).

The check reads ``sample`` rows of the index the window wrote, drawn from
the seed, and compares each with the plain fp32 reference's embedding of
the same tokens (``reference/deepseek_v2.py``): ``emb_rel_err`` is the
largest ‖port − ref‖ / ‖ref‖.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import common, flops_moe
from benchmark.generator import load_streams
from benchmark.harness import Check, Outcome
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference.encoder import mask_from_lengths
from benchmark.trace import TracedSlice
from benchmark.weights_dsv2 import make_weights

EXPERTS = "encoder.moe.experts"


def port_model(cfg: dict, seed: int, device, spec):
    """The registry's model on ``device`` holding the seed's weights
    (built on the meta device, the weights assigned strictly: every name
    must match), in eval mode."""
    from ance_tpu_torch.models.deepseek_v2 import DeepseekV2Config
    with torch.device("meta"):
        model = spec.build(dtype=common.DTYPES[cfg["dtype"]],
                           config_overrides=DeepseekV2Config.hf_overrides(
                               cfg))
    model.load_state_dict(make_weights(cfg, seed, device), strict=True,
                          assign=True)
    return model.eval()


def run(cell):
    from ance_tpu_torch.models.registry import get_model_spec
    cfg, p, dev = cell.config, cell.params, cell.device
    spec = get_model_spec(cfg["port_model_type"])
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             make_encode_fn)
    stream = load_streams(cell.traffic, cell.seed, cfg)[p["stream"]]
    path = stream.write_cache(cell.tmpdir)
    model = port_model(cfg, cell.seed, dev, spec)
    fn = make_encode_fn(model, getattr(type(model), p["method"]), dev)
    probe = common.CacheProbe(TokenCache(path).open())
    per_slice = p["slice_records"]
    out_dim = cfg["embedding_head"]["out_dim"]
    index = FlatIPIndex(dim=out_dim, device=dev)
    index.allocate(p["index_records"], out_dim, slice_rows=per_slice)
    n_slots = index.rows_per_shard // per_slice
    cache_slices = len(stream) // per_slice
    B = p["batch"]

    def encode_slice(start, stop, slot):
        emb, _ = encode_cache_to_device(fn, probe, B, start=start, stop=stop)
        index.update_slice(slot * per_slice, emb)

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
    model_flops = sum(flops_moe.encoder_flops(
        stream.lengths[start:start + per_slice], cfg) for _, start in written)
    obs = {"spans": {"feed": list(probe.ms)}, "window_s": window_s,
           "model_flops": model_flops}

    if cell.trace and dev.type == "cuda":
        n = p["trace_records"]
        with TracedSlice(os.path.join(cell.tmpdir, "trace.json"),
                         ranges=(EXPERTS,)) as traced:
            encode_slice(0, n, len(written) % n_slots)
        obs["trace"] = traced.summary
        obs["range_work"] = {EXPERTS: flops_moe.experts_work(
            stream.lengths[:n], -(-n // B), cfg)}
    peak = common.peak_bytes(dev)

    # the check: sampled rows of what the window wrote, then the reference
    # every slot as its last write left it (a long window wraps round)
    live = sorted(dict(written).items())
    pick = common.sample(cell.seed, 1, len(live) * per_slice, p["sample"])
    w_slice, local = pick // per_slice, pick % per_slice
    slots = np.array([live[w][0] for w in w_slice])
    got = index._emb[torch.as_tensor(slots * per_slice + local)].cpu()
    rec = np.array([live[w][1] for w in w_slice]) + local
    del model, fn, index
    common.release(dev)
    checks, failed = compare(cell, stream, rec, got)
    return Outcome(attempted=records, failed=failed,
                   e2e={"encode_docs_per_s": records / window_s},
                   checks=checks, memory_peak_bytes=peak, obs=obs)


def reference_rows(cell, stream, rec, precision="fp32"):
    """The plain reference's embeddings of records ``rec``."""
    uniq, inv = np.unique(rec, return_inverse=True)
    ids = stream.tokens(uniq)
    mask = mask_from_lengths(stream.lengths[uniq], stream.width)
    out = ref.encode_rows(cell.config, cell.seed, ids, mask, cell.device,
                          precision=precision, block=cell.params["ref_block"])
    return out.cpu()[torch.as_tensor(inv)]


def compare(cell, stream, rec, got):
    want = reference_rows(cell, stream, rec)
    err = common.rel_err_rows(got, want)
    limit = cell.params["limits"]["emb_rel_err"]
    return [Check("emb_rel_err", float(err.max()), limit)], \
        int((err > limit).sum())


def control(cell) -> dict:
    """The control's reading: the reference at float8 in the port's place,
    on the rows a run would sample from its first slices."""
    p = cell.params
    stream = load_streams(cell.traffic, cell.seed, cell.config)[p["stream"]]
    rec = common.sample(cell.seed, 1, len(stream), p["sample"])
    got = reference_rows(cell, stream, rec, precision="fp8")
    want = reference_rows(cell, stream, rec)
    return {"emb_rel_err": float(common.rel_err_rows(got, want).max())}
