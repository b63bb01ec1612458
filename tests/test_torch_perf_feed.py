"""The host-feed scripts (``ance_tpu_torch/experiments/perf_feed.py``,
``perf_loopfeed.py``) on the CPU at tiny sizes, against the JAX scripts
they port (``docs/perf_feed_r5.py``, ``docs/perf_loopfeed_r5.py``, loaded
by path) where the two share a definition: the feed's seven phases with
the JAX script's names and keys, its random triples, its eviction of its
own files; the loop feed's ``PipelineConfig``, its two arms' batches equal
across refresh boundaries and the feed threads it counts."""

import ast
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ance_tpu_torch.data.feed import feed_threads, live_feed_threads
from ance_tpu_torch.experiments import perf_feed, perf_loopfeed
from ance_tpu_torch.train import pipelined
from test_torch_perf_refresh import script

torch.set_num_threads(1)

LOOP_TINY = ["--device", "cpu", "--dtype", "fp32", "--passages", "256",
             "--train_q", "32", "--dev_q", "8", "--slice", "128",
             "--cycles", "1", "--encoder_overrides", json.dumps(
                 {"num_layers": 1, "hidden_size": 16, "num_heads": 2,
                  "intermediate_size": 32})]


def test_feed_phases_are_the_scripts(tmp_path):
    """The seven phases in the JAX script's order with its names, cold
    where it is, and each line's keys a superset of the JAX measure's."""
    mod = script("perf_feed_r5")
    src = open(mod.__file__).read()
    want = [(e.elts[0].value, e.elts[2].id, e.elts[3].value)
            for e in ast.walk(ast.parse(src))
            if isinstance(e, ast.Tuple) and len(e.elts) == 4
            and isinstance(e.elts[0], ast.Constant)
            and isinstance(e.elts[2], ast.Name)]
    got = [(n, m.__name__, c) for n, _, m, c in perf_feed.PHASES]
    assert got == want and len(got) == 7
    assert (perf_feed.N_PASSAGES, perf_feed.N_QUERIES, perf_feed.PLEN,
            perf_feed.QLEN, perf_feed.B, perf_feed.N_BATCHES) == (
        mod.N_PASSAGES, mod.N_QUERIES, mod.PLEN, mod.QLEN, mod.B,
        mod.N_BATCHES)
    assert perf_feed.N_PASSAGES * (4 + 4 * perf_feed.PLEN) == 18_143_420_796

    # the triples the JAX script draws
    rs = np.random.RandomState(7)
    n = perf_feed.B * (20 + 8)
    np.testing.assert_array_equal(
        perf_feed.make_triples(1000, 5000, 20),
        np.stack([rs.randint(0, 1000, n), rs.randint(0, 5000, n),
                  rs.randint(0, 5000, n)], axis=1))


def test_feed_runs_on_the_cpu(tmp_path, capsys):
    before = feed_threads()
    out = perf_feed.main(["--step_ms", "2", "--root", str(tmp_path),
                          "--passages", "3000", "--queries", "500",
                          "--batches", "6",
                          "--log", str(tmp_path / "feed.jsonl")])
    lines = [json.loads(x) for x in
             (tmp_path / "feed.jsonl").read_text().splitlines()]
    assert lines == [json.loads(x)
                     for x in capsys.readouterr().out.splitlines()]
    host = lines[0]
    assert {"cpu", "cores", "fs", "mount", "free_gb"} <= set(host["host"])
    assert host["reduced"] is None and host["passages"] == 3000
    keys = {"batch_times": {"batches", "p50_ms", "p99_ms", "mean_ms",
                            "rows_per_s"},
            "simulated_train": {"batches", "stall_p50_ms", "stall_p99_ms",
                                "stall_mean_ms", "step_overhead_pct",
                                "step_ms"}}
    for name, _, measure, cold in perf_feed.PHASES:
        rec = out[name]
        assert keys[measure.__name__] <= set(rec), name
        assert rec["batches"] == 6 and rec["cold"] is cold
        share = rec["resident_share_at_start"]
        assert share is None or 0.0 <= share <= 1.0
    assert lines[-1] == {"done": True}
    # every phase closed its feed: its prefetch worker and pool are gone
    deadline = time.time() + 5
    while live_feed_threads(before) and time.time() < deadline:
        time.sleep(0.05)
    assert live_feed_threads(before) == 0


def test_eviction_drops_the_files_pages(tmp_path):
    """A file just written is resident; evicted, its pages leave the page
    cache, but on a filesystem that lives in memory (tmpfs, ramfs), which
    has nowhere to drop them."""
    path = str(tmp_path / "f")
    with open(path, "wb") as f:
        f.write(os.urandom(1 << 22))
    before = perf_feed.resident_share(path)
    perf_feed.evict([path])
    after = perf_feed.resident_share(path)
    assert before is not None and after is not None, "no mincore"
    assert before > 0.5
    if perf_feed.host_info(str(tmp_path))["fs"] in ("tmpfs", "ramfs"):
        assert after == before
    else:
        assert after < before


def test_fit_passages_cuts_to_the_room():
    rec = 4 + 4 * perf_feed.PLEN
    room = perf_feed.ROOM_MARGIN_BYTES + 100 * (4 + 4 * perf_feed.QLEN)
    assert perf_feed.fit_passages(room + 50 * rec + 7, 1000, 100) == 50
    assert perf_feed.fit_passages(room + 5000 * rec, 1000, 100) == 1000
    assert perf_feed.fit_passages(0, 1000, 100) == 0


def test_loopfeed_pipeline_config_is_the_scripts():
    mod = script("perf_loopfeed_r5")
    call = next(n for n in ast.walk(ast.parse(open(mod.__file__).read()))
                if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "PipelineConfig")
    want = {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg != "feed_workers"}
    for workers in (0, 8):
        got = dataclasses.asdict(perf_loopfeed.pipeline_config(workers))
        assert {k: got[k] for k in want} == want
        assert got["feed_workers"] == workers
        defaults = dataclasses.asdict(pipelined.PipelineConfig())
        assert {k: v for k, v in got.items()
                if k not in want and k != "feed_workers"} == \
            {k: v for k, v in defaults.items()
             if k not in want and k != "feed_workers"}
    assert (perf_loopfeed.N_P, perf_loopfeed.N_TQ, perf_loopfeed.N_DQ) == \
        (mod.N_P, mod.N_TQ, mod.N_DQ)


def test_loopfeed_arms_agree_and_leave_no_thread(capsys):
    """A tiny loop with ``feed_workers`` 8 and 0: the same batches in the
    same order from the bootstrap's feed across a refresh boundary; the
    prefetched arm's pool is counted while it lives, and no feed thread
    is left after either loop is closed."""
    out = perf_loopfeed.main(LOOP_TINY)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    arms = {x["arm"]: x for x in lines if "arm" in x}
    assert out["batches_equal"] is True and out["first_difference"] is None
    assert out["batches_compared"] == arms["serial"]["batches"] > 0
    assert out["triples_equal_by_feed"] == [True, True, True]
    assert out["steps_on_equal_triples"] == out["batches_compared"]
    assert out["batches_equal_on_equal_triples"] is True
    for arm, rec in arms.items():
        assert rec["refreshes"] == 1 and rec["index_dtype"] == \
            "torch.bfloat16"
        assert rec["feed_threads_leaked"] == 0, arm
        assert rec["batches_equal_serial_regather"] is True, arm
        assert rec["feeds"] == 3, arm  # bootstrap, off the clock, timed
        assert {"s_per_cycle", "feed_threads_live", "feed_threads_leaked",
                "train_steps_taken", "bootstrap_s"} <= set(rec)
    assert 1 <= arms["prefetched"]["feed_threads_live"] <= 8
    assert arms["serial"]["feed_threads_live"] == 0
    assert "prefetched_vs_serial_pct" in out
