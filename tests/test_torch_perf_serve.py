"""The serving measurements (``ance_tpu_torch/experiments/perf_http.py``,
``perf_serve.py``, ``perf_liveserve.py``) on the CPU at tiny sizes,
against the JAX scripts they port (``docs/perf_http_r4.py``,
``perf_serve_r4.py``, ``perf_latency_r4.py``, ``perf_liveserve_r4.py``,
``perf_servetails_r5.py``, loaded by path; nothing under ``docs/`` is
written):

  * each module's sizes, batch widths, repetitions and schedule against
    its scripts' (the ``PipelineConfig`` and the loops' literals read from
    their source);
  * the dedup: the port's ``dedup_first_hit`` and the per-row loop the
    serve script keeps against the JAX ``dedup_first_hit`` and the
    script's own loop on seeded overfetched arrays with empty slots and
    repeated passages;
  * the latency summaries against the scripts' ``pcts``;
  * the HTTP server over the null-device retriever against the JAX
    server over the script's ``NullEncoder`` retriever, payload for
    payload;
  * each module end to end on ``--device cpu``: every line's stage and a
    superset of the JAX line's keys, both client arms' whole answers
    across a refresh boundary, the sampled live answers equal to the
    scan, the searches counted, no thread left;
  * a run asked for ``--device cuda`` without a card exits non-zero.
"""

import ast
import dataclasses
import faulthandler
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from ance_tpu_torch.experiments import (perf_http, perf_liveserve,
                                        perf_refresh8m8, perf_serve)
from ance_tpu_torch.serve import dedup_first_hit
from ance_tpu_torch.serve_http import RetrieverHTTPServer
from ance_tpu_torch.train import pipelined
from test_torch_perf_refresh import script, script_pipeline_config

torch.set_num_threads(1)

TINY = json.dumps({"num_layers": 1, "hidden_size": 16, "num_heads": 2,
                   "intermediate_size": 32})
CPU = ["--device", "cpu", "--dtype", "fp32"]


@pytest.fixture(autouse=True)
def _watchdog():
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def loop_literals(mod, target: str) -> list:
    """The tuples of the script's ``for <target> in (...)`` loops."""
    tree = ast.parse(open(mod.__file__).read())
    return [ast.literal_eval(n.iter) for n in ast.walk(tree)
            if isinstance(n, ast.For) and isinstance(n.target, ast.Name)
            and n.target.id == target and isinstance(n.iter, ast.Tuple)]


def call_args(mod, name: str) -> list:
    """The literal positional arguments of each ``name(...)`` call in the
    script that has any, in source order."""
    tree = ast.parse(open(mod.__file__).read())
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "attr",
                                getattr(n.func, "id", None)) == name),
                   key=lambda n: (n.lineno, n.col_offset))
    out = [tuple(a.value for a in n.args if isinstance(a, ast.Constant))
           for n in calls]
    return [a for a in out if a]


@pytest.mark.parametrize("which", ["http", "serve", "latency", "liveserve",
                                   "servetails"])
def test_sizes_are_the_scripts(which):
    if which == "http":
        mod = script("perf_http_r4")
        assert (perf_http.K, perf_http.REPS) == (mod.K, mod.REPS)
        assert loop_literals(mod, "B") == [perf_http.BATCHES]
        assert call_args(mod, "one_hot") == [(perf_http.NULL_DIM,)]
        assert call_args(mod, "eye") == [(perf_http.NULL_DIM,)]
    elif which == "serve":
        mod = script("perf_serve_r4")
        assert (perf_serve.N, perf_serve.D, perf_serve.K,
                perf_serve.VEC_PER_DOC, perf_serve.REPS, perf_serve.QLEN) \
            == (mod.N, mod.D, mod.K, mod.VEC_PER_DOC, mod.REPS, mod.QLEN)
        assert loop_literals(mod, "B") == [perf_serve.SERVE_BATCHES]
        assert call_args(mod, "RandomState") == [(perf_serve.SERVE_IDS_SEED,)]
        assert call_args(mod, "PRNGKey") == [
            (perf_serve.SERVE_CORPUS_SEED,), (perf_refresh8m8.INIT_SEED,)]
    elif which == "latency":
        mod = script("perf_latency_r4")
        assert (perf_serve.N, perf_serve.D, perf_serve.K,
                perf_serve.LATENCY_QLEN, perf_serve.LATENCY_REPS) == \
            (mod.N, mod.D, mod.K, mod.QLEN, mod.REPS)
        assert loop_literals(mod, "B") == [perf_serve.LATENCY_BATCHES]
        assert call_args(mod, "RandomState") == [
            (perf_serve.LATENCY_IDS_SEED,)]
        assert call_args(mod, "PRNGKey") == [
            (perf_refresh8m8.INIT_SEED,), (perf_serve.LATENCY_CORPUS_SEED,)]
    else:
        mod = script(f"perf_{which}_r{4 if which == 'liveserve' else 5}")
        pl = perf_liveserve
        assert (pl.N_P, pl.PLEN, pl.QLEN, pl.N_TQ, pl.N_DQ, pl.SERVE_B) == \
            (mod.N_P, mod.PLEN, mod.QLEN, mod.N_TQ, mod.N_DQ, mod.SERVE_B)
        assert call_args(mod, "warmup_linear") == [
            (pl.LR, pl.LR_WARMUP, pl.LR_TOTAL)]
        assert call_args(mod, "RandomState") == [(0,)]
        assert call_args(mod, "PRNGKey") == [(perf_refresh8m8.INIT_SEED,),
                                             (pl.LOOP_SEED,)]
        if which == "servetails":
            assert pl.N_CLIENTS == mod.N_CLIENTS
            assert call_args(mod, "sleep") == [(pl.IDLE_S,)]


@pytest.mark.parametrize("which", ["perf_liveserve_r4", "perf_servetails_r5"])
def test_liveserve_pipeline_config_is_the_scripts(which):
    want = script_pipeline_config(script(which))
    got = dataclasses.asdict(perf_liveserve.pipeline_config())
    assert {k: got[k] for k in want} == want
    defaults = dataclasses.asdict(pipelined.PipelineConfig())
    assert {k: v for k, v in got.items() if k not in want} == \
        {k: v for k, v in defaults.items() if k not in want}


def overfetched(seed: int, B: int, depth: int, n_rows: int):
    """Seeded overfetched search output: scores descending along each
    row, rows drawn with repeats from a corpus of 4 rows a passage, some
    rows cut short by empty (−1) slots, a few −1 scattered and one row
    empty."""
    rs = np.random.RandomState(seed)
    scores = -np.sort(-rs.randn(B, depth).astype(np.float32), axis=1)
    rows = rs.randint(0, n_rows, (B, depth)).astype(np.int64)
    for b in range(0, B, 3):  # fewer hits than the depth
        rows[b, rs.randint(1, depth):] = -1
    rows[rs.rand(B, depth) < 0.05] = -1
    rows[1] = -1  # a query with no hit
    return scores, rows, np.repeat(np.arange(n_rows // 4, dtype=np.int64), 4)


@pytest.mark.parametrize("seed,B,depth,n_rows,k", [
    (0, 64, 64, 400, 10), (1, 17, 40, 40, 10), (2, 8, 16, 8, 10),
    (3, 33, 64, 4000, 1)])
def test_dedup_is_the_jax_dedup(seed, B, depth, n_rows, k):
    from ance_tpu.serve import dedup_first_hit as jax_dedup
    mod = script("perf_serve_r4")
    scores, rows, e2id = overfetched(seed, B, depth, n_rows)
    want_s, want_i = jax_dedup(scores, rows, e2id, k)
    assert (want_i == -1).any() and (want_i >= 0).any()
    for fn in (dedup_first_hit, perf_serve.loop_dedup, mod.loop_dedup):
        got_s, got_i = fn(scores, rows, e2id, k)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)


def test_summaries_are_the_scripts():
    rs = np.random.RandomState(5)
    secs = list(rs.gamma(2.0, 0.004, 30))
    want = script("perf_latency_r4").pcts(secs)
    got = perf_serve.pcts(secs)
    assert {k: round(v, 2) for k, v in got.items()} == want
    ms = list(rs.gamma(2.0, 40.0, 353)) + [3911.1]
    want = script("perf_servetails_r5").pcts(ms)
    got = perf_liveserve.lat_pcts(ms)
    assert got["n"] == want["n"]
    assert {k: round(v, 1) for k, v in got.items() if k != "n"} == \
        {k: v for k, v in want.items() if k != "n"}


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_answers_are_the_jax_servers():
    """The port's server over the null-device retriever and the JAX
    server over the script's ``NullEncoder`` retriever answer the same
    payloads (token mode, B 1 and 64, k 1 and 10) with the same
    results."""
    from ance_tpu.index.flat import FlatIPIndex as JaxIndex
    from ance_tpu.serve import Retriever as JaxRetriever
    from ance_tpu.serve_http import RetrieverHTTPServer as JaxServer
    mod = script("perf_http_r4")
    jindex = JaxIndex(dim=8, method="scan")
    jindex.add(np.eye(8, dtype=np.float32))
    servers = [
        JaxServer(JaxRetriever(mod.NullEncoder(), params=None, index=jindex),
                  port=0, max_batch=perf_http.MAX_BATCH).start(),
        RetrieverHTTPServer(perf_http.null_retriever("cpu"), port=0,
                            max_batch=perf_http.MAX_BATCH).start()]
    try:
        urls = ["http://%s:%d/search" % s.address for s in servers]
        for B in (1, 64):
            ids, mask = perf_http.token_batch(B)
            for k in (1, 10):
                payload = {"ids": ids.tolist(), "mask": mask.tolist(),
                           "k": k}
                want, got = (_post(u, payload) for u in urls)
                assert got["results"] == want["results"], (B, k)
                assert got["k"] == want["k"] == k
                assert len(got["results"]) == B
                assert all(len(r) == min(k, 8) for r in got["results"])
    finally:
        for s in servers:
            s.shutdown()


def test_http_runs_on_the_cpu(tmp_path, capsys):
    log = tmp_path / "http.jsonl"
    out = perf_http.main(["--device", "cpu", "--batches", "8,64",
                          "--reps", "2", "--log", str(log)])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines == [json.loads(x)
                     for x in capsys.readouterr().out.splitlines()]
    first = lines[0]
    assert first["stage"] == "device" and first["name"] == "cpu"
    assert {"cpu", "cores"} <= set(first["host"])
    keys = {"batch", "k", "direct_ms", "http_ms", "http_overhead_ms",
            "overhead_us_per_query", "http_qps_ceiling"}
    assert [r["batch"] for r in out["http"]] == [8, 64]
    for rec in out["http"]:
        assert rec["stage"] == "http" and keys <= set(rec)
        assert rec["answers_equal"] is True
    assert lines[-1] == {"stage": "done", "done": True}


def test_serve_runs_on_the_cpu(tmp_path):
    log = tmp_path / "serve.jsonl"
    out = perf_serve.main(CPU + [
        "--corpus", "2048", "--serve_batches", "8,16", "--reps", "2",
        "--latency_batches", "1,4", "--latency_reps", "3",
        "--encoder_overrides", TINY, "--log", str(log)])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines[0]["stage"] == "device" and lines[0]["N"] == 2048
    assert [r["stage"] for r in out["serve"]] == \
        ["serve", "dedup", "dedup"] * 2
    for rec in out["serve"]:
        if rec["stage"] == "serve":
            assert {"serve_batch", "k", "qps", "ms_median",
                    "ms_spread"} <= set(rec)
            assert rec["scan_equal"] is True and rec["route"] == "plain"
            assert rec["calls"] == 2 and rec["launches"] == {}
        else:
            assert {"dedup", "batch", "ms"} <= set(rec)
            assert rec["equal"] is True
    assert [r["dedup"] for r in out["serve"] if r["stage"] == "dedup"] == \
        ["vectorized", "loop"] * 2
    stages = ["encode", "search_bf16", "search_int8", "request_e2e_bf16"]
    assert [(r["stage"], r["batch"]) for r in out["latency"]] == \
        [(s, b) for b in (1, 4) for s in stages]
    for rec in out["latency"]:
        assert {"stage", "batch", "p50_ms", "p95_ms", "min_ms"} <= set(rec)
        assert rec["min_ms"] <= rec["p50_ms"] <= rec["p95_ms"]
        if rec["stage"].startswith("search"):
            assert {"corpus", "k"} <= set(rec) and rec["corpus"] == 2048
            assert rec["scan_equal"] is True
    assert lines[-1] == {"stage": "done", "done": True}


def test_liveserve_runs_on_the_cpu(monkeypatch, tmp_path):
    """Both client arms across whole cycles of a tiny loop (one layer of
    width 16, 16 out, 256 passages in slices of 128; no cycle off the
    clock): every stage
    with the scripts' keys, every answer whole, the sampled live searches
    equal to the scan, every search counted, no thread left."""
    monkeypatch.setattr(perf_refresh8m8, "OUT_DIM", 16)
    before = set(threading.enumerate())
    log = tmp_path / "live.jsonl"
    out = perf_liveserve.main(CPU + [
        "--passages", "256", "--train_q", "32", "--dev_q", "8",
        "--slice", "128", "--idle_s", "0.5", "--clients", "thread,process",
        "--warm_cycles", "0", "--encoder_overrides", TINY,
        "--log", str(log)])
    stages = [json.loads(x)["stage"] for x in log.read_text().splitlines()]
    assert stages == ["device", "bootstrap_s", "train_alone",
                      "train_while_serving"] + [
        "ready", "idle_chip", "during_refresh_cycle"] * 2 + [
        "kernels", "done"]
    keys = {"bootstrap_s": {"value", "ntotal", "steps_per_cycle"},
            "train_alone": {"steps", "wall_s", "refreshes", "steps_per_s"},
            "train_while_serving": {
                "steps", "wall_s", "refreshes", "steps_per_s",
                "train_slowdown_pct", "search_batches_served",
                "served_qps"},
            "ready": {"ntotal", "steps_per_cycle", "clients", "batch"},
            "idle_chip": {"n", "p50_ms", "p90_ms", "p99_ms", "max_ms", "qps",
                          "lock_wait_ms_per_req"},
            "during_refresh_cycle": {
                "n", "p50_ms", "p90_ms", "p99_ms", "max_ms", "cycle_wall_s",
                "served_qps", "lock_wait_ms_per_req"}}
    for stage, want in keys.items():
        recs = out[stage] if isinstance(out[stage], list) else [out[stage]]
        for rec in recs:
            assert want <= set(rec), stage
    assert out["bootstrap_s"]["ntotal"] == 256
    steps = out["bootstrap_s"]["steps_per_cycle"]
    assert steps == 8 * 8  # 2 E, D, S, V, Q, M, F
    for rec in [out["train_alone"], out["train_while_serving"]] + \
            out["during_refresh_cycle"]:
        assert rec["refreshes"] == 1 and rec["step_gap"]["n"] == steps - 1
    assert [r["client_arm"] for r in out["during_refresh_cycle"]] == \
        ["thread", "process"]
    served = 2 + out["train_while_serving"]["search_batches_served"]
    for rec in out["idle_chip"] + out["during_refresh_cycle"]:
        assert rec["n"] > 0 and rec["errors"] == 0 and rec["partial"] == 0
        served += rec["n"]
    for rec in [out["train_while_serving"]] + out["idle_chip"] + \
            out["during_refresh_cycle"]:
        live = rec["live_vs_scan"]
        assert live["all_equal"] is True, rec["stage"]
        assert live["samples"] >= min(32, live["searches"]) > 0
        assert rec["lock"]["serve"]["n"] == live["searches"]
    # the loop's lock sections: a slice write each E item, the swap at F
    assert out["during_refresh_cycle"][0]["lock"]["loop"]["n"] >= 3
    k = out["kernels"]
    assert k["served_searches"] == served
    assert k["sm_items"] == 2 * 5  # bootstrap and 4 cycles, 1 S + 1 M each
    assert k["launches"] == {} and k["launches_equal"] is None
    assert out["done"]["threads_left"] == []
    assert out["done"]["feed_threads_after_close"] == 0
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


@pytest.mark.parametrize("mod", [perf_http, perf_serve, perf_liveserve],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_without_a_card_exits_nonzero(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(SystemExit) as e:
        mod.main(["--device", "cuda"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kind", [{}, {"quantize": "dims"},
                                  {"dtype": torch.bfloat16}],
                         ids=["fp32", "dims", "bf16"])
def test_live_samples_are_held_to_the_scan(kind):
    """The live-search check: a search recorded inside the lock is held
    to a scan of the index as it stood (a later slice write does not
    move it), and one whose rows differ is re-searched alone and its
    rows' exact scores set against the scan's."""
    from ance_tpu_torch.index.flat import FlatIPIndex
    rs = np.random.RandomState(3)
    index = FlatIPIndex(32, device="cpu", **kind)
    index.allocate(2048, 32, slice_rows=1024,
                   scales=np.full(32, 0.05, np.float32)
                   if kind.get("quantize") else None)
    for s in (0, 1024):
        index.update_slice(s, rs.randn(1024, 32).astype(np.float32))
    rec = perf_liveserve.Recorder(samples=2)
    rec.attach(index)
    rec.arm()
    q = torch.as_tensor(rs.randn(8, 32).astype(np.float32))
    _, rows = index.search(q, 16)
    wrong = rows.clone()
    wrong[:, -1] = torch.as_tensor(
        [next(r for r in range(2048) if r not in set(row.tolist()))
         for row in rows])  # a row outside each query's top 16
    # 7 searches, 2 x 2 samples at most: the stride doubles twice and
    # searches 0 and 4 are kept
    for i in range(7):
        rec.record(index, q, wrong if i == 4 else rows)
    index.update_slice(0, rs.randn(1024, 32).astype(np.float32))
    assert rec.version == 1  # the write after attach
    out = rec.verify(index)
    assert out["searches"] == 7 and out["states"] == 1
    assert out["samples"] == 2 and out["equal"] == 1
    assert not out["all_equal"] and out["first_unequal"] == 1
    assert out["rerun_equal_scan"] == 1 and out["rerun_equal_live"] == 0
    assert out["max_rel_score_gap"] > 0
