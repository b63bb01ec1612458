"""The harness finds every piece by its name, and a new cell is new files
and an entry."""

import json
import shutil
from pathlib import Path

import bench_tiny
from benchmark import harness

ROOT = Path(bench_tiny.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_piece_is_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]) == harness.find("configs", c["name"])
        cfg = harness.read_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        workload = harness.read_json(harness.find("workloads", w["name"]))
        harness.find("traffic", w["traffic"])
        driver = harness.load_module("drivers", workload["driver"])
        assert callable(driver.run) and callable(driver.control)
    for m in BENCH["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert mod.read({}) is None  # nothing to read: no number
    assert harness.find("metrics", "idle.mine").name == "idle.py"
    assert harness.find("metrics", "feed_ms.encode").name == \
        "feed_ms.encode.py"


def test_each_cell_reports_setup_an_end_to_end_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e, per_layer = harness.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per_layer and all(m["moves"] in names for m in per_layer)


def test_cell_metrics_by_workload_lists():
    e2e, per_layer = harness.cell_metrics(BENCH, "firstp-encode")
    assert {m["name"] for m in e2e} == {"encode_docs_per_s", "setup_s"}
    assert {m["name"] for m in per_layer} == {
        "feed_ms.encode", "mfu.encode", "idle.encode"}
    _, per_layer = harness.cell_metrics(BENCH, "maxp-encode")
    assert "attention_roofline" in {m["name"] for m in per_layer}


def test_a_throwaway_workload_is_new_files_and_an_entry(tmp_path):
    """A copy of the benchmark's folder gains a workload file and the
    copy of BENCHMARK.json an entry; no file that was there changes, and
    the harness runs the new cell."""
    bench_dir = tmp_path / "bench"
    shutil.copytree(ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    wl = json.loads((bench_dir / "workloads" / "firstp-encode.json")
                    .read_text())
    (bench_dir / "workloads" / "throwaway.json").write_text(json.dumps(wl))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = dict(harness.cell_entry(bench, "firstp-encode"),
                 name="throwaway", traffic="msmarco-passages")
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "firstp-encode" in m.get("workloads", []):
            m["workloads"].append("throwaway")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    bench_tiny.CELLS["throwaway"] = bench_tiny.CELLS["firstp-encode"]
    code, line, err, _ = bench_tiny.run(
        "throwaway", extra=f", root=__import__('pathlib').Path("
                           f"{str(tmp_path)!r}), bench_dir=__import__("
                           f"'pathlib').Path({str(bench_dir)!r})")
    assert code == 0, err
    assert line["correct"] and "encode_docs_per_s" in line["metrics"]


def test_benchmark_json_keeps_to_the_contracts_shape():
    """Keys, names, units, texts and bounds of ``BENCHMARK.json`` as the
    contract allows them, and every cell reporting what it must."""
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    path = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")

    def text(s):
        return (isinstance(s, str) and 1 <= len(s) <= 200
                and "\n" not in s and "\t" not in s)

    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == [
        "benchmark"]
    assert all(path.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(text(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and c["file"].startswith("benchmark/")
        assert text(c["source"]) and text(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(name.match(k) for k in c["reduced"])
        assert c["file"] not in files and (ROOT / c["file"]).is_file()
        files.add(c["file"])
    assert 1 <= len(BENCH["workloads"]) <= 24
    cells, seen = set(), set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["chips"] == 1 and text(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        assert w["name"] not in cells
        seen.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    reports = {}  # end-to-end metric -> the cells that report it
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        reports[m["name"]] = set(m.get("workloads", cells))
    assert reports["setup_s"] == cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text(m["layer"]) and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= reports[m["moves"]]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        others = [e for e, ws in reports.items()
                  if e != "setup_s" and cell in ws]
        assert others
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


