"""The control, the plain reference one precision step below the
configuration's (float8 products for bf16; TF32 for the fp32 search) put
in the program's place, reads ``correct`` false: it fails one of each
cell's numbers. The encode control runs here at full width on a few rows;
the search's and the train step's need the card and run at the cell's
size (``cuda``)."""

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

import bench_tiny
from benchmark.harness import prepare

ROOT = Path(bench_tiny.ROOT)


def cell_and_driver(name, device, overrides=None):
    args = argparse.Namespace(workload=name, seed=2 ** 32 + 17, seconds=1,
                              trace=0)
    cell, driver, _, _ = prepare(args, time.perf_counter(), ROOT, device,
                                 None, overrides)
    return cell, driver


def fails(cell, readings: dict) -> list:
    limits = cell.params["limits"]
    return [n for n, lim in limits.items() if readings[n] > lim]


@pytest.mark.parametrize("name,stream", [("firstp-encode", "passages"),
                                         ("maxp-encode", "documents")])
def test_encode_control_fails_at_full_width(name, stream):
    torch.set_num_threads(4)
    over = {"params": {"sample": 4},
            "traffic": {"streams": {stream: {"records": 64}}}}
    cell, driver = cell_and_driver(name, torch.device("cpu"), over)
    assert fails(cell, driver.control(cell)) == ["emb_rel_err"]


@pytest.mark.cuda
def test_mine_control_fails_at_the_cells_size(card):
    cell, driver = cell_and_driver("firstp-mine", card)
    got = fails(cell, driver.control(cell))
    assert {"query_rel_err", "search_id_mismatch"} <= set(got), got


def test_limits_lie_between_the_recorded_readings():
    """Each limit is above the program's readings (the lower end) and
    below the upper end (the control's, or a fault's), as
    ``calibrate.py`` recorded them on the card (``limits.json``), and the
    workloads hold the limits recorded there."""
    rec = json.loads((ROOT / "benchmark" / "limits.json").read_text())
    for name, numbers in rec.items():
        wl = json.loads((ROOT / "benchmark" / "workloads" /
                         f"{name}.json").read_text())
        assert set(wl["params"]["limits"]) == set(numbers)
        for number, lim in wl["params"]["limits"].items():
            r = numbers[number]
            assert r["limit"] == lim
            assert r["lower"] <= lim < r["upper"], (name, number)
