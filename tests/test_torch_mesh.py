"""``ance_tpu_torch/core/mesh.py`` and what the multi-rank CLI refuses, the
rank striping of the feeds against the JAX package's host striping, and
:func:`spawn_ranks`, which the other ``test_torch_mesh_*`` files use: gloo
ranks as processes of ``ance_tpu_torch.experiments.mesh_worker`` that meet
through a ``file://`` rendezvous under the test's directory, each with a
time limit (a hung rank fails the test instead of stalling the run)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ance_tpu.data import feed as jax_feed
from ance_tpu.train import seed_pretrain as jax_seed
from ance_tpu_torch.core import mesh as pmesh
from ance_tpu_torch.data import feed as port_feed
from ance_tpu_torch.train import seed_pretrain as port_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240  # a rank's process; its group's collectives wait 120 s


def spawn_ranks(tmp_path, world: int, cases: list, name: str = "job"
                ) -> dict:
    """Run ``cases`` in a gloo group of ``world`` spawned ranks; returns
    {case name: [rank 0's result, rank 1's, ...]}."""
    out = tmp_path / f"{name}_out"
    out.mkdir()
    job = {"init_method": f"file://{tmp_path / (name + '_rendezvous')}",
           "world": world, "device": "cpu", "backend": "gloo",
           "timeout_s": 120, "out_dir": str(out), "cases": cases}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(job))
    run_ranks([str(path)], world)
    return {c.get("name", c["case"]): [
        torch.load(out / f"{c.get('name', c['case'])}_rank{r}.pt",
                   weights_only=False) for r in range(world)]
        for c in cases}


def run_ranks(argv: list, world: int, module: str =
              "ance_tpu_torch.experiments.mesh_worker") -> list:
    """``python -m module *argv RANK`` for every rank, at once, each
    within RANK_TIMEOUT_S; every rank must exit 0. Returns their stdout."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [o for o, _ in outs]


def test_one_process_starts_no_group():
    """``num_processes`` None or 1: no group, one device, no mesh."""
    assert pmesh.initialize_distributed(None, None, None) == (0, 1)
    assert pmesh.initialize_distributed("127.0.0.1:1", 1, 0) == (0, 1)
    assert not torch.distributed.is_initialized()
    assert pmesh.make_mesh("cpu") is None
    assert pmesh.pad_to_multiple(10, 4) == 12
    assert pmesh.pad_to_multiple(12, 4) == 12
    batch = {"x": np.arange(4)}
    assert pmesh.shard_batch(batch) is batch


def test_mesh_blocks_and_card_refusal():
    """A rank's block of a batch; NCCL's refusal of ranks that share a
    card names gloo, before NCCL's own error; start_group's argument
    checks exit before any rendezvous."""
    m = pmesh.DataMesh(rank=1, world=4, device=torch.device("cpu"),
                       backend="gloo")
    assert m.block(8) == slice(2, 4) and m.size == 4
    with pytest.raises(ValueError, match="does not split"):
        m.block(6)
    pmesh.check_distinct_cards(["h/GPU-a", "h/GPU-b", "g/GPU-a"])
    with pytest.raises(SystemExit, match="--dist_backend gloo"):
        pmesh.check_distinct_cards(["h/GPU-a", "h/GPU-b", "h/GPU-a"])
    with pytest.raises(SystemExit, match="needs --device cuda"):
        pmesh.start_group("file:///nonexistent", 2, 0, device="cpu",
                          backend="nccl")
    with pytest.raises(SystemExit, match="outside"):
        pmesh.start_group("file:///nonexistent", 2, 2, device="cpu")
    with pytest.raises(SystemExit, match="--coordinator_address"):
        pmesh.initialize_distributed(None, 2, 0)
    assert not torch.distributed.is_initialized()


def test_collectives_and_replication_check(tmp_path):
    """Two gloo ranks: the sharded index's collectives run, and the
    replication check passes on equal parameters and names the first
    tensor that differs between ranks."""
    cases = [{"case": "flat", "name": "tiny",
              "data": str(_tiny_index_data(tmp_path)), "modes": ["none"],
              "ks": [3], "slice_rows": 4}, {"case": "replicated"}]
    got = spawn_ranks(tmp_path, 2, cases)
    (s0, i0), (s1, i1) = (r["none/k3"] for r in got["tiny"])
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    for r in got["replicated"]:
        assert "rank 1" in r["error"] and "(first: c)" in r["error"]


def _tiny_index_data(tmp_path):
    rs = np.random.RandomState(0)
    path = tmp_path / "tiny.npz"
    np.savez(path, corpus=rs.randn(9, 4).astype(np.float32),
             queries=rs.randn(2, 4).astype(np.float32))
    return path


def test_cli_refusals(tmp_path):
    """What the multi-rank CLI refuses, each before a group starts:
    ``ance-loop --http`` over ranks (JAX's message), more than one process
    without data parallelism, ``--tensor_parallel`` other than 1 (naming
    the ROADMAP), and NCCL on the CPU."""
    from ance_tpu_torch.cli import main
    ranks = ["--num_processes", "2", "--process_id", "0",
             "--coordinator_address", "127.0.0.1:1"]
    common = ["--device", "cpu", "--data_dir", str(tmp_path),
              "--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="single-host only"):
        main(["ance-loop", *common, *ranks, "--http", "127.0.0.1:0"])
    for cmd in (["train", "--ann_dir", str(tmp_path)], ["ance-loop"],
                ["warmup", "--train_file", "x"]):
        with pytest.raises(SystemExit, match="requires data parallelism"):
            main([*cmd, *common, *ranks, "--no_data_parallel"])
    for cmd in ("generate", "infer"):
        with pytest.raises(SystemExit, match="ROADMAP"):
            main([cmd, *common, "--training_dir", str(tmp_path),
                  "--tensor_parallel", "2"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        main(["generate-dpr", *common, "--wiki_path", "x",
              "--training_dir", str(tmp_path), "--tensor_parallel", "2"])
    with pytest.raises(SystemExit, match="needs --device cuda"):
        main(["train", "--ann_dir", str(tmp_path), *common, *ranks,
              "--dist_backend", "nccl"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("num_hosts", [2, 3, 4])
def test_triplet_batches_stripe_as_jax(num_hosts):
    """``TripletBatches(host_id, num_hosts)``: every host's batches id for
    id JAX's (stripe, then shuffle the stripe), ``__len__`` included, and
    the stripes together cover every triple once."""
    rs = np.random.RandomState(num_hosts)
    triples = rs.randint(0, 50, (23, 3)).astype(np.int64)
    seen = []
    for host in range(num_hosts):
        kw = dict(query_cache=None, passage_cache=None, triples=triples,
                  batch_size=2, seed=7, host_id=host, num_hosts=num_hosts)
        port, ref = port_feed.TripletBatches(**kw), \
            jax_feed.TripletBatches(**kw)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            np.testing.assert_array_equal(port._epoch_triples(epoch),
                                          ref._epoch_triples(epoch))
        seen.append(port._epoch_triples(0))
    np.testing.assert_array_equal(np.sort(np.concatenate(seen), axis=0),
                                  np.sort(triples, axis=0))


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_seed_pretrain_batches_stripe_as_jax(tmp_path, num_hosts):
    """``seed_pretrain_batches(host_id, num_hosts)``: each host's batches
    byte-identical to JAX's (one shuffle, host-seeded masking), every host
    the same number of batches."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
    rs = np.random.RandomState(3)
    with TokenCacheWriter(str(tmp_path / "c"), 16) as w:
        for _ in range(23):
            n = rs.randint(4, 17)
            row = np.ones(16, np.int32)
            row[:n] = rs.randint(5, 60, n)
            row[0] = 0
            w.write(n, row)
    kw = dict(mask_token_id=60, vocab_size=61, special_ids=[0, 1, 2],
              seed=5, epoch=1)
    counts = set()
    with TokenCache(str(tmp_path / "c")) as pc, \
            JaxCache(str(tmp_path / "c")) as jc:
        for host in range(num_hosts):
            port = list(port_seed.seed_pretrain_batches(
                pc, 3, host_id=host, num_hosts=num_hosts, **kw))
            ref = list(jax_seed.seed_pretrain_batches(
                jc, 3, host_id=host, num_hosts=num_hosts, **kw))
            assert len(port) == len(ref) > 0
            counts.add(len(port))
            for a, b in zip(port, ref):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert len(counts) == 1
