"""HNSW on the host: build rate and the recall@10 / qps curve against exact
search on the card.

The port's counterpart of ``docs/perf_hnsw_r5.py``: the port's C++ core
(``ance_tpu_torch/native/hnsw.cpp``, single-threaded) behind
``DenseHnswIndexer`` (store_n 512: 32 links a node, ef_construction 200),
at D = 768 (+1 aux dimension), over ``--data unit`` (unit random vectors,
as the JAX package's script measures it) or ``--data clustered``
(``experiments/perf_ivf.py``'s mixture: unit centres, 256 rows a centre,
noise of norm ~0.5; queries are rows plus noise of norm ~0.3), the
geometry encoder embeddings have. It prints one JSON line each for:

  * ``host``: the host CPU (``lscpu``'s model name and CPU count,
    ``/proc/cpuinfo``'s model name and vector extensions) and the card
    (``nvidia-smi --query-gpu=name,power.limit``);
  * ``distance_ab`` (unless ``--ab-rows 0``): inserts/s of three builds
    of the core on the same ``--ab-rows`` rows, in turns, all with the
    package's g++ flags: the port's (``lanes``: 16 partial sums in a
    written-out order), ``serial`` (one ``s += d*d`` chain, what -O3 may
    not vectorise) and ``reassociating`` (the JAX package's distance: the
    serial chain under ``optimize("fast-math")``);
  * ``build``: ``--n`` rows through ``DenseHnswIndexer.index_data`` and
    its time;
  * ``exact``: the ground truth, the port's fp32 ``FlatIPIndex`` on the
    card (top 10 of 512 queries);
  * ``search`` for each ef in 16/32/64/128/256: single-thread qps over the
    512 queries and recall@10 against the ground truth.

    python -m ance_tpu_torch.experiments.perf_hnsw --device cuda
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

D, Q, K = 768, 512, 10
EFS = (16, 32, 64, 128, 256)
AB_TURNS = 3
# rows whose build takes about 5 minutes on one H100 machine's host: the
# insert rate falls as the graph grows (~570/s at 2,000 unit rows, 94/s
# over a whole 80,000-row build, which took 854 s)
N_DEFAULT = 40_000
PORT_DIST = """    float dist(const float* a, const float* b) const {
        float s[LANES] = {};
        int i = 0;
        for (; i + LANES <= dim; i += LANES)
            for (int j = 0; j < LANES; ++j) {
                float d = a[i + j] - b[i + j];
                s[j] += d * d;
            }
        for (int j = 0; i < dim; ++i, ++j) {
            float d = a[i] - b[i];
            s[j] += d * d;
        }
        for (int w = LANES / 2; w > 0; w /= 2)
            for (int j = 0; j < w; ++j) s[j] += s[j + w];
        return s[0];
    }
"""
SERIAL_DIST = """    float dist(const float* a, const float* b) const {
        float s = 0.f;
        for (int i = 0; i < dim; ++i) {
            float d = a[i] - b[i];
            s += d * d;
        }
        return s;
    }
"""
VARIANTS = {"lanes": PORT_DIST, "serial": SERIAL_DIST,
            "reassociating": '    __attribute__((optimize("fast-math")))\n'
                             + SERIAL_DIST}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def host_cpu() -> dict:
    """``lscpu``'s model name and CPU count, and ``/proc/cpuinfo``'s model
    name and vector extensions (lscpu can print "unknown" in a VM)."""
    fields = {}
    for line in subprocess.run(["lscpu"], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        key, _, value = line.partition(":")
        fields[key.strip()] = value.strip()
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    flags = set(info.get("flags", "").split())
    return {"model": fields.get("Model name"), "cpus": fields.get("CPU(s)"),
            "cpuinfo_model": info.get("model name"),
            "vector": sorted(f for f in ("sse4_2", "avx", "avx2", "fma",
                                         "avx512f") if f in flags)}


def card(device) -> str | None:
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def variant_libraries(build_dir: Path) -> dict:
    """``VARIANTS``' builds of the port's core, with the package's flags."""
    import ctypes
    from ance_tpu_torch.utils import native_build
    source = (native_build.NATIVE_DIR / "hnsw.cpp").read_text()
    if PORT_DIST not in source:
        raise RuntimeError("native/hnsw.cpp's distance is not PORT_DIST")
    libs = {}
    for name, dist in VARIANTS.items():
        src = build_dir / f"hnsw_{name}.cpp"
        src.write_text(source.replace(PORT_DIST, dist))
        native_build.build(src, build_dir / f"libhnsw_{name}.so")
        libs[name] = ctypes.CDLL(str(build_dir / f"libhnsw_{name}.so"))
    return libs


def unit_rows(rs, n: int) -> np.ndarray:
    x = rs.randn(n, D).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def make_data(kind: str, rs, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(corpus [n, D], queries [Q, D]) fp32 of ``--data kind``."""
    if kind == "unit":
        return unit_rows(rs, n), unit_rows(rs, Q)
    centres = unit_rows(rs, max(16, n // 256))
    corpus = centres[rs.randint(0, len(centres), n)] \
        + (0.5 / D ** 0.5) * rs.randn(n, D).astype(np.float32)
    queries = corpus[rs.choice(n, Q, replace=False)] \
        + (0.3 / D ** 0.5) * rs.randn(Q, D).astype(np.float32)
    return corpus, queries


def build_rate(vecs: np.ndarray, lib=None) -> float:
    """Inserts/s of one ``DenseHnswIndexer`` build over ``vecs``."""
    from ance_tpu_torch.index.hnsw import DenseHnswIndexer, HnswIndex
    ix = DenseHnswIndexer(D)
    if lib is not None:
        ix.index = HnswIndex(D + 1, m=32, ef_construction=200, lib=lib)
        ix.index.set_ef(128)
    t0 = time.perf_counter()
    ix.index_data(np.arange(len(vecs)), vecs)
    return len(vecs) / (time.perf_counter() - t0)


def main(argv=None) -> None:
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.index.hnsw import DenseHnswIndexer
    from ance_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default="unit", choices=["unit", "clustered"])
    ap.add_argument("--n", type=int, default=N_DEFAULT, help="corpus rows")
    ap.add_argument("--ab-rows", type=int, default=2000,
                    help="rows of the distance A/B (0: skip it)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    emit(host=host_cpu(), card=card(device), data=args.data)

    rs = np.random.RandomState(0)
    if args.ab_rows:
        ab = unit_rows(rs, args.ab_rows)
        with tempfile.TemporaryDirectory() as tmp:
            libs = variant_libraries(Path(tmp))
            rates = {name: [] for name in libs}
            for _ in range(AB_TURNS):  # in turns
                for name, lib in libs.items():
                    rates[name].append(build_rate(ab, lib))
        emit(stage="distance_ab", rows=args.ab_rows, dim=D + 1,
             inserts_per_s={name: statistics.median(r)
                            for name, r in rates.items()}, runs=rates)

    n = args.n
    corpus, queries = make_data(args.data, rs, n)
    exact = FlatIPIndex(dim=D, device=device)
    exact.add(corpus)
    t0 = time.perf_counter()
    _, gt = exact.search(queries, K)
    gt = gt.cpu().numpy()
    emit(stage="exact", index="FlatIPIndex fp32", device=str(device),
         seconds=time.perf_counter() - t0)

    indexer = DenseHnswIndexer(D)
    t0 = time.perf_counter()
    indexer.index_data(np.arange(n), corpus)
    build_s = time.perf_counter() - t0
    emit(stage="build", n=n, build_s=build_s, inserts_per_s=n / build_s)
    for ef in EFS:
        indexer.index.set_ef(max(ef, K))
        t0 = time.perf_counter()
        results = indexer.search_knn(queries, K)
        qps = Q / (time.perf_counter() - t0)
        hits = sum(len(set(ids) & set(row.tolist()))
                   for (ids, _), row in zip(results, gt))
        emit(stage="search", ef=ef, qps=qps, recall_at_10=hits / (Q * K))
    emit(done=True)


if __name__ == "__main__":
    main()
