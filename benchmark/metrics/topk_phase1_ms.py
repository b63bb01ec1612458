"""Device ms a search in phase 1 of the search, the block maxima: the
query cast (or split into bf16 pieces) and ``ops/topk.py::blockmax_scores``
(kernel #1). The program's span ``topk.phase1``, timed by CUDA events on
the search's stream and recorded only while the profiler runs (so over the
traced slice), over the calls of ``index.search`` there."""

PHASE = "topk.phase1"


def read(obs):
    try:
        from ance_tpu_torch.utils.observability import span_totals
    except ImportError:  # a port without spans
        return None
    totals = span_totals()
    phase, search = totals.get(PHASE), totals.get("index.search")
    if not phase or not search or phase["device_ms"] is None:
        return None
    return phase["device_ms"] / search["calls"]
