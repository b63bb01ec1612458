"""Device ms a search in phase 2 of the search, the choice of candidate
blocks: the padded blocks' mask and
``ops/topk.py::top_blocks_lower_id_first``. The program's span
``topk.phase2``, timed by CUDA events on the search's stream and recorded
only while the profiler runs (so over the traced slice), over the calls of
``index.search`` there."""

PHASE = "topk.phase2"


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
