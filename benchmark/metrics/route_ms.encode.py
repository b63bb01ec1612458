"""Device ms a batch in the MoE layers' routing: the router, its top-k,
the pairs' sort and offsets, and the combine. The program's span
``encoder.moe.route`` (twice a MoE layer: before and after the experts),
timed by CUDA events on the encode's stream and recorded only while the
profiler runs (so over the traced slice), over the calls of
``encoder.embeddings`` there (one a batch)."""


def read(obs):
    try:
        from ance_tpu_torch.utils.observability import span_totals
    except ImportError:  # a port without spans
        return None
    totals = span_totals()
    route, batches = totals.get("encoder.moe.route"), \
        totals.get("encoder.embeddings")
    if not route or not batches or route["device_ms"] is None:
        return None
    return route["device_ms"] / batches["calls"]
