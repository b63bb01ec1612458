"""Host ms of the shuffles of ``train/ann_gen.py::mine_negatives``, a
chunk: the program's span ``ann_gen.shuffle`` (every block's first pass,
recorded only while the profiler runs, so over the traced slice) over the
calls of ``ann_gen.mine_negatives`` there."""


def read(obs):
    try:
        from ance_tpu_torch.utils.observability import span_totals
    except ImportError:  # a port without spans
        return None
    totals = span_totals()
    shuffle = totals.get("ann_gen.shuffle")
    mine = totals.get("ann_gen.mine_negatives")
    if not shuffle or not mine:
        return None
    return 1e3 * shuffle["host_s"] / mine["calls"]
