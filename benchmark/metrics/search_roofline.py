"""The exact search's share of its roofline: 2·Q·N·D operations and the
corpus, queries and [Q, k] results in bytes, bound by the bf16 peak or
HBM (an fp32-exact product cannot beat the bf16 peak), over the device
time of the kernels launched inside the search calls of the traced slice."""

from benchmark.flops import roofline_pct

RANGE = "bench.search"


def read(obs):
    tr, work = obs.get("trace"), obs.get("range_work", {}).get(RANGE)
    if not tr or not work or not tr["range_device_s"].get(RANGE):
        return None
    return roofline_pct(work[0], work[1], tr["range_device_s"][RANGE])
