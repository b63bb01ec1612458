"""The attention's share of its roofline: the attention's FLOPs and bytes
counted from the real tokens and keys (``flops.attention_work``), bound
by the bf16 peak or HBM, over the device time of the kernels launched
inside the attention calls of the traced slice, whatever they are."""

from benchmark.flops import roofline_pct

RANGE = "bench.attention"


def read(obs):
    tr, work = obs.get("trace"), obs.get("range_work", {}).get(RANGE)
    if not tr or not work or not tr["range_device_s"].get(RANGE):
        return None
    return roofline_pct(work[0], work[1], tr["range_device_s"][RANGE])
