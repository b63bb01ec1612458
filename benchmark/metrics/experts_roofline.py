"""The MoE experts' share of their roofline: the routed and shared
experts' FLOPs (k routed SwiGLUs and the shared one a real token a MoE
layer) and bytes (every expert's bf16 weights read once a layer a batch,
the real tokens' permuted activations in and out;
``flops_moe.experts_work``), bound by the bf16 peak or HBM, over the
device time of the kernels launched inside the program's
``encoder.moe.experts`` spans in the traced slice, whatever they are."""

from benchmark.flops import roofline_pct

RANGE = "encoder.moe.experts"


def read(obs):
    tr, work = obs.get("trace"), obs.get("range_work", {}).get(RANGE)
    if not tr or not work or not tr["range_device_s"].get(RANGE):
        return None
    return roofline_pct(work[0], work[1], tr["range_device_s"][RANGE])
