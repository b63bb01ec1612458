"""The whole step's share of the chip's bf16 peak: the model FLOPs the
driver counted over the window's real work (``benchmark/flops.py``: the
encoder's and head's over real tokens, plus 2·Q·N·D for a search), over
the window. One reader for every cell's
``mfu.<part>``."""

from benchmark.flops import mfu_pct


def read(obs):
    if "model_flops" not in obs:
        return None
    return mfu_pct(obs["model_flops"], obs["window_s"])
