"""Host ms of ``train/ann_gen.py::mine_negatives`` over one chunk's
queries, total over count."""


def read(obs):
    ms = obs.get("spans", {}).get("mine_host")
    return sum(ms) / len(ms) if ms else None
