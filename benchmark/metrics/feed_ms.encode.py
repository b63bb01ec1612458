"""Host feed of the encode: ms a batch in ``TokenCache.batch``, as
``train/encode.py::iter_cache_batches`` calls it, over every batch of the
window (a probe the driver passes in as the cache)."""


def read(obs):
    ms = obs.get("spans", {}).get("feed")
    return sum(ms) / len(ms) if ms else None
