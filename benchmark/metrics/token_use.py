"""The share of the encoder's token slots that hold real tokens, over
every batch of the run: the program's counters on
``train/encode.py::iter_cache_batches`` (``real_tokens``: the real
records' lengths capped at the width; ``token_slots``: every row encoded,
the padding rows of a last batch too, times the width). One reader for
every cell's ``token_use.<part>``."""


def read(obs):
    try:
        from ance_tpu_torch.train.encode import iter_cache_batches
    except ImportError:
        return None
    slots = getattr(iter_cache_batches, "token_slots", 0)
    if not slots:  # nothing encoded, or a port without the counters
        return None
    return 100.0 * iter_cache_batches.real_tokens / slots
