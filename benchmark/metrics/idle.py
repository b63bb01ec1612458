"""The device's idle share in the traced slice: 1 - the union of its
kernel, copy and set intervals over the slice's length. One reader for
every cell's ``idle.<part>``."""


def read(obs):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
