"""Device ms of one ``FlatIPIndex.search`` of a 4,096-query chunk at
k = 200: CUDA events around each call of the window, total over count."""


def read(obs):
    ms = obs.get("spans", {}).get("search")
    return sum(ms) / len(ms) if ms else None
