"""GB/s of the engine's loads in the window: the bytes of the host images
loaded divided by the seconds ``engine.load`` returned (it synchronises),
over every load that was not an endpoint's first (layer: engine load)."""


def read(run):
    loads = [ld for ld in run.loads if not ld["first"]]
    seconds = sum(ld["seconds"] for ld in loads)
    if not loads or seconds <= 0:
        return None
    return sum(ld["bytes"] for ld in loads) / seconds / 1e9
