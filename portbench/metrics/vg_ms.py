"""Device milliseconds per value-and-grad as the tree calls it, at the
cell's batch and the window's last positions, from a replayed CUDA graph
of many calls (CUDA events). Moves ``draws_per_s``."""


def read(r):
    return r.get("vg_ms")
