"""Share of the window in which the device ran none of the tree's graphs,
in %: one less the summed CUDA-event spans of every graph replay over the
window's wall time. Moves ``draws_per_s``."""


def read(r):
    if not r.get("busy_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
