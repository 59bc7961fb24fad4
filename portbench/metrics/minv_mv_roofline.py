"""The dense metric's product M^-1 g (``ops/minv_mv``) alone at the cell's
(chains, dim): its least time over its device time from a replayed CUDA
graph of many launches, in %. Its count: 2 C dim^2 operations; M^-1 and g
read once, the product written. Moves ``draws_per_s``."""

from portbench.core import work


def read(r):
    ms = (r.get("kernel_ms") or {}).get("minv_mv")
    if not ms:
        return None
    s = r["shapes"]
    return 100.0 * work.least_s(*work.dense_product(s["c"], s["dim"])) / (1e-3 * ms)
