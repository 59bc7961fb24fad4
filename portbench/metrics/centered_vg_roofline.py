"""The whitened FN value-and-grad's kernel (``ops/centered_vg``) alone at
the cell's shapes and on the window's last positions: its least time over
its device time from a replayed CUDA graph of many launches, in %. Its
count: one launch reads dpsi (C, dim), six band storages (2b+1, n) and
five (n,) fields per state dimension, writes g_psi and lp, and does six
banded products of every output row. Moves ``draws_per_s``."""

from portbench.core import work


def read(r):
    ms = (r.get("kernel_ms") or {}).get("centered_vg")
    if not ms:
        return None
    s = r["shapes"]
    return 100.0 * work.least_s(*work.centered_vg(s["c"], s["n"], s["b"], s["dim"], s["d"])) \
        / (1e-3 * ms)
