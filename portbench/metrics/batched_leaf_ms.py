"""Host milliseconds per batched leaf in the sampling window alone: the
window's wall time over its batched leaves. Moves ``draws_per_s``."""


def read(r):
    if not r.get("leaves"):
        return None
    return 1e3 * r["wall_s"] / r["leaves"]
