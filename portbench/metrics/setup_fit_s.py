"""Seconds of set-up spent fitting before warmup (the port's own phase
spans, ``phase_times_s``): NLML, the MAP warm start, the Gauss-Newton MAP
and the whitener. Moves ``setup_s``."""

PHASES = ("nlml_s", "map_s", "gn_map_s", "whitener_s")


def read(r):
    spans = r.get("phase_times") or {}
    found = [spans[k] for k in PHASES if k in spans]
    return float(sum(found)) if found else None
