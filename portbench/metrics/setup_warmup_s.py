"""Seconds of set-up spent in the sampler's warmup (the port's phase span
``warmup_s``). Moves ``setup_s``."""


def read(r):
    value = (r.get("phase_times") or {}).get("warmup_s")
    return None if value is None else float(value)
