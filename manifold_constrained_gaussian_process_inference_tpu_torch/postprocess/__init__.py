from .diagnostics import ess, split_rhat  # noqa: F401
