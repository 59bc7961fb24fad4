from .diagnostics import ess, format_summary, split_rhat, summarize_chains  # noqa: F401
from .summary import magi_summary, results_to_chain  # noqa: F401
from .plotting import plot_magi  # noqa: F401
