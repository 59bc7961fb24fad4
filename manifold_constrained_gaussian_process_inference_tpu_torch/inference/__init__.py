from .solve import MagiError, MagiResult, solve_magi  # noqa: F401
from .target import MagiTarget  # noqa: F401
