from .chains import run_chains  # noqa: F401
