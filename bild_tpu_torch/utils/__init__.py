from .checkpoint import save_results, load_results  # noqa: F401
