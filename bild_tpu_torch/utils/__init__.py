from .checkpoint import save_results, load_results  # noqa: F401
from .profiling import trace, span, spanned, snapshot, strict_numerics  # noqa: F401
