from .profiling import annotate, call_stats  # noqa: F401
