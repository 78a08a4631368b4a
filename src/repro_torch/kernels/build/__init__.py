from .ops import pk_windows, pk_windows_plain  # noqa: F401
