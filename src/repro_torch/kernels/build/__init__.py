from .ops import gather_windows, gather_windows_plain, pk_windows, pk_windows_plain  # noqa: F401
