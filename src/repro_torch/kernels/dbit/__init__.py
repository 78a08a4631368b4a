from .ops import adjacent_dbits, adjacent_dbits_plain  # noqa: F401
