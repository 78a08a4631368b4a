from .ops import DEFAULT_BLOCK, block_sort, block_sort_plain  # noqa: F401
