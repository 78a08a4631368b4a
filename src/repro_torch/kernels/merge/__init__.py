from .ops import merge_ranks, merge_ranks_plain, merge_sorted  # noqa: F401
