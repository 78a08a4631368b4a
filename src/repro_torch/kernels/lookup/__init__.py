from .ops import (  # noqa: F401
    leaf_match_fn,
    leaf_match_many_fn,
    probe,
    probe_many,
    probe_many_plain,
    probe_plain,
)
