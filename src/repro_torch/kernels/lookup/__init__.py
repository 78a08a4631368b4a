from .ops import leaf_match_fn, probe, probe_plain  # noqa: F401
