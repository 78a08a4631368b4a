from .ops import (  # noqa: F401
    leaf_stage,
    leaf_stage_many,
    leaf_stage_many_plain,
    probe,
    probe_many,
    probe_many_plain,
    probe_plain,
)
