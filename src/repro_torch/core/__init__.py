# The paper's primary contribution — compressed key sort + fast index
# reconstruction — in PyTorch: key formats, distinction bits, extraction
# plans, DS-metadata, the partial-key B+tree, the pipeline and the online
# index.  Modules are imported where they are used (the pipeline imports
# the backends, which import these modules back), so ``OnlineIndex`` is
# resolved on first access.  ``distsort`` (the sample sort over a process
# group) imports none of them at import time, so it is exported directly.

from . import distsort  # noqa: F401

__all__ = ["OnlineIndex", "distsort"]


def __getattr__(name):
    if name == "OnlineIndex":
        from .index import OnlineIndex

        return OnlineIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
