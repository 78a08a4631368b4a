"""PyTorch + CUDA port of the compressed key sort and fast index
reconstruction system (reference: the JAX package ``repro``).

Layout mirrors the reference: ``core`` (key algebra, tree, pipeline, the
online index ``OnlineIndex``), ``backends`` (``"torch"`` plain oracle,
``"cuda"`` hand-written kernels), ``kernels/<name>`` (kernel wrapper +
plain version + numpy oracle), ``csrc`` (the CUDA sources),
``replication`` (the change log and its wire framing), ``serve``
(multi-tenant arenas, the fused engine and its load harness), ``data``,
``configs`` and ``convert`` (state to and from numpy).  Nothing here
imports JAX or the reference package.
"""

__all__ = ["OnlineIndex"]


def __getattr__(name):
    # resolved on first access, so importing the package loads neither
    # torch nor the pipeline (core.index imports both)
    if name == "OnlineIndex":
        from .core.index import OnlineIndex

        return OnlineIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
