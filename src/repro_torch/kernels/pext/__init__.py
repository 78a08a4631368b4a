from .ops import pext, pext_plain  # noqa: F401
