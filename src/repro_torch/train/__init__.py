from . import compression, optim, trainstep  # noqa: F401
