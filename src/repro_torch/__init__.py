"""PyTorch + CUDA port of the compressed key sort and fast index
reconstruction system (reference: the JAX package ``repro``).

Layout mirrors the reference: ``core`` (key algebra, tree, pipeline),
``backends`` (``"torch"`` plain oracle, ``"cuda"`` hand-written kernels),
``kernels/<name>`` (kernel wrapper + plain version + numpy oracle),
``csrc`` (the CUDA sources), ``serve`` (multi-tenant arenas, the fused
engine and its load harness), ``data``, ``configs`` and ``convert``
(state to and from numpy).  Nothing here imports JAX or the reference package.
"""
