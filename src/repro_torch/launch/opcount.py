"""Per-device op counts of a sharded step: matmul FLOPs and collective bytes.

The JAX package reads these from the partitioned program's text: it
parses every computation, recovers each loop's trip count and multiplies
the counts of the loop bodies through.  PyTorch runs the step eagerly, so
the port counts the ops as they run, on one rank's view of the mesh:

  * ``dot_flops`` — matmul FLOPs (``mm``, ``bmm``, ``addmm``, ... as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them; an
    ``einsum`` reaches it as ``bmm``) of the rank's local blocks, so a
    replicated product counts whole on every rank, as a partitioned
    program's would;
  * ``collective_bytes`` / ``collective_counts`` — the result bytes and
    the number of each kind of collective that DTensor issues
    (all-gather, all-reduce, reduce-scatter, all-to-all, broadcast),
    counted by a ``CommDebugMode``; on-wire ring factors are applied in
    the roofline stage, not here.

:class:`OpCounter` counts whatever runs inside it.  The dry run
(``launch/dryrun.py``) traces ONE microbatch's forward and backward and
the optimizer update once, and :func:`scale_step` multiplies the
microbatch's counts by ``accum``, as the JAX package multiplies a scan's
body by its trip count.  Elementwise FLOPs are excluded (MFU-style
accounting), as there.

The counter must be entered inside any ``FakeTensorMode`` and outside
the code that makes DTensors: its collective mode sits on top of the
mode stack and hands DTensor ops to DTensor, so the FLOP counter below
it sees only the local ops.  DTensor works out each new op's output
shape by running it once on fake tensors of the *global* shape; those
runs are no rank's work, and :func:`unobserved_meta_propagation` (which
the counter enters) hides them from every mode on the stack.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["OpCounter", "scale_step", "unobserved_meta_propagation", "COLLECTIVES"]

#: collective kinds, in the JAX package's names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")

_fn = torch.ops._c10d_functional
#: the functional collectives DTensor issues, by kind
_KIND = {
    _fn.all_gather_into_tensor: "all-gather",
    _fn.all_gather_into_tensor_coalesced: "all-gather",
    _fn.all_reduce: "all-reduce",
    _fn.all_reduce_coalesced: "all-reduce",
    _fn.reduce_scatter_tensor: "reduce-scatter",
    _fn.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _fn.all_to_all_single: "all-to-all",
    _fn.broadcast: "broadcast",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class _CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)
        self.counts = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = None if out is NotImplemented else _KIND.get(getattr(func, "_overloadpacket", None))
        if kind is not None:
            self.counts[kind] += 1
            self.bytes[kind] += _nbytes(out)
        return out


@contextlib.contextmanager
def unobserved_meta_propagation():
    """Run DTensor's global-shape metadata propagation with every dispatch
    mode (counters, memory trackers, the caller's fake mode) set aside: it
    makes its own fake tensors."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class OpCounter:
    """Counts the matmul FLOPs and the collectives of the ops run inside
    it, on this rank's view (see the module docstring)."""

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(unobserved_meta_propagation())
        self._flops = self._stack.enter_context(FlopCounterMode(display=False))
        self._comm = self._stack.enter_context(_CollectiveBytes())
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def summary(self) -> dict:
        return {
            "dot_flops": float(self._flops.get_total_flops()),
            "collective_bytes": {k: int(self._comm.bytes.get(k, 0)) for k in COLLECTIVES},
            "collective_counts": {k: int(self._comm.counts.get(k, 0)) for k in COLLECTIVES},
        }


def scale_step(micro: dict, update: dict, accum: int) -> dict:
    """A whole step's counts: ``accum`` times one microbatch's forward and
    backward (``micro``), plus the optimizer update once (``update``)."""
    return {
        "dot_flops": accum * micro["dot_flops"] + update["dot_flops"],
        "collective_bytes": {k: accum * micro["collective_bytes"][k] + update["collective_bytes"][k]
                             for k in COLLECTIVES},
        "collective_counts": {k: accum * micro["collective_counts"][k]
                              + update["collective_counts"][k] for k in COLLECTIVES},
    }
