"""Shape buckets, the program cache and its counters for the hot path.

Inputs are padded up to **bucket boundaries** (powers of two with a per-op
floor) and every stage runs as a **program** cached in a :class:`PlanCache`
under the reference's key, ``(op, backend, bucket(s), n_words, cfg…)``
less its donate flag, with the dynamic part of the shape travelling as
data: a valid count ``n_valid``.  A load whose sizes drift within a bucket
replays one program; crossing a bucket boundary, or a new tree shape,
costs one new trace.

**What a program and a trace are here.**

* A *program* is the callable that ``PlanCache.program(key, builder)``
  caches.  The keys are the reference's: ``sort``, ``merge``, ``fused``,
  ``refresh_dpos``, ``build_leaf``, ``build_level``, ``lookup``,
  ``lookup_many`` (with ``tree_geometry``) and ``run_many``.  The
  bitmap-form refresh the pipeline runs, :func:`adjacent_dbitmap_padded`,
  has a key of its own, ``refresh_dbitmap``.
* A *trace* is the first run of a program at an input signature it has
  not seen: the shapes, dtypes and device of its tensor operands (a tree
  operand's are its arrays', with its ``n_keys`` and config).  That is
  when the reference traces and compiles a program, so ``traces`` counts
  the same events as the reference.  Python ints among the operands (the valid counts) are
  data, not signature.  On the CPU the trace is the body's first eager
  run.  On CUDA the trace of a lookup program is its graph capture.
* A *warm call* adds a hit and no trace, whatever the device.

**Which programs are CUDA graphs.**  Fixed here, never chosen at run
time: on a CUDA device the ``lookup`` and ``lookup_many`` programs are
CUDA graphs (:meth:`PlanCache.graphed`); every other program
(:meth:`PlanCache.traced`: the sort, merge, fused, refresh, build and
``run_many`` bodies) runs its body eagerly and counts its traces.  The
lookup path reads nothing back to the host, and it is where eager
dispatch costs the most; capturing a reconstruction body would hold a
private pool the size of its intermediates for every bucket.

**The lookup graphs.**  One graph per program, captured over static
input buffers: the query block at the bucket shape, the valid counts (a
device scalar, or a ``(t_cap,)`` vector for ``lookup_many``) and one
tensor per tree array.  A warm call, under the program's lock and on the
program's stream, copies the tree in when it is not the one the buffers
hold, copies the queries and counts in, replays the graph and clones the
outputs; the copy to the host is the caller's, outside the lock.  Tree
identity goes by a ``weakref`` to the tree (or stacked arena) object,
never by ``data_ptr()``: the caching allocator reuses freed addresses,
so a new epoch can land where the old one was.  A new epoch at the same
geometry is therefore a copy (``tree_copies``), not a trace, as the
reference replays its compiled program on the new tree; a new tree shape
is a new signature and captures again.  A program keeps only its newest
signature's graph: a replaced, evicted or reset graph frees its pool and
buffers.  Before each capture the body runs once eagerly (the trace,
which also loads the kernel library).  The capture runs on the program's
own stream with ``capture_error_mode="thread_local"``, which keeps
another thread's kernel launches and allocations from breaking it; what
would still break it is a device-wide synchronize in any thread, since
that waits on the capturing stream.  So the port has none: every wait
for the card (here, the pipeline's timed stages, the distributed sort,
the chunk tuner) is ``u32.sync_stream``, a wait for the calling
thread's own stream, and the capture is begun with ``capture_begin``
rather than ``torch.cuda.graph``, whose entry synchronizes the device.
The one device-wide call left, the release of the allocator's cached
blocks that makes room for a graph's private pool, runs under a
process-wide capture lock that every capture holds, so it never meets
another thread's capture.  Threads may therefore replay and rebuild
beside a capture, and capture one at a time.  A
capture that fails raises; no path falls back to the eager body.  A replay launches kernels that Python never calls,
so each graph records the launches its capture made
(``cudalib.recording``) and adds them to the launch counts on every
replay.

Padding and normalization keep byte identity:

* **sort / merge / fused extract+sort** — pad lanes are rewritten to the
  all-ones sentinel key with row ids from a reserved range (``>= 2**31``,
  ``ROW_PAD_A`` for run a, ``ROW_PAD_B`` for run b), so under the (key,
  row) contract they sort strictly after every real pair, whatever they
  held; ``keep_padded`` returns the bucket-shaped run so the pipeline
  chains it into the next stage;
* **build / refresh / lookup** — pads are inert: every body reads only
  its first ``n_valid`` lanes (a lookup normalizes its pad lanes to
  all-ones queries and the caller slices them off).

Counters: ``hits``/``misses`` count cache lookups, ``traces`` first runs
at a new signature, ``evictions`` LRU victims, ``per_op`` the same by op
family.  ``PlanCache(max_programs=N)`` evicts the least-recently-used
program past the bound; ``auto_size=True`` doubles the bound (up to
``auto_size_cap``) when a window of lookups shows a low hit rate while
evictions occur.  One ``threading.RLock`` guards every counter.
:func:`tune_chunking` measures inside :func:`scoped_cache`, so its probe
programs never enter the serving cache.  The reference's
``donation_supported`` has no counterpart: the port has no ``donate``
flag, because eager PyTorch writes no operand in place.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from .u32 import MASK32, resolve_device, sync_stream, to_carrier, to_u32

__all__ = [
    "BUCKET_MIN",
    "SENTINEL",
    "ROW_PAD_A",
    "ROW_PAD_B",
    "bucket",
    "bucket_for",
    "set_bucket_floor",
    "get_bucket_floor",
    "PlanCache",
    "get_cache",
    "reset_cache",
    "set_max_programs",
    "cache_stats",
    "scoped_cache",
    "iota",
    "pad_tail",
    "pad_run",
    "sort_padded",
    "merge_padded",
    "fused_extract_sort_padded",
    "adjacent_dpos_padded",
    "adjacent_dbitmap_padded",
    "ChunkPlan",
    "tune_chunking",
]

#: default bucket floor — tiny inputs share one program
BUCKET_MIN = 256

#: sentinel key word for pad rows (sorts last; ties break on the row id)
SENTINEL = 0xFFFFFFFF

#: pad row-id bases: above any real row position (rows are in [0, n) with
#: n < 2**31) and distinct between the two runs of a merge
ROW_PAD_A = 0x80000000
ROW_PAD_B = 0xC0000000


def bucket(n: int, minimum: int = BUCKET_MIN) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()


#: per-op bucket floors (op -> floor); ops not listed use ``BUCKET_MIN``
_FLOORS: dict[str, int] = {}


def set_bucket_floor(op: str, floor: int | None) -> None:
    """Override the bucket floor for one op family (``None`` restores the
    ``BUCKET_MIN`` default).  Lowering a floor after programs were traced
    at the old floor costs one trace per newly reachable bucket."""
    if floor is None:
        _FLOORS.pop(op, None)
        return
    if int(floor) < 1:
        raise ValueError(f"bucket floor must be >= 1, got {floor}")
    _FLOORS[op] = int(floor)


def get_bucket_floor(op: str) -> int:
    """The effective bucket floor for ``op``."""
    return _FLOORS.get(op, BUCKET_MIN)


def bucket_for(op: str, n: int) -> int:
    """Bucket of ``n`` under ``op``'s floor (see :func:`set_bucket_floor`)."""
    return bucket(n, get_bucket_floor(op))


# ---------------------------------------------------------------------------
# input signatures
# ---------------------------------------------------------------------------

def _is_tree(x) -> bool:
    return hasattr(x, "levels") and hasattr(x, "leaf") and hasattr(x, "sorted_full")


def _tree_tensors(tree) -> list[torch.Tensor]:
    """A tree's arrays in a fixed order: each level's and the leaf's by
    key, then the sorted full keys and rids."""
    out = [level[k] for level in tree.levels for k in sorted(level)]
    out += [tree.leaf[k] for k in sorted(tree.leaf)]
    return out + [tree.sorted_full, tree.sorted_rids]


def _signature(x):
    """The part of an operand a trace depends on: a tensor's shape, dtype
    and device, a tree's arrays' with its ``n_keys`` and config, a
    sequence's items'; a plain number is data and counts only by type."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if _is_tree(x):
        return ("tree", tuple(_signature(t) for t in _tree_tensors(x)),
                int(x.n_keys), x.config)
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    if x is None:
        return None
    if isinstance(x, (bool, int, float, np.integer, np.floating)):
        return type(x).__name__
    return x


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@dataclass
class PlanCache:
    """Cached programs + hit/miss/trace/eviction counters.

    ``max_programs`` (optional) bounds the cache: past the bound the
    least-recently-used program is evicted (``programs`` is kept in
    recency order — a hit re-inserts its key at the end), and an evicted
    lookup graph frees its pool and buffers.

    ``auto_size=True`` turns on hit-rate-driven growth of the bound:
    whenever a window of ``auto_size_window`` lookups closes with a hit
    rate below ``auto_size_hit_rate`` *and* at least one eviction inside
    the window (the cache is thrashing, not merely cold), the bound
    doubles, capped at ``auto_size_cap``.  ``resizes`` counts the growth
    events (not part of :meth:`stats`).

    Thread-safe: lookups, inserts, LRU maintenance and every counter run
    under one re-entrant mutex, so serving threads replaying warm
    programs beside a rebuilding writer see exact counts, and a racing
    cold miss builds each program once (both racers get the same
    callable).  A program's first run happens outside the mutex.
    """

    programs: dict = field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    traces: int = 0
    evictions: int = 0
    #: per-op-family counters keyed by the op name (``key[0]`` of every
    #: program key): op -> {"hits", "misses", "traces"}
    per_op: dict = field(default_factory=dict)
    _building_op: str | None = field(default=None, repr=False)
    max_programs: int | None = None
    auto_size: bool = False
    auto_size_cap: int = 4096
    auto_size_window: int = 64
    auto_size_hit_rate: float = 0.5
    resizes: int = 0
    #: lookup graphs: captures, replays and tree copies (same-geometry
    #: epochs copied into a graph's buffers), not part of :meth:`stats`
    captures: int = 0
    replays: int = 0
    tree_copies: int = 0
    _win_lookups: int = 0
    _win_hits: int = 0
    _win_evictions: int = 0
    _lock: threading.RLock = field(default_factory=threading.RLock, repr=False)

    def __post_init__(self) -> None:
        if self.max_programs is not None and int(self.max_programs) < 1:
            raise ValueError(
                f"max_programs must be >= 1 or None, got {self.max_programs}"
            )

    def program(self, key: tuple, builder: Callable[[], Callable]) -> Callable:
        """The program for ``key``, building it on first use.

        Atomic under the cache mutex: concurrent lookups of the same cold
        key build it once and share the callable (``builder`` is cheap —
        it wraps, it does not run).  LRU victims free their graphs after
        the mutex is dropped."""
        victims = []
        with self._lock:
            self._win_lookups += 1
            op_stats = self._per_op(key)
            prog = self.programs.get(key)
            if prog is not None:
                self.hits += 1
                self._win_hits += 1
                op_stats["hits"] += 1
                if self.max_programs is not None:
                    # refresh recency: dicts iterate in insertion order, so
                    # re-inserting makes the oldest entry the LRU victim
                    del self.programs[key]
                    self.programs[key] = prog
                self._maybe_grow()
                return prog
            self.misses += 1
            op_stats["misses"] += 1
            # builders wrap synchronously under the lock, so any traced or
            # graphed body they make counts its traces under this op
            prev_op, self._building_op = self._building_op, self._op_of(key)
            try:
                prog = builder()
            finally:
                self._building_op = prev_op
            self.programs[key] = prog
            if self.max_programs is not None:
                while len(self.programs) > int(self.max_programs):
                    victim = next(iter(self.programs))
                    victims.append(self.programs.pop(victim))
                    self.evictions += 1
                    self._win_evictions += 1
            self._maybe_grow()
        _release_all(victims)
        return prog

    def _maybe_grow(self) -> None:
        """Close an auto-size window and grow the bound on thrash."""
        if not self.auto_size or self.max_programs is None:
            return
        if self._win_lookups < int(self.auto_size_window):
            return
        hit_rate = self._win_hits / max(self._win_lookups, 1)
        if self._win_evictions > 0 and hit_rate < float(self.auto_size_hit_rate):
            grown = min(int(self.max_programs) * 2, int(self.auto_size_cap))
            if grown > int(self.max_programs):
                self.max_programs = grown
                self.resizes += 1
        self._win_lookups = self._win_hits = self._win_evictions = 0

    @staticmethod
    def _op_of(key: tuple) -> str:
        """The op-family name of a program key (``key[0]`` by convention)."""
        return str(key[0]) if isinstance(key, tuple) and key else str(key)

    def _per_op(self, key_or_op) -> dict:
        """The per-op counter dict for a key/op (created on first touch);
        caller holds the lock."""
        op = key_or_op if isinstance(key_or_op, str) else self._op_of(key_or_op)
        entry = self.per_op.get(op)
        if entry is None:
            entry = self.per_op[op] = {"hits": 0, "misses": 0, "traces": 0}
        return entry

    def _count_trace(self, op: str) -> None:
        with self._lock:
            self.traces += 1
            self._per_op(op)["traces"] += 1

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def traced(self, fn: Callable) -> Callable:
        """``fn`` as a program that counts its traces: the first call at
        each input signature (see :func:`_signature`) adds one to
        ``traces``, every call runs ``fn`` eagerly.  Called from inside a
        :meth:`program` builder, the traces are attributed to that
        program's op family in :attr:`per_op` (``"_unkeyed"`` otherwise).
        """
        return _Traced(self, self._building_op or "_unkeyed", fn)

    def graphed(self, body: Callable, device=None) -> Callable:
        """A lookup program: ``body(tree, queries, n_valid)`` replayed as a
        CUDA graph on a CUDA device, run eagerly (and counted as
        :meth:`traced`) on the CPU.  ``device`` is where the program is
        meant to run: CUDA unless the caller names another, so building
        one without a GPU raises unless the CPU is named."""
        resolve_device(device)
        return _Graphed(self, self._building_op or "_unkeyed", body)

    def stats(self) -> dict[str, Any]:
        """Counter snapshot: ``programs`` (cached), ``hits``/``misses``
        (cache lookups), ``traces`` (first runs at a new signature — the
        number that must stay flat across a warm same-bucket call),
        ``evictions`` (LRU victims), the configured ``max_programs`` bound,
        and ``per_op`` — the same counters by op family."""
        with self._lock:
            return {
                "programs": len(self.programs),
                "hits": self.hits,
                "misses": self.misses,
                "traces": self.traces,
                "evictions": self.evictions,
                "max_programs": self.max_programs,
                "per_op": {op: dict(c) for op, c in self.per_op.items()},
            }

    def graph_stats(self) -> dict[str, Any]:
        """The lookup graphs: live ``graphs``, ``captures``, ``replays``,
        ``tree_copies``, and the bytes the live graphs hold: their static
        buffers and outputs (``buffer_bytes``) and their private memory
        pools (``pool_bytes``, the segments the allocator gave each pool,
        outputs included)."""
        with self._lock:
            live = [p for p in self.programs.values()
                    if isinstance(p, _Graphed) and p.captured]
            return {
                "graphs": len(live),
                "captures": self.captures,
                "replays": self.replays,
                "tree_copies": self.tree_copies,
                "buffer_bytes": sum(p.buffer_bytes for p in live),
                "pool_bytes": sum(p.pool_bytes for p in live),
            }

    def reset(self) -> None:
        """Drop every cached program (freeing the lookup graphs) and zero
        the counters; the ``max_programs`` bound and auto-size
        configuration survive."""
        with self._lock:
            progs = list(self.programs.values())
            self.programs.clear()
            self.hits = self.misses = self.traces = self.evictions = 0
            self.resizes = self.captures = self.replays = self.tree_copies = 0
            self.per_op.clear()
            self._win_lookups = self._win_hits = self._win_evictions = 0
        _release_all(progs)


def _release_all(progs) -> None:
    for p in progs:
        release = getattr(p, "release", None)
        if release is not None:
            release()


class _Traced:
    """An eagerly run program that counts a trace at each new signature."""

    def __init__(self, cache: PlanCache, op: str, body: Callable) -> None:
        self.cache, self.op, self.body = cache, op, body
        self._seen: set = set()

    def _note(self, sig) -> None:
        if sig in self._seen:
            return
        with self.cache._lock:
            if sig not in self._seen:
                self._seen.add(sig)
                self.cache._count_trace(self.op)

    def __call__(self, *args):
        self._note(_signature(args))
        return self.body(*args)


class _Graphed(_Traced):
    """A lookup program: a CUDA graph over static buffers on a CUDA
    device (see the module docstring), an eager traced body on the CPU.

    ``body(tree, queries, n_valid)`` takes the tree (or stacked arena),
    the bucket-shaped query block and the valid counts as a tensor on
    the queries' device, reads nothing back to the host and returns
    tensors.  A call passes ``n_valid`` as a host int (a scalar count)
    or a host array (one count per tenant row)."""

    def __init__(self, cache: PlanCache, op: str, body: Callable) -> None:
        super().__init__(cache, op, body)
        self._lock = threading.Lock()
        self._stream = None
        self._graph = None
        self._sig = None
        self._tree_buf = None
        self._q_buf = None
        self._nv_buf = None
        self._out = None
        self._tree_ref = None
        #: (kernel launches, launches by form) one replay makes
        self.replay_launches: tuple[dict, dict] = ({}, {})
        self.buffer_bytes = 0
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.captures = self.tree_copies = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, tree, queries: torch.Tensor, n_valid):
        if queries.device.type != "cuda":
            self._note(_signature((tree, queries)))
            nv = torch.as_tensor(np.asarray(n_valid, np.int64), device=queries.device)
            return self.body(tree, queries, nv)
        from repro_torch.kernels import cudalib

        sig = _signature((tree, queries))
        cur = torch.cuda.current_stream(queries.device)
        with self._lock:
            if sig != self._sig:
                self._capture(tree, queries, n_valid, sig)
            stream = self._stream
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                if self._tree_ref() is not tree:
                    self._copy_tree(tree)
                self._q_buf.copy_(queries)
                self._fill_counts(n_valid)
                self._graph.replay()
                outs = tuple(o.clone() for o in self._out)
            cur.wait_stream(stream)
            for o in outs:
                o.record_stream(cur)
            cudalib.count_replay(*self.replay_launches)
        self.cache._count("replays")
        return outs

    def _fill_counts(self, n_valid) -> None:
        if self._nv_buf.dim() == 0:
            self._nv_buf.fill_(int(n_valid))
        else:
            self._nv_buf.copy_(torch.from_numpy(np.asarray(n_valid, np.int64)))

    def _copy_tree(self, tree) -> None:
        """Copy ``tree``'s arrays into the graph's tree buffers (a
        same-geometry epoch: a copy, not a trace); caller holds the lock
        and is on the program's stream."""
        for dst, src in zip(_tree_tensors(self._tree_buf), _tree_tensors(tree)):
            dst.copy_(src)
        self._tree_ref = weakref.ref(tree)
        self.tree_copies += 1
        self.cache._count("tree_copies")

    def _capture(self, tree, queries: torch.Tensor, n_valid, sig) -> None:
        """The trace on CUDA: free the old graph, make static buffers
        holding this call's inputs, run the body on them once eagerly,
        then capture it into a new graph.  Caller holds the lock."""
        from repro_torch.kernels import cudalib

        self._release_locked()
        dev = queries.device
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self.cache._count_trace(self.op)
        tree_buf = _clone_tree(tree)
        q_buf = queries.clone(memory_format=torch.contiguous_format)
        nv = np.asarray(n_valid, np.int64)
        nv_buf = torch.from_numpy(nv.copy()).to(dev)
        self.body(tree_buf, q_buf, nv_buf)  # eager: the trace
        # the buffers and the trace are on this thread's stream: wait for
        # them there (never device-wide, see u32.sync_stream)
        sync_stream(dev)
        graph = torch.cuda.CUDAGraph()
        # one capture at a time in the process: under the lock no other
        # thread's capture is underway, so the allocator's cached blocks
        # can be released first (as ``torch.cuda.graph`` does), which
        # gives the graph's private pool room on a full card; released
        # during another thread's capture, they would fail it.  The capture
        # itself is capture_begin/capture_end, not ``torch.cuda.graph``,
        # whose entry also synchronizes the whole device
        with _CAPTURE_LOCK:
            torch.cuda.empty_cache()
            with cudalib.recording() as rec, torch.cuda.stream(self._stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.body(tree_buf, q_buf, nv_buf)
                finally:
                    graph.capture_end()
        self._graph, self._out = graph, tuple(out)
        self._tree_buf, self._q_buf, self._nv_buf = tree_buf, q_buf, nv_buf
        self._tree_ref = weakref.ref(tree)
        self._sig = sig
        self.replay_launches = (dict(rec["launches"]), {k: dict(v) for k, v in rec["forms"].items()})
        static = _tree_tensors(tree_buf) + [q_buf, nv_buf, *self._out]
        self.buffer_bytes = sum(t.numel() * t.element_size() for t in static)
        pool = tuple(graph.pool())
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                              if tuple(seg.get("segment_pool_id", ())) == pool)
        self.capture_s = time.perf_counter() - t0
        self.captures += 1
        self.cache._count("captures")

    def _release_locked(self) -> None:
        # outputs first: the graph's pool is freed once nothing holds it
        self._out = None
        self._graph = None
        self._tree_buf = self._q_buf = self._nv_buf = None
        self._tree_ref = None
        self._sig = None
        self.buffer_bytes = self.pool_bytes = 0

    def release(self) -> None:
        """Free the graph, its pool and its buffers (an evicted or reset
        program; the next CUDA call captures again)."""
        with self._lock:
            self._release_locked()


def _clone_tree(tree):
    """A copy of ``tree`` whose every array is a fresh contiguous tensor."""
    def c(t):
        return t.clone(memory_format=torch.contiguous_format)

    return replace(
        tree,
        levels=tuple({k: c(v) for k, v in level.items()} for level in tree.levels),
        leaf={k: c(v) for k, v in tree.leaf.items()},
        sorted_full=c(tree.sorted_full),
        sorted_rids=c(tree.sorted_rids),
    )


_GLOBAL = PlanCache()
#: held by every lookup-graph capture of the process (see ``_Graphed._capture``)
_CAPTURE_LOCK = threading.Lock()


def get_cache() -> PlanCache:
    """The process-global cache every backend shares by default."""
    return _GLOBAL


def reset_cache() -> None:
    """Reset the process-global cache (see :meth:`PlanCache.reset`): every
    program and lookup graph is dropped and the counters zeroed."""
    _GLOBAL.reset()


def set_max_programs(max_programs: int | None) -> None:
    """Bound (or unbound, with ``None``) the process-global cache.

    ``max_programs`` must be >= 1 (the hot program itself must stay
    cached) or ``None``.  Takes effect on the next
    :meth:`PlanCache.program` insert; already cached programs are evicted
    lazily as new ones land.
    """
    if max_programs is not None and int(max_programs) < 1:
        raise ValueError(
            f"max_programs must be >= 1 or None, got {max_programs}"
        )
    _GLOBAL.max_programs = None if max_programs is None else int(max_programs)


def cache_stats() -> dict[str, Any]:
    """Counter snapshot of the process-global cache (see
    :meth:`PlanCache.stats`); the zero-retrace assertions diff this."""
    return _GLOBAL.stats()


@contextmanager
def scoped_cache(cache: PlanCache | None = None):
    """Temporarily swap the process-global cache for ``cache`` (default: a
    fresh one, whose programs and graphs are freed on exit).  Calibration
    passes like :func:`tune_chunking` run inside this scope so their probe
    programs never enter the serving cache.  The swap is a process-global
    rebind: run calibration before starting serving threads, not
    concurrently with them."""
    global _GLOBAL
    fresh = cache is None
    prev, _GLOBAL = _GLOBAL, (PlanCache() if fresh else cache)
    try:
        yield _GLOBAL
    finally:
        scoped, _GLOBAL = _GLOBAL, prev
        if fresh:
            scoped.reset()


# ---------------------------------------------------------------------------
# padding helpers
# ---------------------------------------------------------------------------

def iota(n: int, device) -> torch.Tensor:
    """``arange(n)`` as int64-carrier row positions on ``device``."""
    return torch.arange(int(n), dtype=torch.int64, device=device)


def pad_tail(x: torch.Tensor, total: int, fill, dim: int = 0) -> torch.Tensor:
    """Grow ``x`` to ``total`` along ``dim`` with ``fill`` (identity when it
    is already ``total`` long)."""
    n = int(x.shape[dim])
    total = int(total)
    if n == total:
        return x
    if n > total:
        raise ValueError(f"cannot pad {n} rows down to {total}")
    shape = list(x.shape)
    shape[dim] = total - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)


def pad_run(
    keys: torch.Tensor, rows: torch.Tensor, b: int, row_base: int = ROW_PAD_A
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a (key, row) run to ``b`` rows with sentinel pairs that sort last.

    Pad lane ``i`` gets the all-ones key and row id ``row_base + i``, the
    values the pad normalization writes, so eagerly padded runs and
    counted ones are interchangeable.
    """
    n = int(keys.shape[0])
    if n >= b:
        return keys, rows
    pad_ids = row_base + iota(b, rows.device)[n:]
    return pad_tail(keys, b, SENTINEL), torch.cat([rows, pad_ids])


def _mask_run(keys, rows, n_valid: int, row_base: int):
    """Pad normalization: lanes >= n_valid become (all-ones key, reserved
    row id) pairs that sort strictly last, whatever they held before."""
    lane = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    valid = lane < n_valid
    keys = torch.where(valid[:, None], keys, torch.full_like(keys, SENTINEL))
    rows = torch.where(valid, rows, row_base + lane)
    return keys, rows


# ---------------------------------------------------------------------------
# bucketed stage programs — each takes bucket-shaped buffers plus the valid
# count as a plain int (data, not signature)
# ---------------------------------------------------------------------------

def sort_padded(
    keys: torch.Tensor,
    rows: torch.Tensor,
    *,
    backend: str = "torch",
    impl: Callable | None = None,
    extra_key: tuple = (),
    cache: PlanCache | None = None,
    n_valid: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed keyed sort: one program per (backend, bucket, W).

    ``impl(keys_pad, rows_pad) -> (keys_sorted, rows_sorted)`` is the
    backend's sort body (default: the plain keyed sort); it runs over the
    bucket shape after the pad normalization.  Configuration baked into
    ``impl`` travels in ``extra_key``.  ``n_valid`` marks the inputs as
    already bucket-shaped with ``n_valid`` real rows; without it the
    inputs are padded here.  ``keep_padded`` returns the full bucket (pads
    sorted to the tail) for callers that chain into another stage.
    """
    cache = cache or _GLOBAL
    w = int(keys.shape[1])
    if n_valid is None:
        n = int(keys.shape[0])
        b = bucket_for("sort", n)
        keys = pad_tail(keys, b, SENTINEL)
        rows = pad_tail(rows, b, 0)
    else:
        n, b = int(n_valid), int(keys.shape[0])
    if impl is None:
        from .dbits import sort_words_keyed

        impl = sort_words_keyed

    def builder():
        def prog(kp, rp, nv):
            return impl(*_mask_run(kp, rp, nv, ROW_PAD_A))

        return cache.traced(prog)

    prog = cache.program(("sort", backend, b, w) + tuple(extra_key), builder)
    ks, rs = prog(keys, rows, n)
    if keep_padded:
        return ks, rs
    return ks[:n], rs[:n]


def merge_padded(
    keys_a: torch.Tensor,
    rows_a: torch.Tensor,
    keys_b: torch.Tensor,
    rows_b: torch.Tensor,
    *,
    backend: str = "torch",
    impl: Callable | None = None,
    extra_key: tuple = (),
    cache: PlanCache | None = None,
    n_valid_a: int | None = None,
    n_valid_b: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed two-run merge: one program per (backend, bucket_a,
    bucket_b, W).

    ``impl(ka, ra, kb, rb) -> (keys, rows)`` is the backend's merge body
    (default: the plain ``merge_words_keyed``); it runs over the whole
    bucket-shaped runs after the pad normalization (run a's pads take row
    ids from ``ROW_PAD_A``, run b's from ``ROW_PAD_B``), so the first
    ``na + nb`` merged rows equal the unpadded merge whatever the pad
    lanes held.  ``n_valid_a``/``n_valid_b`` mark a run as already
    bucket-shaped; without them it is padded here.  ``keep_padded``
    returns the full ``(ba + bb,)`` outputs, pads sorted to the tail, for
    the ladder that chains them into the next merge.
    """
    cache = cache or _GLOBAL
    w = int(keys_a.shape[1])
    if n_valid_a is None:
        na = int(keys_a.shape[0])
        ba = bucket_for("merge", na)
        keys_a, rows_a = pad_tail(keys_a, ba, SENTINEL), pad_tail(rows_a, ba, 0)
    else:
        na, ba = int(n_valid_a), int(keys_a.shape[0])
    if n_valid_b is None:
        nb = int(keys_b.shape[0])
        bb = bucket_for("merge", nb)
        keys_b, rows_b = pad_tail(keys_b, bb, SENTINEL), pad_tail(rows_b, bb, 0)
    else:
        nb, bb = int(n_valid_b), int(keys_b.shape[0])
    if impl is None:
        from .dbits import merge_words_keyed

        impl = merge_words_keyed

    def builder():
        def prog(ka, ra, kb, rb, nva, nvb):
            return impl(*_mask_run(ka, ra, nva, ROW_PAD_A), *_mask_run(kb, rb, nvb, ROW_PAD_B))

        return cache.traced(prog)

    prog = cache.program(("merge", backend, ba, bb, w) + tuple(extra_key), builder)
    km, rm = prog(keys_a, rows_a, keys_b, rows_b, na, nb)
    if keep_padded:
        return km, rm
    return km[: na + nb], rm[: na + nb]


def fused_extract_sort_padded(
    words: torch.Tensor,
    plan,
    rows: torch.Tensor,
    *,
    backend: str = "torch",
    cache: PlanCache | None = None,
    n_valid: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed extract+sort in one program per bucket *and* plan (the
    ``"torch"`` backend's fused path): the runtime-bitmap extraction under
    the plan's bitmap, then the keyed sort.

    All-ones pad keys extract to the all-ones compressed pattern, the
    maximum any real key can compress to, since the slack bits of the
    last compressed word are zero for every key; the reserved row range
    breaks the tie, so pads still sort strictly last.  The pads are
    normalized from the valid count before the extraction.
    ``n_valid``/``keep_padded`` behave as in :func:`sort_padded`.
    """
    cache = cache or _GLOBAL
    w = int(words.shape[1])
    if n_valid is None:
        n = int(words.shape[0])
        b = bucket_for("sort", n)
        words = pad_tail(words, b, SENTINEL)
        rows = pad_tail(rows, b, 0)
    else:
        n, b = int(n_valid), int(words.shape[0])

    def builder():
        from .compress import extract_bits_dynamic, plan_bitmap
        from .dbits import sort_words_keyed

        def prog(wp, rp, nv):
            wp, rp = _mask_run(wp, rp, nv, ROW_PAD_A)
            comp = extract_bits_dynamic(wp, plan_bitmap(plan), plan.n_words_out)
            return sort_words_keyed(comp, rp)

        return cache.traced(prog)

    prog = cache.program(("fused", backend, b, w, plan), builder)
    ks, rs = prog(words, rows, n)
    if keep_padded:
        return ks, rs
    return ks[:n], rs[:n]


def adjacent_dpos_padded(
    comp_sorted: torch.Tensor,
    *,
    backend: str = "torch",
    cache: PlanCache | None = None,
    n_valid: int | None = None,
) -> np.ndarray:
    """Adjacent distinction-bit positions of a sorted run: (n-1,) int32 on
    the host with ``NO_DBIT`` at equal-key adjacencies, the reference's
    refresh pass, one program per (backend, bucket, Wc); only the first
    ``n_valid`` lanes of a bucket-shaped run are read.  The refresh itself
    takes :func:`adjacent_dbitmap_padded`, whose W words are all that
    cross to the host.
    """
    cache = cache or _GLOBAL
    wc = int(comp_sorted.shape[1])
    if n_valid is None:
        n = int(comp_sorted.shape[0])
        if n < 2:
            return np.zeros((0,), np.int32)
        b = bucket_for("refresh", n)
        comp_sorted = pad_tail(comp_sorted, b, SENTINEL)
    else:
        n, b = int(n_valid), int(comp_sorted.shape[0])
        if n < 2:
            return np.zeros((0,), np.int32)

    def builder():
        from .dbits import adjacent_dbit_positions

        def prog(cp, nv):
            return adjacent_dbit_positions(cp[:nv])

        return cache.traced(prog)

    prog = cache.program(("refresh_dpos", backend, b, wc), builder)
    return prog(comp_sorted, n).to(torch.int32).cpu().numpy()


def adjacent_dbitmap_padded(
    comp_sorted: torch.Tensor,
    *,
    backend: str = "torch",
    impl: Callable | None = None,
    cache: PlanCache | None = None,
    n_valid: int | None = None,
) -> np.ndarray:
    """The OR of a sorted run's adjacent distinction bits: (W,) uint32
    bitmap words on the host, in the run's own bit space (equal-key
    adjacencies set nothing), one program per (backend, bucket, W) under
    the key ``refresh_dbitmap``.

    The refresh stage's device half in bitmap form: only the first
    ``n_valid`` lanes of a bucket-shaped run are read (without
    ``n_valid`` the run is padded to its bucket), and only the W words
    cross to the host.  ``impl(sorted_keys) -> (W,)`` is the backend's
    pass (default: the plain pass of ``compute_dbitmap``; the CUDA
    backend passes its dbit kernel's bitmap form).  The host half (each
    set bit mapped through D-offset) is
    ``repro_torch.core.metadata.meta_on_rebuild``.
    """
    cache = cache or _GLOBAL
    wc = int(comp_sorted.shape[1])
    if n_valid is None:
        n = int(comp_sorted.shape[0])
        b = bucket_for("refresh", n)
        comp_sorted = pad_tail(comp_sorted, b, SENTINEL)
    else:
        n, b = int(n_valid), int(comp_sorted.shape[0])

    def builder():
        from .dbits import compute_dbitmap

        def prog(cp, nv):
            return compute_dbitmap(cp[:nv], presorted=True, dbitmap_fn=impl)

        return cache.traced(prog)

    prog = cache.program(("refresh_dbitmap", backend, b, wc), builder)
    return to_u32(prog(comp_sorted, n))


# ---------------------------------------------------------------------------
# measured chunk tuning: chunk_threshold / chunk_size from the measured
# per-bucket sort and merge costs instead of static constructor knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChunkPlan:
    """A measured chunking policy for one backend.

    ``chunk_size`` minimizes the modeled *warm* cascade wall at ``ref_n``
    keys; ``chunk_threshold`` is the smallest power-of-two key count at
    which the chunked path's cold cost undercuts the extrapolated
    monolithic sort's.  The raw per-candidate samples ride along
    (seconds; ``*_cold`` is a first call, ``*_warm`` a repeat).
    """

    backend: str
    chunk_size: int
    chunk_threshold: int
    ref_n: int
    n_words: int
    sort_cold: dict[int, float]
    sort_warm: dict[int, float]
    merge_cold: dict[int, float]
    merge_warm: dict[int, float]


def _cascade_warm_model(n: int, c: int, sort_w: float, merge_w: float) -> float:
    """Modeled warm cascade wall: per-chunk sorts + per-level merges.

    The merge sample is one equal-halves merge at output bucket ``2c``;
    higher levels scale linearly in merged rows times the rank search's
    log(bucket) growth.
    """
    n_chunks = -(-n // c)
    cost = n_chunks * sort_w
    per_row = merge_w / (2 * c)
    base_steps = max(math.log2(c), 1.0)
    runs, size = n_chunks, c
    while runs > 1:
        merged_rows = (runs // 2) * 2 * size
        cost += per_row * merged_rows * (max(math.log2(size), 1.0) / base_steps)
        runs = -(-runs // 2)
        size *= 2
    return cost


def _median_wall(fn, iters: int, device: torch.device) -> float:
    """Median host wall of ``fn`` over ``iters`` calls, each ended by a
    wait for this thread's stream on a CUDA device."""
    walls = []
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        fn()
        sync_stream(device)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2]


def tune_chunking(
    backend,
    *,
    candidates: tuple[int, ...] = (1 << 16, 1 << 17, 1 << 18),
    n_words: int = 2,
    ref_n: int = 1 << 20,
    iters: int = 1,
    seed: int = 0,
) -> ChunkPlan:
    """Calibrate ``chunk_size`` / ``chunk_threshold`` for one backend.

    For every candidate chunk bucket ``c`` this times the backend's sort
    at bucket ``c`` (cold = the first call, then warm repeats) and one
    equal-halves merge at output bucket ``2c``, on random keys made on
    the backend's device.  ``backend`` is duck-typed: anything with the
    ``sort`` / ``merge_sorted`` backend-op signatures and a ``device``.

    The model is the reference's.  The reference reads "cold minus warm"
    as compile time; the port runs eagerly and has no compile, so here it
    is the first-call cost (allocator growth, kernel library and cuBLAS /
    cub workspace set-up), and the plan's numbers differ from the
    reference's.  The probes run inside :func:`scoped_cache`, so their
    programs never enter the serving cache.

    * ``chunk_size`` — the candidate minimizing the modeled warm cascade
      wall at ``ref_n`` keys (``_cascade_warm_model``).
    * ``chunk_threshold`` — the smallest power of two ``N >= 2 *
      chunk_size`` where the extrapolated monolithic cold cost (first-call
      cost fitted as a power law over the two largest candidates + n·log n
      warm scaling) exceeds the chunked path's cold cost; ``ref_n`` if the
      model never crosses below it.
    """
    rng = np.random.default_rng(seed)
    cands = sorted(int(c) for c in candidates)
    if len(cands) < 2:
        raise ValueError("need at least two chunk-size candidates")
    for c in cands:
        if c & (c - 1):
            raise ValueError(f"chunk-size candidates must be powers of two: {c}")
    dev = backend.device

    sort_cold: dict[int, float] = {}
    sort_warm: dict[int, float] = {}
    merge_cold: dict[int, float] = {}
    merge_warm: dict[int, float] = {}

    with scoped_cache():
        for c in cands:
            keys = to_carrier(rng.integers(0, 2**32, size=(c, n_words), dtype=np.uint32), dev)
            rows = iota(c, dev)

            def sort_c():
                return backend.sort(keys, rows, n_valid=c, keep_padded=True)

            sort_cold[c] = _median_wall(sort_c, 1, dev)
            sort_warm[c] = _median_wall(sort_c, iters, dev)
            # equal-halves merge at output bucket 2c: two independently sorted
            # c/2-runs with disjoint row ranges (the cascade invariant)
            h = c // 2
            ka, ra = backend.sort(keys[:h], iota(h, dev), n_valid=h, keep_padded=True)
            kb, rb = backend.sort(keys[h:], iota(h, dev), n_valid=h, keep_padded=True)
            rb = (rb + h) & MASK32

            def merge_c():
                return backend.merge_sorted(ka, ra, kb, rb, n_valid_a=h, n_valid_b=h,
                                            keep_padded=True)

            merge_cold[c] = _median_wall(merge_c, 1, dev)
            merge_warm[c] = _median_wall(merge_c, iters, dev)

    chunk_size = min(
        cands, key=lambda c: _cascade_warm_model(ref_n, c, sort_warm[c], merge_warm[c])
    )

    # -- threshold: where the monolithic first-call cost stops being worth paying
    c1, c2 = cands[-2], cands[-1]
    comp1 = max(sort_cold[c1] - sort_warm[c1], 1e-6)
    comp2 = max(sort_cold[c2] - sort_warm[c2], 1e-6)
    # first-call cost growth exponent, clamped to a sane superlinear band
    alpha = math.log(comp2 / comp1) / math.log(c2 / c1)
    alpha = min(max(alpha, 1.0), 3.0)
    c_ref = chunk_size
    sort_first = max(sort_cold[c_ref] - sort_warm[c_ref], 1e-6)
    merge_first = max(merge_cold[c_ref] - merge_warm[c_ref], 1e-6)
    warm_rate = sort_warm[c2] / (c2 * max(math.log2(c2), 1.0))

    def mono_cold(n: int) -> float:
        return comp2 * (n / c2) ** alpha + warm_rate * n * math.log2(n)

    def chunked_cold(n: int) -> float:
        levels = max(math.ceil(math.log2(-(-n // c_ref))), 1)
        firsts = sort_first + sum(
            merge_first * (2**lvl) ** (alpha - 1.0) for lvl in range(levels)
        )
        return firsts + _cascade_warm_model(n, c_ref, sort_warm[c_ref], merge_warm[c_ref])

    threshold = ref_n
    n = 2 * chunk_size
    while n < ref_n:
        if chunked_cold(n) < mono_cold(n):
            threshold = n
            break
        n *= 2

    return ChunkPlan(
        backend=getattr(backend, "name", "?"),
        chunk_size=chunk_size,
        chunk_threshold=threshold,
        ref_n=int(ref_n),
        n_words=int(n_words),
        sort_cold=sort_cold,
        sort_warm=sort_warm,
        merge_cold=merge_cold,
        merge_warm=merge_warm,
    )
