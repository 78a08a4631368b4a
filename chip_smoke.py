#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-keys N] [--seed S] [--log-dir DIR]

Run from the repository root (or anywhere: it finds ``src/`` next to
itself).  It drives the port only — never JAX, never the reference
package — and exits non-zero, printing no result, when there is no CUDA
device or any phase fails:

1. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and load them;
2. kernels vs plain versions, byte for byte, at edge shapes: n not a tile
   multiple, 128-word keys (pext, bitonic, pk-window, merge-rank, dbit),
   pext plans of 1, 32 and 33 bits, straddling bytes and whole words,
   bitonic keys of 24, 110, 111 and 128 words in 512-row blocks, duplicate
   and all-ones keys (bitonic, merge-rank), searched runs of 1 and 2^k±1
   rows, pad rows of both reserved ranges, unsorted queries, windows
   larger than the staging buffer and 9- and 16-word keys (merge-rank),
   windows starting on a word boundary and in the last word (pk-window in
   both forms, probe), tables of odd widths and off 16 bytes (the gather),
   both dbit forms (positions, bitmap) on runs of 1, 3, 4, 16, 33 and 128
   words with equal pairs, pairs that differ in the last bit only, keys
   equal but for the last word and row counts at the tile edges, in
   place and off 16 bytes; both
   forms of the probe (the mask and the lookup's leaf stage) on leaves
   shaped as the build makes them, keys of 1, 4, 16, 17 and 128 words, pk
   1, 16 and 32, one tree and a partial arena, leaves of 12 and 14 entries
   with lanes past n, duplicate, all-ones and one-bit-off queries;
3. the slice: ``ReconstructionPipeline(backend="cuda").run`` on the
   paper's Zipf(s=1.5, n=64 bytes, m=0) keys (§6.3, Table 4 dataset 15)
   at 10M keys, rows shuffled by a seeded permutation, rids = row index;
   unchunked (one 2^24 sort bucket), run twice (the second is timed) plus
   the full-key baseline, checked against the plain ``"torch"`` backend
   on the same card;
4. lookups: four batches of 2^18 queries, half hits and half misses,
   then one more run and lookup batch traced with ``torch.profiler``
   (device time by kernel, idle share of the window, the device-to-host
   copies), the refresh alone traced (its wall, and its device-to-host
   bytes: the Wc bitmap words), and the lookup batch alone traced: the
   PyTorch gathers left in it, and no gather of every leaf lane's full
   key;
5. chunked: the same keys through the pipeline's defaults (chunks of
   2^17 folded by the merge ladder above 2^19 keys), run twice, equal to
   phase 3's unchunked run byte for byte;
   then ``tune_chunking`` measures this card's sort and merge costs and
   picks a chunk plan at the 2^24 bucket; a pipeline with that plan and
   ``async_dispatch`` (one synchronize per run) rebuilds the same keys,
   timed, and once more with ``stage_timings=True``; both equal phase 3;
6. incremental: a replica whose metadata already covers the delta folds
   1 % fresh keys and 1 % deletes into its previous result
   (``run_incremental``), equal to a full run over the folded set and to
   the ``"torch"`` backend; then a change set with a changed D-bitmap
   (falls back to the full run) and an empty one (no-op);
7. multitenant: six tenants of exactly 1,000,000 Zipf(1.5, 64, 0) keys
   each (a tenth of ``--n-keys``, at least 2^19 + 1; seeds ``seed+1`` .. ``seed+6``, cut after the dedupe), each
   rebuilt by ``run(publish_to=cell)`` at the pipeline's defaults and
   published into a ``TenantRegistry`` (one arena of capacity 8, two pad
   slots); one fused ``lookup_many`` of 2^15 queries per tenant, half hits
   and half misses, one tenant ragged (``n_valid`` = 2^15 - 1000), equal
   per tenant (dead lanes included) to the single-tree ``"cuda"`` lookup
   and to the ``"torch"`` backend's ``lookup_many``; then one explicit
   ``flush`` of a ``MultiTenantEngine`` answers all six tenants in one
   dispatch; the fused wall against the six per-tenant walls;
8. mt_load: ``serve.loadgen.run_multitenant_load`` on ``"cuda"`` (8
   tenants of 2^17 four-word keys, 8 readers, batches of 1024, mutation
   batches of 1024, 5 s), then again at the reference bench's SLO point
   (``target_p99_us`` = 4 x the unloaded p50): no torn read, no stale
   epoch, no error, every tenant served;
9. online: phase 3's 10M-key ``"cuda"`` result wrapped in an
   ``OnlineIndex`` beside a ``"torch"`` twin wrapping phase 3's plain
   result, the meta compared after every mutation.  Round 1: 1,000
   fresh inserts (990 drawn from the generator, seed ``seed+21``; ten
   base keys with the top bit of a byte set, each a new distinction
   bit), 900 base deletes and 100 deletes of inserted keys; one
   ``search_batch`` of 2^18 queries before the mutations and one after
   (live inserts hit with their rids, deleted keys miss, untouched base
   keys hit, misses miss; ``search`` equal to its row); the meta a
   superset of the folded set's D-bitmap (Theorem 2); a rebuild that
   falls back to the full resort (the bitmap moved); a reader pinned on
   the old epoch keeps its answers.  Round 2: 200 base deletes and
   re-inserts of 100 of them (no new bit), then a rebuild that merges
   the delta.  Each rebuild equal to a full run over the folded set and
   to the ``"torch"`` rebuild; µs per insert and delete, the batch with
   and without the overlay, each rebuild's wall and stages, the
   neighbor view's build and host bytes;
10. run_many: five disjoint key sets of one Zipf(1.5, 64, 0) draw (seed
   ``seed+11``): four of 2.09M down to 2.0M keys in the 2^21 bucket that
   share their union's DS-metadata, as replicas of one index do (one
   group: a pext launch per member, one bitonic launch over the stack),
   and one of 300,000 keys with no metadata given (another bucket:
   ``meta_from_keys``, then ``run``); each member equal to its single run
   and to the ``"torch"`` backend's ``run_many``; the batched wall against
   the single runs' (at the pipeline's defaults and unchunked);
11. replication: phase 3's keys as the base table of a ``StreamPrimary``
   on ``"cuda"`` over a ``DirectoryTransport`` (frames fsynced on disk,
   under a temporary directory that is removed at the end) with bounded
   lag 2, so it checkpoints and truncates after batches 2 and 5 (a full
   step, then a delta step chained onto it); six batches of 10,000 fresh
   Zipf inserts (seed ``seed+31``) and 10,000 deletes of live rids, batch
   4 with ten new-bit keys (one fallback resort).  A ``"cuda"`` tail and
   a ``"torch"`` tail poll after every batch; a ``"cuda"`` lagger first
   polls after batch 6, finds its start truncated, bootstraps from the
   checkpoint at the stream's start (the index recovery at 10M keys) and
   drains the rest frame by frame.  The tail and the lagger equal the
   primary byte for byte, the tail equals the ``"torch"`` tail, each
   equals a full ``"cuda"`` run over its keyset, one 2^18-query batch
   answers alike on all of them, and ``restore_checkpoint`` of step 2 (a
   delta step) returns the primary's state there.  Each apply's wall and
   path, the checkpoint writes, the lagger's restore and rebuild, the
   checkpoint bytes and the peak device memory are printed.  Then one
   chaos soak (``repro_torch.tools.chaos_soak``) on ``"cuda"`` over a
   directory spool keeps every invariant;
12. load: ``serve.loadgen.run_load`` on ``"cuda"`` at the reference
   bench's key shape (two words, mask ``0x00FF0F0F``) with 2^22 draws
   (about 4.19M keys after the dedupe): 8 reader threads, probe batches
   of 256, a writer folding 1,024 redrawn keys per cycle through
   ``run_incremental``, 5 s; the writer's first incremental result, made
   before the readers start, equals a full ``"cuda"`` run over its folded
   keyset and the ``"torch"`` backend's ``run_incremental`` on the same
   inputs.  Then again at the reference's admission point (a writer
   owing a cycle every 1 ms, lag bound 1, shed): both runs without a
   torn read, stale epoch or error, at least 3 epochs, acquires equal to
   releases, two readers pinned at once in the first, sheds in the
   second; each run's ``to_row()``;
13. pager: a ``"cuda"`` ``serve.pager.PagedKVManager`` of 2^17 pages of
   16 tokens (the KV cache of a Llama-3.2-1B-sized model in 64 GiB)
   filled with 4,000 sequences of 32 pages, beside a ``"torch"`` twin on
   the same card, its journal shipped by a ``StreamPrimary`` over a
   ``DirectoryTransport`` (under a temporary directory) to a ``"cuda"``
   ``StreamReplica`` standby.  After the first build and each of 10
   seeded churn rounds (``free_seq``, ``pages_for`` of 1 to 32 pages, a
   re-alloc of a mapped slot, ``rebuild_index``) the pagers agree byte
   for byte (table, free list, meta, tree, last rebuild), every mapped
   page answers its physical page on both and on the standby and freed
   pages miss; a quiet rebuild ships nothing.  Then ``run_pager_load``
   at the same size (8 readers, 5 s): no torn read, stale epoch or
   error.  Each rebuild's wall and path, the gets per second and the
   percentiles are printed;
14. kernel report: each kernel's launches on the main paths (phases 3, 5,
   6, 7, 8, 9, 10, 11, 12 and 13, each counted from 0), its device time at the
   main path's
   shapes (and its time per call, host launch included), its plain
   version's time and the least time the card could take for the same
   bytes and operations; pk-window beside the plain gather of the same
   rows alone, and its index form beside the gather-then-window pair it
   replaces; merge-rank at the largest cascade merge and at the
   incremental merge; probe and probe_many also in the leaf-stage form
   their lookups run, beside the plain leaf stage and the unfused stage
   (the mask form, then the PyTorch gather, compare and select); dbit in
   its positions form at the build's run, its bitmap form at the
   refresh's and at meta_from_keys' sorted full keys, with its launches
   by form; bitonic also in the stacked form of ``run_many`` (one launch
   over the members' whole blocks) beside the plain network member by
   member.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.backends import cuda_backend, get_backend  # noqa: E402
from repro_torch.configs.paper_index import ZipfConfig  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core import btree  # noqa: E402
from repro_torch.core.btree import (  # noqa: E402
    NOT_FOUND_RID, _as_stack, _descend, _descend_many, _leaf_keys_many, _tenant_rows)
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import (  # noqa: E402
    NO_DBIT, compute_dbitmap, lex_less, sort_words, sort_words_keyed)
from repro_torch.core.index import OnlineIndex  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.core.metadata import meta_from_keys  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline, fold_keyset  # noqa: E402
from repro_torch.core.snapshot import SnapshotCell  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data.synthetic import zipf_keys  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import DEFAULT_BLOCK, block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import (  # noqa: E402
    gather_windows, gather_windows_plain, pk_windows, pk_windows_plain)
from repro_torch.kernels.dbit import (  # noqa: E402
    SECTOR_WORDS, adjacent_dbitmap, adjacent_dbitmap_plain, adjacent_dbits, adjacent_dbits_plain)
from repro_torch.kernels.lookup import (  # noqa: E402
    leaf_stage, leaf_stage_many, leaf_stage_many_plain, probe, probe_many,
    probe_many_plain, probe_plain)
from repro_torch.kernels.lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.lookup.ref import leaf_arena, member_tree  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain  # noqa: E402
from repro_torch.kernels.merge import ops as merge_ops  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
from repro_torch.kernels.pext.ops import segment_plan  # noqa: E402
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    ChangeLog, DirectoryTransport, StreamPrimary, StreamReplica)
from repro_torch.replication import replica as replica_mod  # noqa: E402
from repro_torch.replication.stream import _state_like  # noqa: E402
from repro_torch.tools.chaos_soak import run_soak  # noqa: E402
from repro_torch.serve import MultiTenantEngine, TenantRegistry  # noqa: E402
from repro_torch.serve.loadgen import run_load, run_multitenant_load, run_pager_load  # noqa: E402
from repro_torch.serve.pager import PagedKVManager  # noqa: E402

#: H100 SXM HBM3 rate (NVIDIA data sheet), for the bytes bound
PEAK_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit rate outside the tensor cores (NVIDIA data sheet, the
#: float32 figure), for the operations bound of the kernels' integer work
PEAK_OPS_PER_S = 67e12
#: the default --n-keys: phase 3's Zipf index at full size
FULL_N_KEYS = 10_000_000
BATCH = 1 << 18
N_BATCHES = 4
N_TENANTS = 6
TENANT_QUERIES = 1 << 15
RAGGED_TENANT = 2
ONLINE_INSERTS = 1000
ONLINE_NEW_BITS = 10
ONLINE_BASE_DELETES = 900
ONLINE_DELTA_DELETES = 100
ONLINE_REINSERTS = 100
#: run_many: four members inside the 2^21 bucket and one of another
#: bucket, at the default --n-keys
MANY_SIZES = (2_090_000, 2_060_000, 2_030_000, 2_000_000)
MANY_OTHER = 300_000
#: replication: batches published, inserts and deletes each, the batch
#: that also inserts the new-bit keys, and the primary's bounded lag
REPL_BATCHES = 6
REPL_INSERTS = 10_000
REPL_DELETES = 10_000
REPL_NEW_BIT_BATCH = 4
REPL_MAX_LAG = 2

#: load: run_load's draws at full size (about 4.19M keys after the dedupe)
LOAD_N_KEYS = 1 << 22
#: pager: 2^17 pages of 16 tokens, filled with 4,000 sequences of 32 pages
#: (3,072 free), and the churn rounds after the first build
PAGER_PAGES = 1 << 17
PAGER_TOKENS = 16
PAGER_SEQS = 4000
PAGER_SEQ_PAGES = 32
PAGER_ROUNDS = 10

#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "pext": ("src/repro_torch/csrc/pext.cu", "src/repro/kernels/pext/kernel.py:35"),
    "bitonic_block_sort": ("src/repro_torch/csrc/bitonic.cu",
                           "src/repro/kernels/bitonic/kernel.py:43"),
    "pk_window": ("src/repro_torch/csrc/pk_window.cu",
                  "src/repro/kernels/build/kernel.py:38"),
    "probe": ("src/repro_torch/csrc/probe.cu", "src/repro/kernels/lookup/kernel.py:36"),
    "merge_rank": ("src/repro_torch/csrc/merge_rank.cu",
                   "src/repro/kernels/merge/kernel.py:45"),
    "dbit": ("src/repro_torch/csrc/dbit.cu", "src/repro/kernels/dbit/kernel.py:27"),
    "probe_many": ("src/repro_torch/csrc/probe.cu", "src/repro/kernels/lookup/kernel.py:91"),
}
#: kernels each main path must launch
PATH_KERNELS = {
    "slice": ("pext", "bitonic_block_sort", "pk_window", "probe", "dbit"),
    "chunked": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit"),
    "incremental": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit"),
    "multitenant": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit",
                    "probe_many"),
    "mt_load": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit",
                "probe_many"),
    "online": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
    "run_many": ("pext", "bitonic_block_sort", "pk_window", "dbit"),
    "replication": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
    "load": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
    "pager": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
}


def check(cond, msg: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``cond``."""
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


#: device cycles (about 1 ms) queued ahead of a timed call, so that the
#: host has enqueued the call before its start event is reached
SLEEP_CYCLES = 2_000_000


def cuda_ms(fn, reps: int, *, with_launch: bool = False) -> float:
    """Median time of one call of ``fn`` in ms, by CUDA events, after a
    warm-up: its device time, with the call enqueued behind a device sleep
    so that the host's launch overhead is not counted; or, with
    ``with_launch``, from an idle device, the host's launch included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not with_launch:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rand_words(rng, n, w, mask=0xFFFFFFFF) -> np.ndarray:
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at edge shapes
# ---------------------------------------------------------------------------

def edge_checks(dev, rng) -> None:
    # pext: n off any tile multiple, 3-word and 128-word keys
    for n, w, mask in [(5003, 3, 0x3FC0FF03), (300, 128, 0x01010101), (4099, 16, 0x0F0F0F0F)]:
        words = to_carrier(rand_words(rng, n, w, mask), dev)
        plan = make_plan(to_u32(compute_dbitmap(words)), w)
        check(same(pext(words, plan), pext_plain(words, plan)),
              f"pext kernel != plain at n={n} W={w} ({plan.n_bits} bits)")
    # pext plans at the segment compiler's edges: one kept bit, 32 and 33,
    # a byte's bits straddling two output words, every bit of a word, and
    # every bit of 128 words
    for name, positions, w in [
            ("one bit", [77], 4), ("32 bits", list(range(0, 64, 2)), 4),
            ("33 bits", list(range(5, 38)), 3),
            ("straddling bytes", list(range(3, 33)) + list(range(40, 46)), 2),
            ("every bit of a word", [1, 2] + list(range(32, 64)), 3),
            ("every bit of 128 words", list(range(128 * 32)), 128)]:
        bm = np.zeros(w, np.uint32)
        for pos in positions:
            bm[pos // 32] |= np.uint32(1 << (31 - pos % 32))
        plan = make_plan(bm, w)
        words = to_carrier(rand_words(rng, 4099, w), dev)
        check(same(pext(words, plan), pext_plain(words, plan)),
              f"pext kernel != plain on the plan with {name}")
    # bitonic: duplicates, all-ones keys with a permuted payload, a ragged
    # last block, the full-key width, 128-word keys in a 64-row block, and
    # 512-row blocks of the widths past the register path (24, 110, 111
    # and 128 words: shared-memory words plus device-memory tie-breaks)
    for n, w, block, kind in [(4096 + 77, 4, 512, "dup"), (1000, 2, 512, "ones"),
                              (5000, 16, 512, "dup"), (777, 3, 128, "rand"),
                              (300, 128, 64, "dup"), (2049, 24, 512, "dup"),
                              (1500, 110, 512, "rand"), (1025, 111, 512, "ones"),
                              (1537, 128, 512, "dup"), (1537, 128, 512, "prefix")]:
        if kind == "dup":
            keys = np.repeat(rand_words(rng, -(-n // 4), w, 0x000000FF), 4, axis=0)[:n]
        elif kind == "ones":
            keys = np.full((n, w), 0xFFFFFFFF, np.uint32)
        elif kind == "prefix":  # keys differ in the last word only
            keys = np.zeros((n, w), np.uint32)
            keys[:, -1] = rand_words(rng, n, 1, 0x000000FF)[:, 0]
        else:
            keys = rand_words(rng, n, w)
        words = to_carrier(keys, dev)
        rows = torch.as_tensor(rng.permutation(n), device=dev)
        kk, kr = block_sort(words, rows, block=block)
        pk_, pr = block_sort_plain(words, rows, block=block)
        check(same(kk, pk_) and same(kr, pr),
              f"bitonic kernel != plain at n={n} W={w} block={block} ({kind})")
        key_of_row = torch.empty_like(words)
        key_of_row[rows] = words
        check(same(key_of_row[kr], kk), f"bitonic payload does not follow keys ({kind})")
        check(same(torch.sort(kr).values, torch.arange(n, device=dev)),
              f"bitonic payload is not a permutation ({kind})")
    # the stacked form run_many launches: three members of a 256-row
    # bucket (rounded up to one 512-row block each) and of 1024 rows, pad
    # rows as run_many pads them, one bitonic launch, equal to the
    # "torch" backend's member-by-member extract and sort
    cuda_be, torch_be = get_backend("cuda", device=dev), get_backend("torch", device=dev)
    for b, w, k in [(256, 3, 3), (1024, 16, 3)]:
        sizes = [b - 7 * i for i in range(k)]
        keys = [rand_words(rng, m, w, 0x0F0F0F0F) for m in sizes]
        meta = meta_from_keys(np.concatenate(keys), dev)
        words = np.stack([np.concatenate([x, np.full((b - x.shape[0], w), 0xFFFFFFFF,
                                                     np.uint32)]) for x in keys])
        rows = np.stack([np.concatenate([np.arange(m), plancache.ROW_PAD_A + np.arange(b - m)])
                         for m in sizes])
        args_ = (to_carrier(words, dev), to_carrier(np.stack([meta.dbitmap] * k), dev),
                 torch.as_tensor(rows, device=dev), [make_plan(meta.dbitmap, w)] * k)
        cudalib.reset_launches()
        got = cuda_be.batched_extract_sort(*args_)
        check(cudalib.LAUNCHES["bitonic_block_sort"] == 1 and cudalib.LAUNCHES["pext"] == k,
              f"the stacked sort of {k} x {b} rows made {cudalib.LAUNCHES['bitonic_block_sort']} "
              "bitonic launches")
        want = torch_be.batched_extract_sort(*args_)
        check(same(got[0], want[0]) and same(got[1], want[1]),
              f"stacked bitonic sort of {k} x {b} rows != the torch backend's")
    # pk-window: starts on word boundaries (sh == 0), in the last word,
    # and outside the key (clipped), for pk 1, 16 and 32; the gathered rows
    # of the leaf form (16-byte chunks; 8-byte words for odd widths and a
    # table off 16 bytes; rows of 128 words span four warps) and the index
    # form, with repeated row ids
    for m, w in [(10007, 16), (333, 1), (4096, 4), (3001, 3), (777, 128), (2049, 33)]:
        words = to_carrier(rand_words(rng, m, w), dev)
        top = w * 32
        starts = np.concatenate([
            rng.integers(-40, top + 40, size=m - m // 2),
            32 * rng.integers(0, w, size=m // 4),
            top - 1 - rng.integers(0, 32, size=m // 2 - m // 4),
        ])
        st = torch.as_tensor(rng.permutation(starts), device=dev)
        for pk in (1, 16, 32):
            check(same(pk_windows(words, st, pk), pk_windows_plain(words, st, pk)),
                  f"pk-window kernel != plain at m={m} W={w} pk={pk}")
            for table in (words, words[1:]):
                rows = torch.as_tensor(rng.integers(0, table.shape[0], size=m), device=dev)
                got, want = gather_windows(table, rows, st, pk), \
                    gather_windows_plain(table, rows, st, pk)
                check(same(got[0], want[0]) and same(got[1], want[1]),
                      f"pk-window gather kernel != plain at m={m} W={w} pk={pk}")
                check(same(pk_windows(table, st, pk, rows), pk_windows_plain(table, st, pk, rows)),
                      f"pk-window index kernel != plain at m={m} W={w} pk={pk}")
    # probe: random leaves with dpos + 1 on word boundaries and in the last word
    for q, w, n_leaves, lc in [(3001, 16, 500, 12), (64, 2, 7, 3)]:
        top = w * 32
        queries = to_carrier(rand_words(rng, q, w), dev)
        dpos = np.concatenate([
            32 * rng.integers(0, w, size=n_leaves * lc // 3) - 1,
            top - 2 - rng.integers(0, 32, size=n_leaves * lc // 3),
        ])
        dpos = np.concatenate([dpos, rng.integers(0, top, size=n_leaves * lc - dpos.size)])
        leaf_dpos = torch.as_tensor(rng.permutation(dpos).reshape(n_leaves, lc), device=dev)
        node = torch.as_tensor(rng.integers(0, n_leaves, size=q), device=dev)
        for pk in (16, 32):
            win = pk_windows_plain(queries.repeat_interleave(lc, 0),
                                   leaf_dpos[node].reshape(-1) + 1, pk).reshape(q, lc)
            # half the stored partial keys match the query window
            leaf_pk = to_carrier(rand_words(rng, n_leaves, lc, (1 << pk) - 1), dev)
            leaf_pk[node[: q // 2]] = win[: q // 2]
            got = probe(queries, node, leaf_dpos, leaf_pk, pk)
            check(same(got, probe_plain(queries, node, leaf_dpos, leaf_pk, pk)),
                  f"probe kernel != plain at q={q} W={w} pk={pk}")
            check(bool(got.any()), "probe matched nothing")
    # probe_many: T = 1 and a partial arena (3 tenants of capacity 4), q * lc
    # off any multiple of 256, dpos + 1 on word boundaries and in the last
    # word, pk 1, 16 and 32, all-ones queries (dead lanes) at each tail
    for t, t_cap, q, w, n_leaves, lc in [(1, 1, 3001, 16, 500, 12), (3, 4, 77, 2, 7, 3),
                                         (3, 4, 1000, 16, 400, 12)]:
        top = w * 32
        queries = to_carrier(rand_words(rng, t * q, w), dev).reshape(t, q, w)
        queries[:, -5:] = 0xFFFFFFFF
        size = t_cap * n_leaves * lc
        dpos = np.concatenate([32 * rng.integers(0, w, size=size // 3) - 1,
                               top - 2 - rng.integers(0, 32, size=size // 3)])
        dpos = np.concatenate([dpos, rng.integers(0, top, size=size - dpos.size)])
        leaf_dpos = torch.as_tensor(rng.permutation(dpos).reshape(t_cap, n_leaves, lc),
                                    device=dev)
        node = torch.as_tensor(rng.integers(0, n_leaves, size=(t, q)), device=dev)
        for pk in (1, 16, 32):
            leaf_pk = to_carrier(rand_words(rng, t_cap * n_leaves, lc, (1 << pk) - 1),
                                 dev).reshape(t_cap, n_leaves, lc)
            for ti in range(t):  # half the queries meet their leaf's windows
                rows = node[ti, : q // 2]
                leaf_pk[ti, rows] = pk_windows_plain(
                    queries[ti, : q // 2].repeat_interleave(lc, 0),
                    leaf_dpos[ti, rows].reshape(-1) + 1, pk).reshape(-1, lc)
            got = probe_many(queries, node, leaf_dpos, leaf_pk, pk)
            check(same(got, probe_many_plain(queries, node, leaf_dpos, leaf_pk, pk)),
                  f"probe_many kernel != plain at T={t} of {t_cap} q={q} W={w} pk={pk}")
            for ti in range(t):
                check(same(got[ti], probe(queries[ti], node[ti], leaf_dpos[ti],
                                          leaf_pk[ti], pk)),
                      f"probe_many tenant {ti} != probe at q={q} W={w} pk={pk}")
            check(bool(got.any()), "probe_many matched nothing")
    # both forms of the lane-group probe on leaves shaped as the build makes
    # them (kernels.lookup.ref.leaf_arena): keys of 1 to 128 words (the
    # window's second word in the next 16-word chunk, full compares over
    # several chunks), pk 1, 16 and 32, T = 1 and a partial arena, leaves of
    # 12 and of 14 entries (the widest) with lanes past n, duplicate,
    # all-ones and one-bit-off queries; the leaf-stage form also on one tree
    for w in (1, 4, 16, 17, 128):
        for pk in (1, 16, 32):
            for t, t_cap, lc in [(1, 1, 12), (3, 4, 14)]:
                arena, qs, nd = leaf_arena(int(rng.integers(1 << 30)), t, t_cap, 300, lc, w,
                                           pk, 3001, dev)
                lf, what = arena.leaf, f"T={t} of {t_cap} lc={lc} W={w} pk={pk}"
                check(same(probe_many(qs, nd, lf["dpos"], lf["pk"], pk),
                           probe_many_plain(qs, nd, lf["dpos"], lf["pk"], pk)),
                      f"probe_many kernel != plain at {what}")
                got, want = leaf_stage_many(arena, nd, qs), leaf_stage_many_plain(arena, nd, qs)
                check(same(got[0], want[0]) and same(got[1], want[1]),
                      f"probe_many leaf stage != plain at {what}")
                check(bool(got[0].any()) and not bool(got[0].all()),
                      f"the leaf stage found all or nothing at {what}")
                one = _as_stack(member_tree(arena, 0))
                got = leaf_stage(one, nd[:1], qs[:1])
                want = leaf_stage_many_plain(one, nd[:1], qs[:1])
                check(same(got[0], want[0]) and same(got[1], want[1]),
                      f"probe leaf stage != plain at {what}")
    # merge-rank: n_q off any multiple of 256; searched runs of 1, 2^k - 1
    # and 2^k + 1 rows; duplicate keys whose ties fall to the row word;
    # 128-word keys
    def sorted_run(n, w, mask, row_base):
        keys = to_carrier(rand_words(rng, n, w, mask), dev)
        return sort_words_keyed(keys, row_base + torch.as_tensor(rng.permutation(n), device=dev))

    # windows past the staging buffer (sampled, then probed) and within it;
    # 9- and 16-word keys (ties on the staged words read the rest);
    # each shape also with its queries out of order (every tile searches
    # the whole run) and with one tile out of order
    for n_q, n_s, w, mask in [(1000, 4097, 3, 0x0F0F0F0F), (777, 1, 4, 0xFF),
                              (5003, 4095, 4, 0xFF), (300, 65537, 2, 0x3),
                              (129, 300, 128, 0x1), (2000, 300001, 4, 0xFFFFFFFF),
                              (3000, 20000, 9, 0x1), (1500, 100000, 16, 0x3)]:
        keys_s, rows_s = sorted_run(n_s, w, mask, 0)
        keys_q, rows_q = sorted_run(n_q, w, mask, n_s)
        shuffled = torch.as_tensor(rng.permutation(n_q), device=dev)
        one_tile = torch.arange(n_q, device=dev)
        one_tile[:256] = shuffled[shuffled < 256][:256]
        for order, kind in [(None, "sorted"), (shuffled, "unsorted"), (one_tile, "one unsorted tile")]:
            kq, rq = (keys_q, rows_q) if order is None else (keys_q[order], rows_q[order])
            check(same(merge_ranks(kq, rq, keys_s, rows_s),
                       merge_ranks_plain(kq, rq, keys_s, rows_s)),
                  f"merge-rank kernel != plain at n_q={n_q} n_s={n_s} W={w} ({kind})")
    # all-ones keys against pad rows of both reserved ranges
    ones = torch.full((2048, 2), plancache.SENTINEL, dtype=torch.int64, device=dev)
    lane = torch.arange(1024, device=dev)
    rows_s = torch.cat([lane, plancache.ROW_PAD_A + lane])
    rows_q = torch.cat([lane[:300] + 1024, plancache.ROW_PAD_B + lane[:700]])
    check(same(merge_ranks(ones[:1000], rows_q, ones, rows_s),
               merge_ranks_plain(ones[:1000], rows_q, ones, rows_s)),
          "merge-rank kernel != plain on all-ones keys and pad rows")
    # dbit, both forms: equal pairs, a pair that differs in the last bit
    # of the last word only, keys equal but for the last word (rows walk
    # on past the first sector), pair counts at the tile edges (a block
    # takes 256 pairs), runs in place and off 16 bytes
    for w in (1, 3, 4, 16, 33, 128):
        for n in (2, 256, 257, 258, 4097, 20001):
            keys = sort_words(to_carrier(rand_words(rng, n, w, 0x00FF00FF), dev))[0]
            keys[n // 2] = keys[n // 2 - 1]
            if n > 4:
                keys[3] = keys[2]
                keys[3, -1] ^= 1
            tail = torch.zeros((n, w), dtype=torch.int64, device=dev)
            tail[:, -1] = torch.arange(n, device=dev) // 2
            for kind, run in (("random", keys), ("last word", tail)):
                flat = torch.cat([run.new_zeros(1), run.reshape(-1)])
                for where, view in (("in place", run), ("off 16 bytes", flat[1:].view(n, w))):
                    what = f"n={n} W={w} ({kind}, {where})"
                    got = adjacent_dbits(view)
                    check(same(got, adjacent_dbits_plain(view)), f"dbit kernel != plain at {what}")
                    check(same(adjacent_dbitmap(view), adjacent_dbitmap_plain(view)),
                          f"dbit bitmap form != plain at {what}")
                    if kind == "random" and n > 4:
                        check(int(got[2]) == 32 * w - 1 and int(got[n // 2 - 1]) == NO_DBIT,
                              f"dbit kernel misses the last-bit or the equal pair at {what}")


# ---------------------------------------------------------------------------
# phases 3-4: the slice and its lookups
# ---------------------------------------------------------------------------

def tree_arrays(tree) -> dict:
    out = {f"leaf.{k}": v for k, v in tree.leaf.items()}
    for i, level in enumerate(tree.levels):
        out.update({f"level{i}.{k}": v for k, v in level.items()})
    out["sorted_full"] = tree.sorted_full
    out["sorted_rids"] = tree.sorted_rids
    return out


def results_equal(got, want, what: str) -> None:
    """Fail unless two results agree byte for byte: sorted run, row and
    rid permutations, every tree array and the refreshed meta."""
    for name in ("comp_sorted", "row_sorted", "rid_sorted"):
        check(same(getattr(got, name), getattr(want, name)), f"{what}: {name} differs")
    got_arrays, want_arrays = tree_arrays(got.tree), tree_arrays(want.tree)
    check(got_arrays.keys() == want_arrays.keys(), f"{what}: tree shapes differ")
    for key in got_arrays:
        check(same(got_arrays[key], want_arrays[key]), f"{what}: tree {key} differs")
    for field in ("dbitmap", "varbitmap", "refkey"):
        check(np.array_equal(getattr(got.meta, field), getattr(want.meta, field)),
              f"{what}: meta.{field} differs")


def path_launches() -> dict:
    """Each kernel wrapper's launches since the last reset, and the dbit
    kernel's by form."""
    return {**cudalib.LAUNCHES, "dbit_by_form": dict(cudalib.LAUNCHES_BY_FORM["dbit"])}


def add_launches(acc: dict, cur: dict) -> dict:
    """Add one reading of :func:`path_launches` into ``acc``."""
    for name, count in cur.items():
        if isinstance(count, dict):
            sub = acc.setdefault(name, {})
            for form, c in count.items():
                sub[form] = sub.get(form, 0) + c
        else:
            acc[name] = acc.get(name, 0) + count
    return acc


@contextmanager
def counted(acc: dict):
    """Count into ``acc`` the launches made inside the block (the counts
    are set to 0 at its start), so that the checks between the blocks of
    a path stay out of its counts."""
    cudalib.reset_launches()
    try:
        yield
    finally:
        add_launches(acc, path_launches())


def check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"the {path} path never launched the {name} kernel")
    # every path builds (positions form) and refreshes (bitmap form)
    for form, count in launches["dbit_by_form"].items():
        check(count > 0, f"the {path} path never launched the dbit kernel's {form} form")


@contextmanager
def largest_rank_pass():
    """Record the inputs of the largest ``merge_ranks`` call (by query
    plus searched rows) made inside the block: the rank pass of the
    largest merge.  The call itself runs unchanged."""
    seen: dict = {}
    orig = merge_ops.merge_ranks

    def spy(keys_q, rows_q, keys_s, rows_s):
        rows = int(keys_q.shape[0]) + int(keys_s.shape[0])
        if rows > seen.get("rows", -1):
            seen.update(rows=rows, args=(keys_q, rows_q, keys_s, rows_s))
        return orig(keys_q, rows_q, keys_s, rows_s)

    merge_ops.merge_ranks = spy
    try:
        yield seen
    finally:
        merge_ops.merge_ranks = orig


@contextmanager
def largest_insert_rank():
    """Record the largest ``rank_fn`` call of the ``"cuda"`` backend made
    inside the block (by query plus searched rows), its inputs and its
    output: the replica's insert rule, whose queries come unsorted, each
    with row 0, against a standing run of the full index.  The call
    itself runs unchanged."""
    seen: dict = {}
    orig = cuda_backend.CudaBackend.rank_fn

    def spy(keys_q, rows_q, keys_s, rows_s):
        out = orig(keys_q, rows_q, keys_s, rows_s)
        seen["calls"] = seen.get("calls", 0) + 1
        rows = int(keys_q.shape[0]) + int(keys_s.shape[0])
        if rows > seen.get("rows", -1):
            seen.update(rows=rows, args=(keys_q, rows_q, keys_s, rows_s), out=out)
        return out

    cuda_backend.CudaBackend.rank_fn = staticmethod(spy)
    try:
        yield seen
    finally:
        cuda_backend.CudaBackend.rank_fn = staticmethod(orig)


@contextmanager
def stacked_sort_call():
    """Record the inputs of the largest bitonic launch the ``"cuda"``
    backend makes inside the block: in ``run_many`` the one launch over
    the stacked members.  The call itself runs unchanged."""
    seen: dict = {}
    orig = cuda_backend.block_sort

    def spy(keys, rows, block=DEFAULT_BLOCK):
        if int(keys.shape[0]) > seen.get("rows", -1):
            seen.update(rows=int(keys.shape[0]), args=(keys, rows))
        return orig(keys, rows, block=block)

    cuda_backend.block_sort = spy
    try:
        yield seen
    finally:
        cuda_backend.block_sort = orig


def rows_in(words: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Which rows of ``words`` equal a row of ``table``, exactly; a 64-bit
    polynomial hash of each row narrows the candidates."""
    def row_hash(a):
        h = np.zeros(a.shape[0], np.uint64)
        for col in a.T:  # wraps modulo 2**64
            h = h * np.uint64(0x100000001B3) + col.astype(np.uint64)
        return h

    th = row_hash(table)
    order = np.argsort(th)
    th = th[order]
    wh = row_hash(words)
    idx = np.searchsorted(th, wh)
    out = np.zeros(words.shape[0], bool)
    for i in np.flatnonzero(th[np.minimum(idx, th.size - 1)] == wh):
        j = idx[i]
        while j < th.size and th[j] == wh[i] and not out[i]:
            out[i] = np.array_equal(table[order[j]], words[i])
            j += 1
    return out


def make_queries(words: np.ndarray, rng, size: int = BATCH,
                 rids: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A batch of hits (rows sampled by seed; expected rid = ``rids[row]``,
    the row itself by default) and misses (byte 63 set to 'A': the
    generator only emits 'a'..'z')."""
    n = words.shape[0]
    hit_rows = rng.integers(0, n, size=size // 2)
    misses = words[rng.integers(0, n, size=size - size // 2)].copy()
    misses[:, -1] = (misses[:, -1] & np.uint32(0xFFFFFF00)) | np.uint32(ord("A"))
    queries = np.concatenate([words[hit_rows], misses])
    hit_rids = hit_rows.astype(np.uint32) if rids is None else rids[hit_rows]
    expect = np.concatenate([hit_rids, np.full(misses.shape[0], NOT_FOUND_RID, np.uint32)])
    order = rng.permutation(size)
    return queries[order], expect[order]


#: the kernel functions of csrc/*.cu
PORT_KERNEL_FUNCTIONS = ("pext_kernel", "bitonic_regs_kernel", "bitonic_wide_kernel",
                         "gather_window_kernel", "pk_window_kernel", "probe_group_kernel",
                         "merge_rank_kernel", "dbit_kernel")


def port_kernel(name: str) -> str | None:
    """A traced kernel's name without namespace and arguments (template
    arguments kept) if it is one of the port's, else None."""
    for prefix in ("(anonymous namespace)::", "void (anonymous namespace)::"):
        if name.startswith(prefix):
            short = name[len(prefix):].split("(")[0]
            if short.split("<")[0] in PORT_KERNEL_FUNCTIONS:
                return short
    return None


@contextmanager
def leaf_key_gathers():
    """Record the shapes of the plain leaf stage's gathers of every lane's
    full key (``core.btree._leaf_keys_many``) made inside the block."""
    calls: list = []
    orig = btree._leaf_keys_many

    def spy(stacked, node):
        calls.append(tuple(node.shape))
        return orig(stacked, node)

    btree._leaf_keys_many = lookup_ops._leaf_keys_many = spy
    try:
        yield calls
    finally:
        btree._leaf_keys_many = lookup_ops._leaf_keys_many = orig


def device_ms_by_kernel(prof) -> list:
    """(kernel name, device ms, calls) of a profile, largest first."""
    from torch.autograd import DeviceType

    return sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda row: -row[1],
    )


def dtoh_bytes(prof, trace: Path) -> list:
    """The bytes of each device-to-host copy of a profile, largest first,
    read from its exported trace (written to ``trace``)."""
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return sorted((int(e["args"]["bytes"]) for e in events
                   if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")),
                  reverse=True)


def profile_slice(pipe, keyset, tree, queries, log_dir) -> dict:
    """One traced ``run`` of the slice plus one lookup batch under
    ``torch.profiler``: device time by kernel, the share of the window in
    which the device ran nothing (busy time is the sum of device events,
    which on one stream do not overlap) and the device-to-host copies.
    Then the refresh alone, traced: its wall and its device-to-host bytes,
    which must be the run's Wc bitmap words.  Then the lookup batch alone,
    traced: the device time of the PyTorch gathers left in it (the
    descent's), and the leaf-key gathers it made (none on ``"cuda"``)."""
    from torch.profiler import ProfilerActivity, profile

    pipe._sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipe.run(keyset)
        pipe.backend.lookup(tree, queries)
        pipe._sync()
        wall = time.perf_counter() - t0
    device = device_ms_by_kernel(prof)
    busy_ms = sum(ms for _, ms, _ in device)
    # the refresh alone, from the run's sorted compressed keys and the
    # metadata they were extracted under
    meta_x = dataclasses.replace(res.meta, dbitmap=res.extract_bitmap)
    wc = int(res.comp_sorted.shape[1])
    pipe._sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_r:
        t0 = time.perf_counter()
        refreshed = pipe.refresh_meta(res.comp_sorted, meta_x, keyset.words[0])
        refresh_wall = time.perf_counter() - t0
    check(np.array_equal(refreshed.dbitmap, res.meta.dbitmap),
          "the refresh traced alone gave another D-bitmap than the run's")
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = log_dir if log_dir is not None else Path(tmp)
        trace_dir.mkdir(parents=True, exist_ok=True)
        run_dtoh = dtoh_bytes(prof, trace_dir / "profile_run_trace.json")
        refresh_dtoh = dtoh_bytes(prof_r, trace_dir / "profile_refresh_trace.json")
    check(refresh_dtoh == [wc * 8],
          f"the refresh copied {refresh_dtoh} bytes to the host, not its {wc} bitmap words")
    with leaf_key_gathers() as gathers, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_l:
        t0 = time.perf_counter()
        pipe.backend.lookup(tree, queries)
        pipe._sync()
        lookup_wall = time.perf_counter() - t0
    check(gathers == [], f"the cuda lookup gathered every leaf lane's full key: {gathers}")
    lookup_device = device_ms_by_kernel(prof_l)
    lookup_gathers = [[name[:60], ms, count] for name, ms, count in lookup_device
                      if port_kernel(name) is None
                      and ("gather" in name.lower() or "index" in name.lower())]
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
        (log_dir / "profile_device_ms.txt").write_text("".join(
            f"{ms:12.3f} ms {count:6d}x  {name}\n" for name, ms, count in device))
        (log_dir / "profile_lookup_device_ms.txt").write_text("".join(
            f"{ms:12.3f} ms {count:6d}x  {name}\n" for name, ms, count in lookup_device))
    return {
        "traced_wall_s": wall, "traced_stage_s": res.timings,
        "device_busy_s": busy_ms / 1e3, "idle_share": 1 - busy_ms / 1e3 / wall,
        "dtoh_copies": len(run_dtoh), "dtoh_bytes": sum(run_dtoh),
        "dtoh_largest_bytes": run_dtoh[:6],
        "refresh_traced_wall_s": refresh_wall, "refresh_dtoh_bytes": refresh_dtoh,
        "top_device_ms": [[name[:60], ms, count] for name, ms, count in device[:10]],
        # the port's own kernels (csrc/*.cu, in anonymous namespaces; a
        # template's name starts with its return type)
        "port_kernel_device_ms": {
            port_kernel(name): [ms, count] for name, ms, count in device
            if port_kernel(name) is not None},
        "lookup_traced_wall_s": lookup_wall,
        "lookup_device_busy_s": sum(ms for _, ms, _ in lookup_device) / 1e3,
        "lookup_top_device_ms": [[name[:60], ms, count]
                                 for name, ms, count in lookup_device[:8]],
        "lookup_gather_device_ms": sum(ms for _, ms, _ in lookup_gathers),
        "lookup_gather_kernels": lookup_gathers,
        "lookup_leaf_key_gathers": len(gathers),
    }


def unfused_leaf_stage(stacked, node, queries):
    """The leaf stage with the probe unfused, as the ``"cuda"`` lookups
    ran it before the leaf-stage form: the probe's mask form, then every
    lane's full key gathered, compared, ANDed with the mask and
    ``valid``, and the first match's rid."""
    t = int(node.shape[0])
    cand = probe_many(queries, node, stacked.leaf["dpos"], stacked.leaf["pk"],
                      stacked.config.pk_bits)
    keys = _leaf_keys_many(stacked, node)
    eq = cand & (keys == queries[:, :, None, :]).all(dim=-1) \
        & _tenant_rows(stacked.leaf["valid"], t, node)
    found = eq.any(dim=2)
    e = torch.argmax(eq.to(torch.int8), dim=2)
    rid = torch.gather(_tenant_rows(stacked.leaf["rid"], t, node), 2, e[..., None])[..., 0]
    return found, torch.where(found, rid, torch.full_like(rid, NOT_FOUND_RID))


def leaf_stage_counts(stacked, node, queries) -> dict:
    """What the leaf-stage form needs on these inputs, and the least bytes
    (u32 width) and operations it implies.  A candidate is a valid lane
    whose window matches; the kernel compares candidates' full keys in
    lane order up to the first full match.  Each input is read once: a
    query's node id; of each distinct leaf, every lane's valid and the
    dpos and pk of its valid lanes; of a query with a candidate, all its
    words, of one without, only the words its valid lanes' windows touch;
    the full key of each distinct compared slot and the rid of each
    distinct matching slot.  Found and rid are written per query.  A
    window is about seven integer operations, a word compared two."""
    t, q = (int(x) for x in node.shape)
    w, lc = int(queries.shape[2]), stacked.config.leaf_cap
    dpos_all = stacked.leaf["dpos"]
    valid = _tenant_rows(stacked.leaf["valid"], t, node)
    dpos = _tenant_rows(dpos_all, t, node)
    cand = probe_many_plain(queries, node, dpos_all, stacked.leaf["pk"],
                            stacked.config.pk_bits) & valid
    full = (_leaf_keys_many(stacked, node) == queries[:, :, None, :]).all(dim=-1) & cand
    found = full.any(dim=2)
    lane = torch.arange(lc, device=node.device)
    stop = torch.where(found, torch.argmax(full.to(torch.int8), dim=2), lc - 1)
    compared = cand & (lane <= stop[..., None])
    # (tenant, leaf) and (tenant, leaf, lane) ids, to count each input once
    leaf_id = torch.arange(t, device=node.device)[:, None] * dpos_all.shape[1] + node
    slot_id = leaf_id[..., None] * lc + lane
    leaves, inverse = torch.unique(leaf_id, return_inverse=True)
    leaf_valid = torch.zeros(int(leaves.numel()), lc, dtype=torch.bool, device=node.device)
    leaf_valid[inverse.reshape(-1)] = valid.reshape(-1, lc)
    has_cand = cand.any(dim=2)
    # the query words that the valid windows of candidate-free queries touch
    miss = ~has_cand[..., None] & valid
    wi = (dpos + 1).clamp(0, w * 32 - 1)[miss] // 32
    row = torch.arange(t * q, device=node.device).reshape(t, q, 1).expand(t, q, lc)[miss]
    touched = int(torch.unique(torch.cat([row * w + wi, (row * w + wi + 1)[wi + 1 < w]])).numel())
    keys_read = int(torch.unique(slot_id[compared]).numel())
    rids_read = int(torch.unique(slot_id[full & (lane == stop[..., None])]).numel())
    return {"queries": t * q, "found": int(found.sum()), "distinct_leaves": int(leaves.numel()),
            "full_keys_compared": int(compared.sum()), "distinct_keys_compared": keys_read,
            "full_keys_plain_gathers": t * q * lc,
            "bytes": t * q * 4 + int(leaves.numel()) * lc + int(leaf_valid.sum()) * 2 * 4
            + (int(has_cand.sum()) * w + touched) * 4 + keys_read * 4 * w + rids_read * 4
            + t * q * 5,
            "operations": int(valid.sum()) * 7 + int(compared.sum()) * w * 2}


def dbit_counts(keys: torch.Tensor) -> dict:
    """What the adjacent D-bits of a sorted run need on these keys: a pair
    compares its words up to the first that differs (all of them if the
    keys are equal), so a row is read up to the further of its two pairs'
    first differences; ``past_first_sector`` counts the pairs that differ
    only after the first sector, where the kernel walks on."""
    n, w = (int(x) for x in keys.shape)
    pos = adjacent_dbits_plain(keys).to(torch.int64)
    upto = torch.where(pos == NO_DBIT, w, pos // 32 + 1)
    need = torch.zeros(n, dtype=torch.int64, device=keys.device)
    need[:-1] = upto
    need[1:] = torch.maximum(need[1:], upto)
    return {"rows": n, "key_words": w, "words_compared": int(upto.sum()),
            "words_read": int(need.sum()),
            "past_first_sector": int((upto > SECTOR_WORDS).sum())}


def dbit_cost(counts: dict, form: str) -> tuple[int, int]:
    """(bytes at u32 width, operations) of one dbit form on these counts:
    the words each row needs read once, and one int32 a pair (positions)
    or the W bitmap words written; xor, test and branch a word compared
    and one clz a pair (and one OR, bitmap)."""
    pairs = counts["rows"] - 1
    out = pairs * 4 if form == "positions" else counts["key_words"] * 4
    return (counts["words_read"] * 4 + out,
            3 * counts["words_compared"] + pairs * (1 if form == "positions" else 2))


def dbit_floors(counts: dict, form: str) -> dict:
    """The bytes bound if every word were read (u32 width), and the floor
    if every sector is read at the int64 carrier's width, in ms."""
    n, w = counts["rows"], counts["key_words"]
    out = (n - 1) * 4 if form == "positions" else w * 8
    return {"all_words_bound_ms": (n * w * 4 + out) / PEAK_BYTES_PER_S * 1e3,
            "carrier_floor_ms": (n * w * 8 + out) / PEAK_BYTES_PER_S * 1e3}


def median_wall(fn, reps: int = 5) -> float:
    """Median host wall of ``fn`` in s, each run ended by a synchronize."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def tenant_key_count(n_keys: int) -> int:
    """Keys per tenant of the multitenant phase: a tenth of ``--n-keys``
    (1,000,000 at the default), and above 2^19 so that each tenant's
    rebuild takes the merge ladder."""
    return max((1 << 19) + 1, n_keys // 10)


def tenant_keysets(args, rng) -> dict:
    """Six tenants of exactly :func:`tenant_key_count` Zipf(1.5, 64, 0) keys:
    seeds ``seed+1`` .. ``seed+6``, drawn 5 % over, deduplicated, cut to
    the count by a seeded pick (equal counts give equal tree geometry);
    tenant t's rids are ``t * 2^24 + row``."""
    out = {}
    n = tenant_key_count(args.n_keys)
    for t in range(N_TENANTS):
        zk = zipf_keys(ZipfConfig(1.5, 64, 0, n + n // 20), seed=args.seed + 1 + t)
        check(zk.n >= n, f"tenant {t}: {zk.n} unique keys, fewer than {n}")
        pick = rng.permutation(zk.n)[:n]
        out[t] = KeySet(words=zk.words[pick], lengths=zk.lengths[pick],
                        rids=(np.uint32(t << 24) + np.arange(n, dtype=np.uint32)))
    return out


def multitenant_phase(args, dev, rng, launches: dict) -> dict:
    """Phase 7: six tenants rebuilt and published into one arena, one fused
    ``lookup_many`` and one explicit engine flush (the path, counted from
    0), then the checks against the single-tree lookups and the plain
    backend, then the walls.  Returns what the kernel report needs."""
    t0 = time.perf_counter()
    keysets = tenant_keysets(args, rng)
    data_s = time.perf_counter() - t0
    n_q = TENANT_QUERIES
    batches = [make_queries(keysets[t].words, rng, n_q, keysets[t].rids)
               for t in range(N_TENANTS)]
    q_np = np.stack([qb for qb, _ in batches])
    n_valid = np.full(N_TENANTS, n_q, np.int64)
    n_valid[RAGGED_TENANT] = n_q - 1000
    cuda = get_backend("cuda", device=dev)

    cudalib.reset_launches()
    t0 = time.perf_counter()
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    registry, cells, trees, chunks = TenantRegistry(), {}, {}, []
    for t, ks in keysets.items():
        cells[t] = SnapshotCell()
        res = pipe.run(ks, publish_to=cells[t])
        trees[t] = res.tree
        chunks.append(res.stats["chunked"])
        registry.publish(t, cells[t])
    del res
    rebuild_s = time.perf_counter() - t0
    arena = registry.arena_of(0)
    queries = to_carrier(q_np, dev)
    found, rid = cuda.lookup_many(arena.stacked, queries, n_valid)
    engine = MultiTenantEngine(registry, cuda, auto_dispatch=False)
    answers = {}

    def submit(t):
        answers[t] = engine.submit(t, q_np[t, : n_valid[t]])

    threads = [threading.Thread(target=submit, args=(t,)) for t in range(N_TENANTS)]
    for th in threads:
        th.start()
    deadline = time.perf_counter() + 30
    while engine.stats()["pending"] < N_TENANTS:
        check(time.perf_counter() < deadline and all(th.is_alive() for th in threads),
              f"only {engine.stats()['pending']} of {N_TENANTS} engine requests queued")
        time.sleep(0.001)
    flushed = engine.flush()
    for th in threads:
        th.join(timeout=60)
    check(not any(th.is_alive() for th in threads) and sorted(answers) == list(range(N_TENANTS)),
          f"the engine answered tenants {sorted(answers)} of {N_TENANTS}")
    torch.cuda.synchronize()
    launches["multitenant"] = path_launches()
    check_launches("multitenant", launches["multitenant"])
    eng = engine.stats()
    engine.shutdown()

    check(arena.capacity == 8 and arena.tenants == tuple(range(N_TENANTS))
          and arena.slots == {t: t for t in range(N_TENANTS)}
          and all(registry.arena_of(t) is arena for t in range(N_TENANTS)),
          "the six tenants did not share one arena of capacity 8")
    check(flushed == N_TENANTS and eng["n_dispatches"] == 1 and eng["n_batches"] == 1,
          f"the engine's flush took {eng['n_dispatches']} dispatches, not 1")
    torch_backend = get_backend("torch", device=dev)
    f_ref, r_ref = torch_backend.lookup_many(arena.stacked, queries, n_valid)
    check(same(found, f_ref) and same(rid, r_ref), "lookup_many: cuda != torch backend")
    live = torch.arange(n_q, device=dev)[None, :] < torch.as_tensor(n_valid, device=dev)[:, None]
    q_norm = torch.where(live[..., None], queries, torch.full_like(queries, 0xFFFFFFFF))
    for t in range(N_TENANTS):
        nv = int(n_valid[t])
        f1, r1 = cuda.lookup(trees[t], q_norm[t])
        check(same(found[t], f1) and same(rid[t], r1),
              f"lookup_many tenant {t} != its single-tree lookup")
        check(np.array_equal(to_u32(rid[t, :nv]), batches[t][1][:nv]),
              f"tenant {t}: a lookup_many answer is wrong")
        e_found, e_rid, e_epoch = answers[t]
        check(e_epoch == 0 and np.array_equal(e_found, found[t, :nv].cpu().numpy())
              and np.array_equal(e_rid, to_u32(rid[t, :nv])),
              f"tenant {t}: the engine's answer differs from lookup_many")
    check(not bool(found[RAGGED_TENANT, n_valid[RAGGED_TENANT]:].any()),
          "a dead lane of the ragged tenant found a key")

    fused_s = median_wall(lambda: cuda.lookup_many(arena.stacked, queries, n_valid))
    single_s = [median_wall(lambda t=t: cuda.lookup(trees[t], q_norm[t]))
                for t in range(N_TENANTS)]
    line = {
        "tenants": N_TENANTS, "keys_per_tenant": tenant_key_count(args.n_keys), "key_words": 16,
        "capacity": arena.capacity, "queries_per_tenant": n_q,
        "n_valid": n_valid.tolist(), "data_s": data_s,
        "rebuild_and_publish_s": rebuild_s,
        "chunks_per_rebuild": chunks,
        "stacked_full_gib": arena.stacked.sorted_full.numel() * 8 / 2**30,
        "fused_lookup_many_s": fused_s, "per_tenant_lookup_s": single_s,
        "per_tenant_sum_s": sum(single_s), "engine": eng,
        "probe_many_launches": launches["multitenant"]["probe_many"],
        "launches": launches["multitenant"],
    }
    print(f"[multitenant] {json.dumps(line)}", flush=True)
    print("[multitenant] fused lookup_many == each tenant's single-tree lookup (dead lanes "
          "included) == torch backend; one engine flush, one dispatch", flush=True)
    return {"stacked": arena.stacked, "queries": q_norm,
            "node": _descend_many(arena.stacked, q_norm)}


def check_load(rep: dict, what: str) -> None:
    check(rep["torn_reads"] == 0, f"{what}: {rep['torn_reads']} torn reads")
    check(rep["stale_epochs"] == 0, f"{what}: {rep['stale_epochs']} stale epochs")
    check(rep["errors"] == [], f"{what}: errors {rep['errors']}")
    served = rep["served_per_tenant"]
    check(sorted(served) == list(range(rep["n_tenants"])) and min(served.values()) > 0,
          f"{what}: a tenant was starved ({served})")
    check(rep["epochs_published"] > 8, f"{what}: {rep['epochs_published']} epochs published")


def mt_load_phase(args, dev, launches: dict) -> None:
    """Phase 8: the closed-loop multi-tenant harness without the SLO, then
    with it at 4x the first run's unloaded p50 (the path, counted from 0
    over both)."""
    opts = dict(backend="cuda", device=dev, n_tenants=8, n_keys=1 << 17, n_words=4,
                batch=1024, n_readers=8, mutation_batch=1024, duration_s=5.0,
                seed=args.seed)
    cudalib.reset_launches()
    plain = run_multitenant_load(**opts)
    check_load(plain, "mt_load")
    slo = run_multitenant_load(**opts, target_p99_us=4 * plain["unloaded_p50_us"])
    check_load(slo, "mt_load with SLO")
    launches["mt_load"] = path_launches()
    check_launches("mt_load", launches["mt_load"])
    print(f"[mt_load] {json.dumps(plain)}", flush=True)
    print(f"[mt_load] slo {json.dumps(slo)}", flush=True)
    print(f"[mt_load] launches {json.dumps(launches['mt_load'])}; no torn read, no stale "
          "epoch, no error, every tenant served, with and without the SLO", flush=True)


# ---------------------------------------------------------------------------
# phases 9-10: the online index and batched reconstruction
# ---------------------------------------------------------------------------

def new_bit_keys(words: np.ndarray, rng, count: int) -> np.ndarray:
    """``count`` fresh keys that each set a distinction bit no base key
    has: a sampled base key with the top bit of one of its last bytes set
    (the generator emits only 'a'..'z', so that bit is 0 in every key and
    the key's neighbor differs from it first there)."""
    keys = words[rng.choice(words.shape[0], count, replace=False)].copy()
    for j in range(count):
        byte = j % 4
        keys[j, -1 - j // 4] |= np.uint32(0x80 << (8 * byte))
    return keys


def mutate_online(oi, oi_t, ops, what: str) -> tuple[list, list]:
    """Apply ``ops`` (``("insert", key, rid)`` or ``("delete", key)``) to the
    ``"cuda"`` index ``oi`` and its ``"torch"`` twin, the meta compared
    after every mutation; the µs of each insert and delete on ``oi``."""
    ins_us, del_us = [], []
    for op in ops:
        t1 = time.perf_counter()
        if op[0] == "insert":
            oi.insert(op[1], op[2])
            ins_us.append((time.perf_counter() - t1) * 1e6)
            oi_t.insert(op[1], op[2])
        else:
            ok = oi.delete(op[1])
            del_us.append((time.perf_counter() - t1) * 1e6)
            check(ok and oi_t.delete(op[1]), f"{what}: a delete found no key")
        for field in ("dbitmap", "varbitmap", "refkey"):
            check(np.array_equal(getattr(oi.meta, field), getattr(oi_t.meta, field)),
                  f"{what}: {op[0]} left the cuda meta.{field} != torch's")
    return ins_us, del_us


def us_stats(us: list) -> dict:
    return {"median": float(np.median(us)), "p90": float(np.percentile(us, 90)), "n": len(us)}


def timed_rebuild(oi, oi_t, dev, acc: dict, what: str) -> tuple:
    """One ``rebuild`` of ``oi`` (its wall, its launches counted into
    ``acc``), held against a full ``run`` over the folded set under the
    same meta (its bitmap pinned, as ``rebuild`` pins it) and against the
    ``"torch"`` twin's rebuild, byte for byte."""
    keep, delta = oi.log.fold_keyset(oi.keyset)
    folded = fold_keyset(oi.keyset, keep, delta)
    meta_before = oi.meta
    torch.cuda.synchronize()
    with counted(acc):
        t1 = time.perf_counter()
        oi2 = oi.rebuild()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    check(np.array_equal(oi2.keyset.words, folded.words)
          and np.array_equal(oi2.keyset.rids, folded.rids), f"{what}: another keyset folded")
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    pipe.run(folded, meta=meta_before)
    t1 = time.perf_counter()
    full = pipe.run(folded, meta=meta_before)
    full_wall = time.perf_counter() - t1
    full.meta = dataclasses.replace(full.meta, dbitmap=full.extract_bitmap.copy())
    results_equal(oi2.result, full, f"{what} vs a full run over the folded set")
    del full
    oi2_t = oi_t.rebuild()
    results_equal(oi2.result, oi2_t.result, f"{what}, cuda vs torch")
    st = oi2.result.stats
    line = {"n_keys": st["n_keys"], "merged": bool(st["incremental"]),
            "fallback": st.get("incremental_fallback"), "wall_s": wall,
            "full_run_wall_s": full_wall,
            "timings_s": {k: v for k, v in oi2.result.timings.items()},
            "epoch": oi2.snapshots.epoch}
    return oi2, oi2_t, line


def online_phase(args, dev, rng, keyset, res, res_torch, launches: dict) -> dict:
    """Phase 9: the slice's index taken online on ``"cuda"`` beside a
    ``"torch"`` twin given the same mutations, the meta compared after
    each.  Round 1: 1,000 fresh inserts (ten of them set a new
    distinction bit), 900 base and 100 delta deletes, one ``search_batch``
    of 2^18 queries with the overlay (and one before any mutation,
    without it), single ``search`` calls, then a rebuild that falls back
    to the full resort; a reader pinned on the old epoch keeps its
    answers.  Round 2: 200 base deletes and re-inserts of 100 of those
    keys, which set no new bit, then a rebuild that merges the delta.  The
    path is counted from 0 over both rounds."""
    n, w = keyset.n, keyset.n_words
    t0 = time.perf_counter()
    dk = zipf_keys(ZipfConfig(1.5, 64, 0, 4 * ONLINE_INSERTS), seed=args.seed + 21)
    fresh = np.flatnonzero(~rows_in(dk.words, keyset.words))
    n_zipf = ONLINE_INSERTS - ONLINE_NEW_BITS
    check(fresh.size >= n_zipf, f"only {fresh.size} fresh keys for the online inserts")
    ins_words = np.concatenate([dk.words[fresh[rng.permutation(fresh.size)[:n_zipf]]],
                                new_bit_keys(keyset.words, rng, ONLINE_NEW_BITS)])
    ins_rids = np.arange(n, n + ONLINE_INSERTS, dtype=np.uint32)
    del_rows = rng.choice(n, ONLINE_BASE_DELETES, replace=False)
    del_ins = rng.choice(ONLINE_INSERTS, ONLINE_DELTA_DELETES, replace=False)
    data_s = time.perf_counter() - t0

    # each index wraps a shallow copy: inserts replace the copy's meta,
    # and the kernel report still reads phase 3's result
    oi = OnlineIndex(keyset=keyset, result=dataclasses.replace(res), device=dev)
    oi_t = OnlineIndex(keyset=keyset, result=dataclasses.replace(res_torch), backend="torch",
                       device=dev)
    q_np, expect = make_queries(keyset.words, rng)
    # the mutated keys take the first lanes: live inserts hit, deleted
    # inserts and deleted base keys miss
    k_ins, k_del = ONLINE_INSERTS, ONLINE_BASE_DELETES
    q_np[:k_ins] = ins_words
    expect[:k_ins] = ins_rids
    expect[del_ins] = NOT_FOUND_RID
    q_np[k_ins:k_ins + k_del] = keyset.words[del_rows]
    expect[k_ins:k_ins + k_del] = NOT_FOUND_RID
    deleted = np.zeros(n, bool)
    deleted[del_rows] = True
    base_hits = np.flatnonzero(expect != NOT_FOUND_RID)
    base_hits = base_hits[base_hits >= k_ins + k_del]
    expect[base_hits[deleted[expect[base_hits]]]] = NOT_FOUND_RID  # sampled a deleted row
    found0, rid0 = oi.search_batch(q_np)
    plain_search_s = median_wall(lambda: oi.search_batch(q_np), reps=3)
    f0_t, r0_t = oi_t.search_batch(q_np)
    check(np.array_equal(found0, f0_t) and np.array_equal(rid0, r0_t),
          "online search_batch before the mutations: cuda != torch")
    t1 = time.perf_counter()
    oi._neighbor_view()
    view_s = time.perf_counter() - t1
    oi_t._neighbor_view()

    acc: dict = {}  # the path's launches (the torch twin makes none)
    dbits_before = int(oi.meta.n_dbits)
    ops = [("insert", k, int(r)) for k, r in zip(ins_words, ins_rids)]
    deletes = [keyset.words[r] for r in del_rows] + [ins_words[i] for i in del_ins]
    ops += [("delete", deletes[i]) for i in rng.permutation(len(deletes))]
    with counted(acc):
        ins_us, del_us = mutate_online(oi, oi_t, ops, "online round 1")
        found, rid = oi.search_batch(q_np)
        overlay_search_s = median_wall(lambda: oi.search_batch(q_np), reps=3)
    check(oi.meta.n_dbits > dbits_before, "no online insert set a new distinction bit")
    f_t, r_t = oi_t.search_batch(q_np)
    check(np.array_equal(found, f_t) and np.array_equal(rid, r_t),
          "online search_batch: cuda != torch")
    check(np.array_equal(found, expect != NOT_FOUND_RID), "an online search found the wrong keys")
    check(np.array_equal(rid[found], expect[found]), "an online search returned a wrong rid")
    with counted(acc):
        singles = [(i, oi.search(q_np[i])) for i in rng.choice(BATCH, 64, replace=False)]
        # a delete's cost is its one-query search: that search alone, and
        # the backend's lookup of one query alone
        one = q_np[k_ins + k_del : k_ins + k_del + 1]
        search_1_s = median_wall(lambda: oi.search(one[0]), reps=21)
        lookup_1_s = median_wall(lambda: oi._backend_obj().lookup(
            oi._snapshot.tree, to_carrier(one, dev)), reps=21)
    for i, got in singles:
        check(got == (bool(found[i]), int(rid[i])), "search differs from its row of search_batch")
    keep, delta = oi.log.fold_keyset(keyset)
    exact = meta_from_keys(fold_keyset(keyset, keep, delta).words, dev,
                           dbitmap_fn=adjacent_dbitmap)
    check(not (exact.dbitmap & ~oi.meta.dbitmap).any(),
          "the online meta is not a superset of the folded set's D-bitmap")
    host_bytes = {"neighbor_view": int(oi._neighbor_view().nbytes),
                  "delta": int(oi._delta.nbytes)}

    # rebuild 1 (a new bit: the full resort); a reader pinned on epoch 0
    pinned = oi.snapshots.acquire()
    gone = to_carrier(keyset.words[del_rows[:256]], dev)
    oi2, oi2_t, rebuild_fallback = timed_rebuild(oi, oi_t, dev, acc, "online rebuild 1")
    check(not rebuild_fallback["merged"] and rebuild_fallback["fallback"] == "dbitmap_changed",
          f"online rebuild 1 took {rebuild_fallback}")
    f_old, r_old = pinned.lookup(oi._backend_obj(), gone)
    check(bool(f_old.all()) and np.array_equal(to_u32(r_old), del_rows[:256].astype(np.uint32)),
          "a reader pinned on the old epoch lost its pre-rebuild answers")
    oi.snapshots.release(pinned)
    check(oi._snapshot.epoch == 0 and oi2._snapshot.epoch == 1, "the epochs did not advance")
    f_pre, r_pre = oi.search_batch(q_np)
    check(np.array_equal(f_pre, found) and np.array_equal(r_pre, rid),
          "the pre-rebuild index answers differently after the rebuild")
    f2, r2 = oi2.search_batch(q_np)
    check(np.array_equal(f2, found) and np.array_equal(r2[f2], rid[found]),
          "the rebuilt index answers differently")
    del oi, oi_t

    # round 2: base deletes and re-inserts of deleted keys set no bit, so
    # the rebuild merges
    back = rng.choice(oi2.keyset.n, 2 * ONLINE_REINSERTS, replace=False)
    back_words = oi2.keyset.words[back]
    ops = [("delete", k) for k in back_words]
    ops += [("insert", k, int(n + ONLINE_INSERTS + j))
            for j, k in enumerate(back_words[:ONLINE_REINSERTS])]
    dbits_round2 = int(oi2.meta.n_dbits)
    with counted(acc):
        ins2_us, del2_us = mutate_online(oi2, oi2_t, ops, "online round 2")
    check(oi2.meta.n_dbits == dbits_round2, "a re-insert set a new distinction bit")
    oi3, _, rebuild_merged = timed_rebuild(oi2, oi2_t, dev, acc, "online rebuild 2")
    check(rebuild_merged["merged"], f"online rebuild 2 took {rebuild_merged}")
    launches["online"] = acc
    check_launches("online", launches["online"])
    f3, r3 = oi3.search_batch(back_words)
    check(bool(f3[:ONLINE_REINSERTS].all()) and not f3[ONLINE_REINSERTS:].any()
          and np.array_equal(r3[:ONLINE_REINSERTS],
                             n + ONLINE_INSERTS + np.arange(ONLINE_REINSERTS)),
          "the second rebuild answers the re-inserted keys wrong")
    line = {
        "n_base": n, "inserts": ONLINE_INSERTS, "new_bit_inserts": ONLINE_NEW_BITS,
        "base_deletes": ONLINE_BASE_DELETES, "delta_deletes": ONLINE_DELTA_DELETES,
        "round2_deletes": 2 * ONLINE_REINSERTS, "round2_reinserts": ONLINE_REINSERTS,
        "data_s": data_s, "insert_us": us_stats(ins_us), "delete_us": us_stats(del_us),
        "round2_insert_us": us_stats(ins2_us), "round2_delete_us": us_stats(del2_us),
        "search_1_us_median": search_1_s * 1e6, "lookup_1_us_median": lookup_1_s * 1e6,
        "search_batch_queries": BATCH, "search_batch_s_no_overlay": plain_search_s,
        "search_batch_s_overlay": overlay_search_s,
        "dbits_built": dbits_before, "dbits_online": dbits_round2,
        "dbits_exact": int(exact.n_dbits),
        "rebuild_fallback": rebuild_fallback, "rebuild_merged": rebuild_merged,
        "neighbor_view_build_s": view_s, "host_bytes": host_bytes,
        "launches": launches["online"],
    }
    print(f"[online] {json.dumps(line)}", flush=True)
    print("[online] meta after every mutation == torch; search_batch == expected == torch; "
          "meta a superset of the folded set's; both rebuilds (full resort, merge) == a full "
          "run over the folded set == torch; the pinned epoch keeps its answers", flush=True)
    return line


def many_sets(args, rng) -> list:
    """The replication scenario's key sets: disjoint parts of one
    Zipf(1.5, 64, 0) draw (seed ``seed+11``), four at drifting sizes
    inside one bucket (2.09M down to 2.0M keys at the default
    ``--n-keys``, scaled down with it) and a fifth of another bucket."""
    scale = min(1.0, args.n_keys / FULL_N_KEYS)
    sizes = [int(s * scale) for s in MANY_SIZES] + [int(MANY_OTHER * scale)]
    zk = zipf_keys(ZipfConfig(1.5, 64, 0, sum(sizes) * 21 // 20), seed=args.seed + 11)
    check(zk.n >= sum(sizes), f"run_many: {zk.n} unique keys, fewer than {sum(sizes)}")
    perm = rng.permutation(zk.n)
    sets, at = [], 0
    for size in sizes:
        pick = perm[at : at + size]
        at += size
        sets.append(KeySet(words=zk.words[pick], lengths=zk.lengths[pick],
                           rids=np.arange(size, dtype=np.uint32)))
    return sets


def run_many_phase(args, dev, rng, launches: dict) -> dict:
    """Phase 10: ``run_many`` on ``"cuda"`` over four same-bucket key sets
    that share one DS-metadata, as replicas of one index do (one group: a
    pext per member, one bitonic launch over the stack), and one of
    another bucket with no metadata given (``meta_from_keys``, then
    ``run``); the path counted from 0.  Each member == its single
    ``"cuda"`` run == the ``"torch"`` backend's ``run_many``; the batched
    wall beside the single runs'."""
    t0 = time.perf_counter()
    sets = many_sets(args, rng)
    group = len(MANY_SIZES)
    # the group's members alone would not always compress to one width
    # (about 96 D-bits each at 2M keys); their union's metadata does
    union = meta_from_keys(np.concatenate([ks.words for ks in sets[:group]]), dev,
                           dbitmap_fn=adjacent_dbitmap)
    metas = [union] * group + [None]
    data_s = time.perf_counter() - t0
    b = plancache.bucket_for("run_many", sets[0].n)
    check(all(plancache.bucket_for("run_many", ks.n) == b for ks in sets[:group])
          and plancache.bucket_for("run_many", sets[-1].n) != b,
          "run_many: the sizes do not make one group and one other shape")
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    pipe.run_many(sets, metas)  # allocator warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    cudalib.reset_launches()
    with stacked_sort_call() as stacked:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipe.run_many(sets, metas)
        torch.cuda.synchronize()
        many_wall = time.perf_counter() - t1
    launches["run_many"] = path_launches()
    check_launches("run_many", launches["run_many"])
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check([r.stats.get("batched") for r in out] == [group] * group + [None],
          f"run_many grouped {[r.stats.get('batched') for r in out]}")
    # the other shape alone, as run_many runs it: its own launches
    cudalib.reset_launches()
    pipe.run_many(sets[-1:])
    alone = path_launches()
    lm = launches["run_many"]
    check(lm["pext"] - alone["pext"] == group
          and lm["bitonic_block_sort"] - alone["bitonic_block_sort"] == 1,
          f"the batched group launched pext {lm['pext'] - alone['pext']} and bitonic "
          f"{lm['bitonic_block_sort'] - alone['bitonic_block_sort']} times")
    single_s, unchunked_s = [], []
    flat = ReconstructionPipeline(backend="cuda", device=dev, chunk_threshold=1 << 24)
    for ks, meta, got in zip(sets, metas, out):
        pipe.run(ks, meta=meta)
        t1 = time.perf_counter()
        single = pipe.run(ks, meta=meta)
        single_s.append(time.perf_counter() - t1)
        results_equal(got, single, "run_many member vs its single run")
        flat.run(ks, meta=meta)
        t1 = time.perf_counter()
        flat.run(ks, meta=meta)
        unchunked_s.append(time.perf_counter() - t1)
    del single
    want = ReconstructionPipeline(backend="torch", device=dev).run_many(sets, metas)
    for got, ref in zip(out, want):
        results_equal(got, ref, "run_many, cuda vs torch")
    del want
    line = {
        "members": len(sets), "sizes": [ks.n for ks in sets], "key_words": sets[0].n_words,
        "comp_words": [r.stats["comp_sort_key_words"] - 1 for r in out],
        "bucket": b, "other_bucket": plancache.bucket_for("run_many", sets[-1].n),
        "data_s": data_s,
        "stacked_full_gib": group * b * sets[0].n_words * 8 / 2**30,
        "run_many_wall_s": many_wall, "single_runs_s": single_s,
        "single_runs_sum_s": sum(single_s), "single_unchunked_runs_s": unchunked_s,
        "single_unchunked_sum_s": sum(unchunked_s),
        "batched_extract_sort_s": out[0].timings["sort"] * group,
        "stacked_sort_rows": int(stacked["args"][0].shape[0]),
        "peak_mem_gib": peak_gib, "launches": launches["run_many"],
        "other_shape_launches": alone,
    }
    print(f"[run_many] {json.dumps(line)}", flush=True)
    print(f"[run_many] each member == its single run == torch run_many; the group of "
          f"{group}: pext {group} times, bitonic once", flush=True)
    return {"line": line, "stacked": stacked, "sizes": [ks.n for ks in sets[:group]]}


# ---------------------------------------------------------------------------
# phase 11: replication and index recovery
# ---------------------------------------------------------------------------

@contextmanager
def apply_log():
    """Record every ``Replica.apply`` made inside the block: the replica,
    its wall (ended by a synchronize) and its path."""
    seen: list = []
    orig = replica_mod.Replica.apply

    def spy(self, log):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = orig(self, log)
        torch.cuda.synchronize()
        path = "noop" if st["noop"] else st["fallback"] or "incremental"
        seen.append((self, {"wall_s": time.perf_counter() - t1, "path": path,
                            "n_delta": st["n_delta"], "n_deleted": st["n_deleted"],
                            "applied_lsn": st["applied_lsn"],
                            "timings_s": {k: st["timings"].get(k, 0.0)
                                          for k in ("filter", "extract", "sort", "merge",
                                                    "build", "refresh_meta", "total")}}))
        return st

    replica_mod.Replica.apply = spy
    try:
        yield seen
    finally:
        replica_mod.Replica.apply = orig


def replicas_equal(got, want, what: str) -> None:
    """Byte identity of two replicas: keyset, working meta, watermark, and
    the standing result (sorted run, permutations, tree, refreshed meta)."""
    for name in ("words", "rids", "lengths"):
        check(np.array_equal(getattr(got.keyset, name), getattr(want.keyset, name)),
              f"{what}: keyset.{name} differs")
    for field in ("dbitmap", "varbitmap", "refkey"):
        check(np.array_equal(getattr(got.meta, field), getattr(want.meta, field)),
              f"{what}: meta.{field} differs")
    check(got.applied_lsn == want.applied_lsn,
          f"{what}: applied_lsn {got.applied_lsn} != {want.applied_lsn}")
    results_equal(got.result, want.result, what)


def dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def replication_phase(args, dev, rng, keyset, launches: dict) -> dict:
    """Phase 11: phase 3's keys as the base table of a ``StreamPrimary``
    on ``"cuda"`` over a ``DirectoryTransport`` (frames fsynced on disk)
    with bounded lag 2, so it checkpoints with truncation after batches 2
    and 5 (a full step, then a delta step chained onto it).  Six batches
    of 10,000 fresh Zipf inserts (seed ``seed+31``) and 10,000 deletes of
    live rids; batch 4 also inserts ten new-bit keys (the fallback
    resort).  A ``"cuda"`` tail and a ``"torch"`` tail poll after every
    batch; a ``"cuda"`` lagger first polls after batch 6, finds its start
    truncated, bootstraps from the checkpoint at the stream's start and
    drains the rest frame by frame.  The path (publishes, polls, the
    lagger's recovery, the batch lookups and the restore of step 2) is
    counted from 0.  Then one chaos soak on ``"cuda"`` over a directory
    spool."""
    n = keyset.n
    t0 = time.perf_counter()
    need = REPL_BATCHES * REPL_INSERTS
    dk = zipf_keys(ZipfConfig(1.5, 64, 0, 6 * need), seed=args.seed + 31)
    fresh = np.flatnonzero(~rows_in(dk.words, keyset.words))
    check(fresh.size >= need, f"only {fresh.size} fresh keys for {need} replication inserts")
    ins_words = dk.words[fresh[rng.permutation(fresh.size)[:need]]]
    new_bits = new_bit_keys(keyset.words, rng, ONLINE_NEW_BITS)
    del dk, fresh
    data_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    acc: dict = {}
    walls: dict = {"checkpoint_s": []}
    with (tempfile.TemporaryDirectory(prefix="repro_replication_") as tmp,
          apply_log() as applies, largest_insert_rank() as ins_rank):
        root = Path(tmp)
        with counted(acc):
            t1 = time.perf_counter()
            prim = StreamPrimary(DirectoryTransport(root / "spool"), keyset, backend="cuda",
                                 device=dev, ckpt_dir=str(root / "ckpt"),
                                 max_lag_batches=REPL_MAX_LAG)
            walls["primary_bring_up_s"] = time.perf_counter() - t1
        orig_ckpt = prim.checkpoint

        def timed_checkpoint(truncate=False):
            t1 = time.perf_counter()
            man = orig_ckpt(truncate=truncate)
            walls["checkpoint_s"].append(time.perf_counter() - t1)
            return man

        prim.checkpoint = timed_checkpoint
        tail = StreamReplica(DirectoryTransport(root / "spool"), backend="cuda", device=dev)
        twin = StreamReplica(DirectoryTransport(root / "spool"), backend="torch", device=dev)
        lagger = StreamReplica(DirectoryTransport(root / "spool"), backend="cuda", device=dev)
        t1 = time.perf_counter()
        with counted(acc):
            tail.poll()
        walls["tail_bring_up_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        twin.poll()
        walls["torch_tail_bring_up_s"] = time.perf_counter() - t1
        step2 = None
        next_rid = n
        for b in range(1, REPL_BATCHES + 1):
            cur = prim.replica.keyset
            log = ChangeLog(keyset.n_words, start_lsn=prim.next_lsn)
            words = ins_words[(b - 1) * REPL_INSERTS : b * REPL_INSERTS]
            if b == REPL_NEW_BIT_BATCH:
                words = np.concatenate([words, new_bits])
            log.append_inserts(words, np.arange(next_rid, next_rid + words.shape[0]))
            next_rid += words.shape[0]
            log.append_deletes(rng.choice(cur.rids, REPL_DELETES, replace=False))
            with counted(acc):
                prim.publish(log)
                tail.poll()
            twin.poll()
            if prim.stats["ckpt_step"] == 2 and step2 is None:
                step2 = (prim.replica.keyset, prim.replica.meta, prim.replica.applied_lsn)
        check(prim.stats["ckpt_step"] == 2 and step2 is not None,
              f"the primary checkpointed {prim.stats['ckpt_step']} times, not twice")
        ckpt_bytes = {p.name: dir_bytes(p) for p in sorted((root / "ckpt").iterdir())}
        spool_bytes = dir_bytes(root / "spool")
        first_pos = DirectoryTransport(root / "spool").first_pos()
        check(first_pos > 0, "the spool was never truncated")

        # the lagger: truncated past, it recovers from the checkpoint
        t1 = time.perf_counter()
        with counted(acc):
            st = lagger.poll(max_frames=1)
            walls["lagger_bootstrap_poll_s"] = time.perf_counter() - t1
            check(st["catchup"] and st["truncated_jump"], f"the lagger did not catch up: {st}")
            polls = 1
            t1 = time.perf_counter()
            while lagger.lag_frames():
                lagger.poll(max_frames=1)
                polls += 1
            walls["lagger_drain_s"] = time.perf_counter() - t1
        walls["lagger_bootstrap"] = lagger.last_bootstrap
        check(lagger.stats["n_catchups"] == 1 and tail.stats["n_catchups"] == 0
              and twin.stats["n_catchups"] == 0, "a replica took the wrong recovery path")

        # byte identity: tail == lagger == primary, cuda tail == torch tail
        replicas_equal(tail.replica, prim.replica, "cuda tail vs primary")
        replicas_equal(lagger.replica, prim.replica, "lagger vs primary")
        replicas_equal(tail.replica, twin.replica, "cuda tail vs torch tail")
        pipe = ReconstructionPipeline(backend="cuda", device=dev)
        for what, rep in (("primary", prim.replica), ("cuda tail", tail.replica),
                          ("torch tail", twin.replica), ("lagger", lagger.replica)):
            full = pipe.run(rep.keyset, meta=rep.meta)
            results_equal(rep.result, full, f"{what} vs a full cuda run over its keyset")
        del full

        # one 2^18-query batch, half hits and half misses, on every replica
        live = prim.replica.keyset
        q_np, expect = make_queries(live.words, rng, rids=live.rids)
        answers = {}
        with counted(acc):
            for what, rep in (("primary", prim.replica), ("cuda tail", tail),
                              ("lagger", lagger)):
                answers[what] = rep.search_batch(q_np)
        answers["torch tail"] = twin.search_batch(q_np)
        for what, (found, rid) in answers.items():
            check(np.array_equal(found, expect != NOT_FOUND_RID) and np.array_equal(rid, expect),
                  f"replication: the {what} answers a lookup wrong")

        # index recovery straight from the chain: step 2 (a delta step)
        t1 = time.perf_counter()
        with counted(acc):
            state, rst = restore_checkpoint(root / "ckpt", 2, _state_like(), backend="cuda",
                                            index_device=dev)
        restore_s = time.perf_counter() - t1
        s_keyset, s_meta, s_lsn = step2
        check(np.array_equal(state["keyset"]["words"], s_keyset.words)
              and np.array_equal(state["keyset"]["rids"], s_keyset.rids)
              and np.array_equal(state["keyset"]["lengths"], s_keyset.lengths)
              and np.array_equal(state["meta"]["dbitmap"], s_meta.dbitmap)
              and np.array_equal(state["meta"]["varbitmap"], s_meta.varbitmap)
              and rst["meta"]["applied_lsn"] == s_lsn,
              "restore_checkpoint of step 2 differs from the primary's state there")
        launches["replication"] = acc
        check_launches("replication", acc)
        # the insert rule's largest kernel rank (unsorted queries, row 0,
        # against the standing run) against the plain search on the same tensors
        check("args" in ins_rank, "the insert rule never ranked through the merge-rank kernel")
        kq, rq, ks, rs = ins_rank["args"]
        check(torch.equal(ins_rank["out"].to(torch.int64),
                          merge_ranks_plain(kq, rq, ks, rs).to(torch.int64)),
              "the insert rule's merge-rank call differs from merge_ranks_plain")
        ins_rank_line = {"calls": ins_rank["calls"], "queries": int(kq.shape[0]),
                         "searched": int(ks.shape[0]), "equal_to_plain": True}
        del kq, rq, ks, rs
        ins_rank.clear()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        by_rep = {id(prim.replica): "primary", id(tail.replica): "cuda_tail",
                  id(twin.replica): "torch_tail", id(lagger.replica): "lagger"}
        apply_lines = [{"replica": by_rep.get(id(r), "other"), **line} for r, line in applies]
        paths = {name: [a["path"] for a in apply_lines if a["replica"] == name]
                 for name in ("primary", "cuda_tail", "torch_tail", "lagger")}
        # the new-bit batch always falls back; at full size every other
        # batch is incremental, while a base cut by a smaller --n-keys is
        # sparse enough that fresh keys may set new bits too
        check(paths["primary"] == paths["cuda_tail"] == paths["torch_tail"]
              and paths["lagger"] == paths["primary"][REPL_MAX_LAG:]
              and paths["primary"][REPL_NEW_BIT_BATCH - 1] == "dbitmap_changed"
              and "incremental" in paths["primary"],
              f"the replicas took other apply paths: {paths}")
        if args.n_keys >= FULL_N_KEYS:
            want = ["incremental"] * REPL_BATCHES
            want[REPL_NEW_BIT_BATCH - 1] = "dbitmap_changed"
            check(paths["primary"] == want,
                  f"at full size the primary took {paths['primary']}, not {want}")
        del state, answers
        tail_stats, lagger_stats = tail.stats, lagger.stats
        del prim, tail, twin, lagger, pipe

    # one chaos soak on the card over a directory spool
    t1 = time.perf_counter()
    soak = run_soak(args.seed, "dir", "cuda", steps=8, n_replicas=2, device=dev)
    soak_s = time.perf_counter() - t1
    check(soak["violations"] == [], f"the chaos soak failed: {soak['violations']}")
    line = {
        "n_base": n, "batches": REPL_BATCHES, "inserts_per_batch": REPL_INSERTS,
        "deletes_per_batch": REPL_DELETES, "new_bit_inserts": ONLINE_NEW_BITS,
        "data_s": data_s, "walls_s": walls, "applies": apply_lines,
        "restore_step2_s": restore_s, "restore_step2_incremental": rst["incremental"],
        "restore_step2_index_rebuild_s": rst["index_rebuild_s"],
        "ckpt_bytes_by_step": ckpt_bytes, "spool_bytes_at_end": spool_bytes,
        "lagger_polls": polls, "lagger_stats": lagger_stats, "tail_stats": tail_stats,
        "insert_rule_rank": ins_rank_line,
        "peak_mem_gib": peak_gib,
        "soak": {"wall_s": soak_s, "faults": soak["faults_injected"],
                 "survivors": soak["survivors"]},
        "launches": acc, "card": card_line(),
    }
    print(f"[replication] {json.dumps(line)}", flush=True)
    print("[replication] cuda tail == lagger (bootstrapped from the checkpoint) == primary; "
          "cuda tail == torch tail; each == a full cuda run over its keyset; the 2^18 batch "
          "answers alike; step 2 restores the primary's state; the soak kept every "
          "invariant", flush=True)
    return line


# ---------------------------------------------------------------------------
# phases 12-13: serving under rebuilds (run_load) and the page table
# ---------------------------------------------------------------------------


@contextmanager
def first_incremental():
    """Record the first ``ReconstructionPipeline.run_incremental`` call made
    inside the block: its pipeline, arguments and result.  The call itself
    runs unchanged."""
    seen: dict = {}
    orig = ReconstructionPipeline.run_incremental

    def spy(self, prev, base_keyset, delta_keyset=None, **kw):
        out = orig(self, prev, base_keyset, delta_keyset, **kw)
        if not seen:
            seen.update(args=(prev, base_keyset, delta_keyset), kw=kw, out=out)
        return out

    ReconstructionPipeline.run_incremental = spy
    try:
        yield seen
    finally:
        ReconstructionPipeline.run_incremental = orig


def check_run_load(rep, what: str) -> None:
    check(rep.errors == [], f"{what}: errors {rep.errors}")
    check(rep.torn_reads == 0, f"{what}: {rep.torn_reads} torn reads")
    check(rep.stale_epochs == 0, f"{what}: {rep.stale_epochs} stale epochs")
    check(rep.epochs_published >= 3, f"{what}: {rep.epochs_published} epochs published")
    st = rep.cell_stats
    check(st["acquires"] == st["releases"] and st["pinned"] == 0,
          f"{what}: {st['acquires']} acquires, {st['releases']} releases")


def load_phase(args, dev, launches: dict) -> None:
    """Phase 12: ``run_load`` on ``"cuda"`` at the reference bench's key
    shape (two words) with 2^22 draws: 8 readers, probe batches of 256,
    mutation batches of 1,024, 5 s; then again at the reference's
    admission point (a writer owing a cycle every 1 ms, lag bound 1,
    shed).  The path (both runs) is counted from 0.  The writer's first
    incremental result, made before the reader threads start, equals a
    full ``"cuda"`` run over its folded keyset and the ``"torch"``
    backend's ``run_incremental`` on the same inputs."""
    t_phase = time.perf_counter()
    n_draws = min(LOAD_N_KEYS, args.n_keys)
    opts = dict(backend="cuda", device=dev, n_keys=n_draws, n_words=2, batch=256,
                n_readers=8, mutation_batch=1024, duration_s=5.0, seed=args.seed)
    acc = launches.setdefault("load", {})
    t0 = time.perf_counter()
    with first_incremental() as first, counted(acc):
        plain = run_load(**opts)
    plain_wall = time.perf_counter() - t0
    check_run_load(plain, "load")
    check(plain.cell_stats["max_concurrent_pins"] >= 2, "load: never two readers pinned at once")
    (prev, base, delta), kw = first["args"], first["kw"]
    inc, folded = first["out"]
    check(inc.stats["incremental"] is True, "load: the writer's first cycle fell back")
    results_equal(inc, ReconstructionPipeline(backend="cuda", device=dev).run(
        folded, meta=kw["meta"]), "load: first incremental vs a full run over the folded set")
    results_equal(inc, ReconstructionPipeline(backend="torch", device=dev).run_incremental(
        prev, base, delta, keep_rows=kw["keep_rows"], meta=kw["meta"])[0],
        "load: first incremental, cuda vs torch")
    n_keys = base.n
    del first, prev, base, delta, inc, folded, kw
    t0 = time.perf_counter()
    with counted(acc):
        shed = run_load(**opts, target_mutation_period_s=0.001, max_lag_epochs=1,
                        admission="shed")
    shed_wall = time.perf_counter() - t0
    check_run_load(shed, "load at the admission point")
    check(shed.n_shed > 0 and shed.cell_stats["shed"] == shed.n_shed,
          f"load at the admission point: {shed.n_shed} sheds, "
          f"{shed.cell_stats['shed']} in the cell")
    check_launches("load", acc)
    head = {"n_keys": n_keys, "draws": n_draws, "phase_s": time.perf_counter() - t_phase,
            "wall_s": plain_wall}
    print(f"[load] {json.dumps({**head, **plain.to_row()})}", flush=True)
    print(f"[load] admission {json.dumps({'wall_s': shed_wall, **shed.to_row()})}", flush=True)
    print(f"[load] launches {json.dumps(acc)}; the first incremental == a full cuda run == "
          "torch; no torn read, no stale epoch, no error in either run; the admission "
          f"point shed; {card_line()}", flush=True)


def pagers_equal(got, want, what: str) -> None:
    """Two pagers agree: table (in insertion order), free list, working
    meta, last rebuild and, byte for byte, the built index."""
    check(list(got._table.items()) == list(want._table.items()), f"{what}: tables differ")
    check(got._free == want._free, f"{what}: free lists differ")
    for field in ("dbitmap", "varbitmap", "refkey"):
        check(np.array_equal(getattr(got._meta, field), getattr(want._meta, field)),
              f"{what}: working meta.{field} differs")
    check(got.stats["last_rebuild"] == want.stats["last_rebuild"],
          f"{what}: last rebuild {got.stats['last_rebuild']} != {want.stats['last_rebuild']}")
    results_equal(got._index, want._index, what)


def check_gets(answer, table: dict, gone: np.ndarray, what: str) -> None:
    """``answer(pairs) -> (found, rid)`` gives every mapped page its
    physical page, and every pair of ``gone`` misses."""
    keys = np.fromiter((v for k in table for v in k), np.uint32, 2 * len(table)).reshape(-1, 2)
    found, rid = answer(np.concatenate([keys, gone]))
    found, rid = np.asarray(found, bool), np.asarray(rid, np.uint32)
    check(bool(found[:len(keys)].all()) and np.array_equal(
        rid[:len(keys)], np.fromiter(table.values(), np.uint32, len(table))),
        f"{what}: a mapped page answered wrong")
    check(not found[len(keys):].any(), f"{what}: a freed page answered")


def pager_phase(args, dev, launches: dict) -> None:
    """Phase 13: a ``"cuda"`` ``PagedKVManager`` of 2^17 pages of 16 tokens
    beside a ``"torch"`` twin on the same card, filled with 4,000
    sequences of 32 pages, its journal shipped by a ``StreamPrimary``
    over a ``DirectoryTransport`` (under a temporary directory) to a
    ``"cuda"`` ``StreamReplica`` standby.  After the first build and after
    each of 10 seeded churn rounds (``free_seq`` of a victim, ``pages_for``
    of 1 to 32 of its pages again, the re-alloc of a mapped slot,
    ``rebuild_index``) the two pagers agree byte for byte, one get of
    every mapped page answers its physical page on both and on the
    standby, and the freed pages miss.  A quiet rebuild ships nothing.
    Then ``run_pager_load`` at the same size.  The ``"cuda"`` pager's
    rebuilds and gets, the standby's polls and gets and the load run are
    the path, counted from 0."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 41)
    acc = launches.setdefault("pager", {})
    opts = dict(n_pages=PAGER_PAGES, page_tokens=PAGER_TOKENS, device=dev)
    tokens = PAGER_SEQ_PAGES * PAGER_TOKENS
    rebuilds = []
    with tempfile.TemporaryDirectory(prefix="repro_pager_") as tmp:
        transport = DirectoryTransport(Path(tmp) / "spool")
        pm = PagedKVManager(backend="cuda", **opts)
        pm.attach_stream(StreamPrimary(transport, n_words=2, device=dev))
        twin = PagedKVManager(backend="torch", **opts)
        standby = StreamReplica(transport, backend="cuda", device=dev)
        t0 = time.perf_counter()
        for s in range(PAGER_SEQS):
            pm.pages_for(s, tokens)
        fill_s = time.perf_counter() - t0
        for s in range(PAGER_SEQS):
            twin.pages_for(s, tokens)
        check(pm.stats["pages_free"] == PAGER_PAGES - PAGER_SEQS * PAGER_SEQ_PAGES,
              f"the fill left {pm.stats['pages_free']} pages free")
        gone = np.asarray([(PAGER_SEQS, 0), (0, PAGER_SEQ_PAGES)], np.uint32)
        for r in range(PAGER_ROUNDS + 1):
            what = f"pager round {r}"
            if r:
                victim = int(rng.integers(0, PAGER_SEQS))
                back = int(rng.integers(1, PAGER_SEQ_PAGES + 1))
                mapped = [k for k in pm._table if k[0] != victim]
                slot = mapped[int(rng.integers(0, len(mapped)))]
                for p in (pm, twin):
                    p.free_seq(victim)
                    p.pages_for(victim, back * PAGER_TOKENS)
                    p.alloc(*slot)  # the re-alloc of a mapped slot
                gone = np.asarray([(victim, p) for p in range(back, PAGER_SEQ_PAGES)]
                                  + [(PAGER_SEQS, 0)], np.uint32)
            with counted(acc):
                t0 = time.perf_counter()
                pm.rebuild_index()
                wall = time.perf_counter() - t0
            twin.rebuild_index()
            pagers_equal(pm, twin, what)
            with counted(acc):
                check_gets(pm.lookup_batch, pm._table, gone, f"{what}, cuda gets")
                t0 = time.perf_counter()
                standby.poll()
                poll_s = time.perf_counter() - t0
                check_gets(standby.search_batch, pm._table, gone, f"{what}, standby")
            check_gets(twin.lookup_batch, twin._table, gone, f"{what}, torch gets")
            last = pm.stats["last_rebuild"]
            rebuilds.append({"wall_s": wall, "path": "incremental" if last["incremental"]
                             else (last["fallback"] or "first build"),
                             "replayed": last["log_entries_replayed"],
                             "standby_poll_s": poll_s})
        before = transport.end()
        pm.rebuild_index()
        check(transport.end() == before, "a quiet rebuild shipped a frame")
        check(standby.applied_lsn == pm._log.start_lsn - 1,
              "the standby is not current through the journal")
        del pm, twin, standby
    with counted(acc):
        load = run_pager_load(backend="cuda", device=dev, n_pages=PAGER_PAGES,
                              page_tokens=PAGER_TOKENS, n_seqs=PAGER_SEQS,
                              pages_per_seq=PAGER_SEQ_PAGES, n_readers=8, duration_s=5.0,
                              seed=args.seed)
    check(load["errors"] == [], f"pager load: errors {load['errors']}")
    check(load["torn_reads"] == 0 and load["stale_epochs"] == 0,
          f"pager load: {load['torn_reads']} torn reads, {load['stale_epochs']} stale epochs")
    check(load["n_requests"] > 0 and load["epochs_published"] >= 2,
          f"pager load: {load['n_requests']} requests, {load['epochs_published']} epochs")
    check_launches("pager", acc)
    line = {"pages": PAGER_PAGES, "page_tokens": PAGER_TOKENS, "seqs": PAGER_SEQS,
            "pages_per_seq": PAGER_SEQ_PAGES, "phase_s": time.perf_counter() - t_phase,
            "fill_s": fill_s, "rebuilds": rebuilds,
            "load": {k: v for k, v in load.items() if k != "snapshot"}, "launches": acc}
    print(f"[pager] {json.dumps(line)}", flush=True)
    print("[pager] cuda pager == torch pager after the first build and each churn round "
          "(table, free list, meta, tree, last rebuild); every mapped page answers on both "
          "and on the standby, freed pages miss; a quiet rebuild ships nothing; the load "
          f"run has no torn read, stale epoch or error; {card_line()}", flush=True)


def main(argv=None) -> int:
    """Run the phases on CUDA device 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-keys", type=int, default=FULL_N_KEYS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10, help="timed launches per kernel")
    ap.add_argument("--log-dir", type=Path, default=None,
                    help="write the compiler output (and the profile) here")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    cudalib.lib()
    print(f"[build] kernel library ready in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.log_dir is not None and cudalib.last_build is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
        (args.log_dir / "nvcc_build.log").write_text(cudalib.last_build[1])

    # -- 2. kernels vs plain versions at edge shapes -------------------------
    t0 = time.perf_counter()
    edge_checks(dev, rng)
    torch.cuda.synchronize()
    print(f"[kernels] pext, bitonic, pk-window, probe, merge-rank, dbit, probe_many (both "
          f"forms) == plain at edge shapes ({time.perf_counter() - t0:.2f} s)", flush=True)

    # -- 3. the slice --------------------------------------------------------
    t0 = time.perf_counter()
    ks = zipf_keys(ZipfConfig(1.5, 64, 0, args.n_keys), seed=args.seed)
    perm = rng.permutation(ks.n)  # zipf_keys returns sorted rows
    n = ks.n
    keyset = KeySet(words=ks.words[perm], lengths=ks.lengths[perm],
                    rids=np.arange(n, dtype=np.uint32))
    del ks
    print(f"[data] Zipf(1.5, 64, 0): {n} unique keys of {keyset.n_words} words "
          f"({args.n_keys} drawn) in {time.perf_counter() - t0:.1f} s", flush=True)

    # one sort bucket for the whole set: the comparison point of phase 5
    threshold = 1 << 24
    pipe = ReconstructionPipeline(backend="cuda", chunk_threshold=threshold, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cudalib.reset_launches()
    pipe.run(keyset)  # first run: allocator and library warm-up
    t1 = time.perf_counter()
    res = pipe.run(keyset)  # ends on the host (refresh_meta, stats)
    run_wall = time.perf_counter() - t1
    pipe.run(keyset, full_keys=True)
    t1 = time.perf_counter()
    full = pipe.run(keyset, full_keys=True)
    full_wall = time.perf_counter() - t1
    query_batches = [make_queries(keyset.words, rng) for _ in range(N_BATCHES)]
    answers = []
    t_lookup = []
    for q_np, _ in query_batches:
        q = to_carrier(q_np, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        answers.append(pipe.backend.lookup(res.tree, q))
        torch.cuda.synchronize()
        t_lookup.append(time.perf_counter() - t1)
    launches = {"slice": path_launches()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches("slice", launches["slice"])

    st, tm, ft = res.stats, res.timings, full.timings
    slice_line = {
        "n_keys": n, "key_words": keyset.n_words, "bucket": plancache.bucket(n),
        "distinction_bits": st["distinction_bits"],
        "comp_words": st["comp_sort_key_words"] - 1,
        "tree_height": st["tree_height"],
        "timings_s": {k: tm[k] for k in ("meta", "extract", "sort", "build",
                                         "refresh_meta", "total")},
        "run_wall_s": run_wall,
        "full_keys_timings_s": {k: ft[k] for k in ("sort", "build", "total")},
        "full_keys_run_wall_s": full_wall,
        "sort_ratio_full_over_comp": ft["sort"] / tm["sort"],
        "lookup_batch_s": t_lookup,
        "peak_mem_gib": peak_gib,
        "launches": launches["slice"],
    }
    print(f"[slice] {json.dumps(slice_line)}", flush=True)

    # checks: order, permutation, and equality with the plain backend
    keyed = torch.cat([res.comp_sorted, res.row_sorted[:, None]], dim=1)
    check(bool(lex_less(keyed[:-1], keyed[1:]).all()),
          "comp_sorted is not ascending in (key, row)")
    del keyed
    check(same(torch.sort(res.rid_sorted).values, torch.arange(n, device=dev)),
          "rid_sorted is not a permutation")
    ref_pipe = ReconstructionPipeline(backend="torch", chunk_threshold=threshold, device=dev)
    res_torch = ref_pipe.run(keyset)  # kept for phase 9's "torch" twin
    results_equal(res, res_torch, "cuda vs torch")
    results_equal(full, ref_pipe.run(keyset, full_keys=True), "full keys, cuda vs torch")
    del full, ref_pipe
    print("[slice] sorted run, permutation, tree and meta == torch backend", flush=True)

    # -- 4. lookups ------------------------------------------------------------
    torch_backend = get_backend("torch", device=dev)
    for (q_np, expect), (found, rid) in zip(query_batches, answers):
        check(np.array_equal(to_u32(rid), expect), "a lookup answer is wrong")
        check(np.array_equal(found.cpu().numpy(), expect != NOT_FOUND_RID),
              "a lookup found flag is wrong")
        f_ref, r_ref = torch_backend.lookup(res.tree, to_carrier(q_np, dev))
        check(same(found, f_ref) and same(rid, r_ref), "lookup differs from torch")
    print(f"[lookup] {N_BATCHES} x {BATCH} queries: every hit returns its rid, "
          f"every miss NOT_FOUND_RID, == torch backend", flush=True)
    traced = profile_slice(pipe, keyset, res.tree, to_carrier(query_batches[0][0], dev),
                           args.log_dir)
    print(f"[profile] {json.dumps(traced)}", flush=True)

    # -- 5. chunked: the pipeline's defaults, against phase 3's run -------------
    pipe_c = ReconstructionPipeline(backend="cuda", device=dev)
    if n <= pipe_c.chunk_threshold:  # a short call (--n-keys): scale the ladder down
        pipe_c.chunk_threshold = plancache.bucket(n) // 4
        pipe_c.chunk_size = pipe_c.chunk_threshold // 4
    pipe_c.run(keyset)
    cudalib.reset_launches()
    with largest_rank_pass() as cascade_rank:
        t1 = time.perf_counter()
        res_c = pipe_c.run(keyset)
        chunked_wall = time.perf_counter() - t1
    launches["chunked"] = path_launches()
    check_launches("chunked", launches["chunked"])
    st = res_c.stats
    check(st["chunked"] == -(-n // pipe_c.chunk_size),
          f"{st['chunked']} chunks for {n} keys in chunks of {pipe_c.chunk_size}")
    check(st["cascade_merges"] == st["chunked"] - 1, "the ladder did not merge every chunk")
    results_equal(res_c, res, "chunked vs unchunked")
    chunked_line = {
        "chunk_size": pipe_c.chunk_size, "chunk_threshold": pipe_c.chunk_threshold,
        **{k: st[k] for k in ("chunked", "cascade_merges", "cascade_peak_live_runs")},
        "timings_s": {k: res_c.timings[k] for k in ("meta", "extract", "sort", "build",
                                                    "refresh_meta", "total")},
        "run_wall_s": chunked_wall, "unchunked_run_wall_s": run_wall,
        "launches": launches["chunked"],
    }
    print(f"[chunked] {json.dumps(chunked_line)}", flush=True)
    print("[chunked] sorted run, permutation, tree and meta == the unchunked run", flush=True)
    del res_c

    # the chunk plan this card's measured costs pick at the 2^24 bucket,
    # run with one synchronize per run (async_dispatch)
    pipe_t = ReconstructionPipeline(backend="cuda", device=dev, async_dispatch=True)
    t0 = time.perf_counter()
    plan_t = pipe_t.tune_chunking(ref_n=plancache.bucket(n),
                                  n_words=int(res.comp_sorted.shape[1]), iters=3)
    tune_s = time.perf_counter() - t0
    pipe_t.run(keyset)
    t1 = time.perf_counter()
    res_t = pipe_t.run(keyset)
    tuned_wall = time.perf_counter() - t1
    check(res_t.stats["async_dispatch"] is True, "async_dispatch synchronized every stage")
    results_equal(res_t, res, "tuned, async vs unchunked")
    res_t = pipe_t.run(keyset, stage_timings=True)
    results_equal(res_t, res, "tuned, stage barriers vs unchunked")
    tuned_line = {
        "chunk_size": plan_t.chunk_size, "chunk_threshold": plan_t.chunk_threshold,
        "ref_n": plan_t.ref_n, "n_words": plan_t.n_words, "tune_s": tune_s,
        **{k: getattr(plan_t, k) for k in ("sort_cold", "sort_warm", "merge_cold",
                                           "merge_warm")},
        "chunked": res_t.stats["chunked"], "async_run_wall_s": tuned_wall,
        "timings_s": {k: res_t.timings[k] for k in ("meta", "extract", "sort", "build",
                                                    "refresh_meta", "total")},
    }
    print(f"[tuned] {json.dumps(tuned_line)}", flush=True)
    print("[tuned] async and stage-barrier runs at the measured plan == the unchunked run",
          flush=True)
    del res_t, pipe_t

    # -- 6. incremental: a replica folds 1 % inserts and 1 % deletes ----------
    t0 = time.perf_counter()
    dk = zipf_keys(ZipfConfig(1.5, 64, 0, max(n // 100, 1)), seed=args.seed + 1)
    fresh = np.flatnonzero(~rows_in(dk.words, keyset.words))
    fresh = fresh[rng.permutation(fresh.size)]
    nd = int(fresh.size)
    delta = KeySet(words=dk.words[fresh], lengths=dk.lengths[fresh],
                   rids=np.arange(n, n + nd, dtype=np.uint32))
    keep = rng.random(n) >= 0.01
    # the replica's metadata already covers the delta's keys (union meta)
    meta = meta_from_keys(np.concatenate([keyset.words, delta.words]), dev)
    print(f"[incremental] delta of {nd} fresh keys ({dk.n - nd} equal a base key), "
          f"{n - int(keep.sum())} deletes, prepared in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del dk
    prev = pipe_c.run(keyset, meta=meta)
    pipe_c.run_incremental(prev, keyset, delta, keep_rows=keep, meta=meta)
    cudalib.reset_launches()
    with largest_rank_pass() as delta_rank:
        t1 = time.perf_counter()
        inc, folded = pipe_c.run_incremental(prev, keyset, delta, keep_rows=keep, meta=meta)
        inc_wall = time.perf_counter() - t1
    launches["incremental"] = path_launches()
    check_launches("incremental", launches["incremental"])
    check(inc.stats["incremental"] is True, "run_incremental fell back to the full run")
    check(inc.stats["n_delta"] == nd and inc.stats["n_deleted"] == n - int(keep.sum()),
          "run_incremental counted the change set wrong")
    t1 = time.perf_counter()
    fold_keyset(keyset, keep, delta)  # the host fold inside run_incremental, alone
    fold_wall = time.perf_counter() - t1
    pipe_c.run(folded, meta=meta)
    t1 = time.perf_counter()
    full_inc = pipe_c.run(folded, meta=meta)
    folded_wall = time.perf_counter() - t1
    results_equal(inc, full_inc, "incremental vs full run over the folded set")
    del full_inc
    torch_pipe = ReconstructionPipeline(backend="torch", device=dev)
    results_equal(inc, torch_pipe.run_incremental(
        torch_pipe.run(keyset, meta=meta), keyset, delta, keep_rows=keep, meta=meta)[0],
        "incremental, cuda vs torch")
    del torch_pipe
    # a D-bitmap that moved: one more (constant) bit is still a valid plan
    zero_bits = np.flatnonzero(np.unpackbits(meta.dbitmap.astype(">u4").view(np.uint8)) == 0)
    grown = meta.dbitmap.copy()
    grown[zero_bits[0] // 32] |= np.uint32(1 << (31 - zero_bits[0] % 32))
    meta_x = dataclasses.replace(meta, dbitmap=grown)
    moved, _ = pipe_c.run_incremental(prev, keyset, delta, keep_rows=keep, meta=meta_x)
    check(moved.stats["incremental"] is False
          and moved.stats["incremental_fallback"] == "dbitmap_changed",
          "a changed D-bitmap did not take the full-run fallback")
    results_equal(moved, pipe_c.run(folded, meta=meta_x), "fallback vs full run")
    del moved, prev
    noop, _ = pipe_c.run_incremental(inc, folded, None, meta=meta, watermark=1)
    check(noop.stats["noop"] is True and noop.comp_sorted is inc.comp_sorted
          and noop.watermark == 1, "an empty change set was not a no-op")
    inc_line = {
        "n_base": n, "n_delta": nd, "n_deleted": inc.stats["n_deleted"],
        "timings_s": {k: inc.timings[k] for k in ("filter", "extract", "sort", "merge",
                                                  "build", "refresh_meta", "total")},
        "run_wall_s": inc_wall, "fold_keyset_s": fold_wall, "full_run_wall_s": folded_wall,
        "launches": launches["incremental"],
    }
    print(f"[incremental] {json.dumps(inc_line)}", flush=True)
    print("[incremental] == full run over the folded set, == torch backend; the changed "
          "D-bitmap falls back, the empty change set is a no-op", flush=True)
    del pipe_c

    # -- 7. multitenant: six 1M-key tenants in one arena ------------------------
    mt = multitenant_phase(args, dev, rng, launches)

    # -- 8. mt_load: the closed-loop harness, with and without the SLO ----------
    mt_load_phase(args, dev, launches)

    # -- 9. online: phase 3's index takes inserts, deletes, searches, rebuilds ---
    online_phase(args, dev, rng, keyset, res, res_torch, launches)
    del res_torch

    # -- 10. run_many: four same-bucket key sets batched, a fifth alone ----------
    many = run_many_phase(args, dev, rng, launches)

    # -- 11. replication: a primary, two tails and a recovering lagger ---------
    replication_phase(args, dev, rng, keyset, launches)

    # -- 12. load: reads racing incremental rebuilds, with and without shedding -
    load_phase(args, dev, launches)

    # -- 13. pager: the serving page table, its standby and its load run --------
    pager_phase(args, dev, launches)

    # -- 14. kernel report at the main paths' shapes -----------------------------
    b = plancache.bucket(n)
    words_dev = plancache.pad_tail(to_carrier(keyset.words, dev), b, plancache.SENTINEL)
    plan = make_plan(res.extract_bitmap, keyset.n_words)
    comp = pext(words_dev, plan)
    comp_m, rows_m = plancache._mask_run(comp, plancache.iota(b, dev), n, plancache.ROW_PAD_A)
    tree = res.tree
    starts = tree.leaf["dpos"].reshape(-1)[:n] + 1
    rowc = res.row_sorted.clamp(0, n - 1)  # the build's gather: row ids in sorted order
    q0 = to_carrier(query_batches[0][0], dev)
    node = _descend(tree, q0)
    lc = tree.config.leaf_cap
    pk = tree.config.pk_bits
    wc = plan.n_words_out
    w = keyset.n_words

    def touched_words(st: torch.Tensor, row: torch.Tensor) -> int:
        """Distinct (row, word) pairs a window read touches."""
        wi = st.clamp(0, w * 32 - 1) // 32
        ids = torch.cat([row * w + wi, (row * w + wi + 1)[wi + 1 < w]])
        return int(torch.unique(ids).numel())

    pair_q = torch.arange(BATCH, device=dev).repeat_interleave(lc)
    pair_starts = tree.leaf["dpos"][node].reshape(-1) + 1
    slots = int(torch.unique(node).numel()) * lc
    log_block = DEFAULT_BLOCK.bit_length() - 1
    # name -> (kernel, plain version, bytes moved at u32 width, operations):
    # pext does shift, and, shift, or per kept bit of each key; the
    # network does at least one compare per compare-exchange; a window
    # takes about six integer operations, a probe pair one more
    cases = {
        "pext": (lambda: pext(words_dev, plan), lambda: pext_plain(words_dev, plan),
                 b * (w + wc) * 4, b * plan.n_bits * 4),
        "bitonic_block_sort": (lambda: block_sort(comp_m, rows_m),
                               lambda: block_sort_plain(comp_m, rows_m),
                               2 * b * (wc + 1) * 4,
                               b // 2 * log_block * (log_block + 1) // 2),
        # the leaf level: each gathered row read and written, a row id and a
        # start read and a window written per entry
        "pk_window": (lambda: gather_windows(words_dev, rowc, starts, pk),
                      lambda: gather_windows_plain(words_dev, rowc, starts, pk),
                      n * (2 * w + 3) * 4, n * 6),
        "probe": (lambda: probe(q0, node, tree.leaf["dpos"], tree.leaf["pk"], pk),
                  lambda: probe_plain(q0, node, tree.leaf["dpos"], tree.leaf["pk"], pk),
                  touched_words(pair_starts, pair_q) * 4 + BATCH * 4
                  + slots * 2 * 4 + BATCH * lc,
                  BATCH * lc * 7),
    }
    # probe_many at the multitenant lookup: six tenants x 2^15 queries x lc
    # lanes; the same per-pair reads as probe, tenant by tenant
    st_m, q_m, node_m = mt["stacked"], mt["queries"], mt["node"]
    t_m, n_qm = node_m.shape
    tenant_m = torch.arange(t_m, device=dev)[:, None]
    pairs_m = t_m * n_qm * lc
    starts_m = st_m.leaf["dpos"][tenant_m, node_m].reshape(-1) + 1
    pair_rows_m = torch.arange(t_m * n_qm, device=dev).repeat_interleave(lc)
    slots_m = int(torch.unique(tenant_m * st_m.leaf["dpos"].shape[1] + node_m).numel()) * lc
    cases["probe_many"] = (
        lambda: probe_many(q_m, node_m, st_m.leaf["dpos"], st_m.leaf["pk"], pk),
        lambda: probe_many_plain(q_m, node_m, st_m.leaf["dpos"], st_m.leaf["pk"], pk),
        touched_words(starts_m, pair_rows_m) * 4 + t_m * n_qm * 4 + slots_m * 2 * 4 + pairs_m,
        pairs_m * 7)

    def rank_shape(rank_args) -> dict:
        return {"n_q": int(rank_args[0].shape[0]), "n_s": int(rank_args[2].shape[0]),
                "words": int(rank_args[0].shape[1]) + 1}

    def rank_case(rank_args):
        """(kernel, plain, bytes, operations) of one rank pass: each query
        (key and row) read once, one int32 written per query, and the key
        words of each searched row a search can probe read once (a row id
        is needed only where two keys tie); a ceil(log2(n_s + 1))-step
        search comparing up to Wc + 1 words (load and compare) per step.
        Step l of n_q binary searches probes at most min(2^l, n_q) distinct
        rows of the searched run, whatever the queries."""
        shape = rank_shape(rank_args)
        n_q, n_s, words = shape["n_q"], shape["n_s"], shape["words"]
        steps = n_s.bit_length()
        probed = min(n_s, sum(min(1 << lvl, n_q) for lvl in range(steps)))
        return (lambda: merge_ranks(*rank_args), lambda: merge_ranks_plain(*rank_args),
                (n_q * words + probed * (words - 1)) * 4 + n_q * 4, n_q * steps * 2 * words)

    cases["merge_rank"] = rank_case(cascade_rank["args"])
    # dbit in the positions form at the build's run (the sorted compressed
    # keys of the slice), the entry's own numbers
    comp_run, full_run = res.comp_sorted, tree.sorted_full
    comp_counts, full_counts = dbit_counts(comp_run), dbit_counts(full_run)
    cases["dbit"] = (lambda: adjacent_dbits(comp_run), lambda: adjacent_dbits_plain(comp_run),
                     *dbit_cost(comp_counts, "positions"))

    def measure(kernel_fn, plain_fn, n_bytes, n_ops, what):
        got, want = kernel_fn(), plain_fn()
        got, want = (got if isinstance(got, tuple) else (got,)), \
            (want if isinstance(want, tuple) else (want,))
        match = all(same(g, p) for g, p in zip(got, want))
        err = max(float((g.to(torch.int64) - p.to(torch.int64)).abs().max()) if g.numel() else 0.0
                  for g, p in zip(got, want))
        check(match, f"{what} kernel != plain at the main path's shapes")
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_OPS_PER_S * 1e3
        return {
            "max_abs_err": err, "ms": cuda_ms(kernel_fn, args.reps),
            "call_ms": cuda_ms(kernel_fn, args.reps, with_launch=True),
            "plain_ms": cuda_ms(plain_fn, 3), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "match": match,
        }

    report = []
    for name, case in cases.items():
        source, replaces = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(path[name] for path in launches.values())}
        entry.update(measure(*case, name))
        report.append(entry)
    # pext's plan at the bucket: kept bits, and the segments and tables
    # the kernel walks per key
    segments, tables = segment_plan(plan)
    next(e for e in report if e["name"] == "pext")["plan"] = {
        "bits": plan.n_bits, "words_in": w, "words_out": wc,
        "segments": len(segments), "tables": len(tables)}
    # merge_rank at its two shapes: the rank pass of the largest cascade
    # merge (the entry's own numbers) and that of the incremental merge
    merge_entry = next(e for e in report if e["name"] == "merge_rank")
    merge_entry["shape"] = rank_shape(cascade_rank["args"])
    merge_entry["at_incremental_merge"] = {
        "shape": rank_shape(delta_rank["args"]),
        **measure(*rank_case(delta_rank["args"]), "merge_rank (incremental)")}
    # pk_window's leaf form beside the plain gather of the same rows alone
    # (G), and its index form at the level above the leaves beside the
    # pair it replaces: the level's rows gathered, then windowed
    pk_entry = next(e for e in report if e["name"] == "pk_window")
    gather_ms = cuda_ms(lambda: words_dev[rowc], args.reps)
    pk_entry.update(shape={"entries": n, "key_words": w, "table_rows": b},
                    gather_ms=gather_ms,
                    gather_call_ms=cuda_ms(lambda: words_dev[rowc], args.reps, with_launch=True),
                    over_gather=pk_entry["ms"] / gather_ms,
                    minus_gather_ms=pk_entry["ms"] - gather_ms)
    level = tree.levels[-1]
    bc = level["hi"].reshape(-1).clamp(0, n - 1)
    starts_l = level["dpos"].reshape(-1) + 1
    full = tree.sorted_full
    pk_entry["index_form"] = {
        "entries": int(bc.shape[0]),
        **measure(lambda: pk_windows(full, starts_l, pk, bc),
                  lambda: pk_windows_plain(full, starts_l, pk, bc),
                  (touched_words(starts_l, bc) + 3 * int(bc.shape[0])) * 4,
                  int(bc.shape[0]) * 6, "pk_window (index form)"),
        "unfused_ms": cuda_ms(lambda: pk_windows(full[bc], starts_l, pk), args.reps)}
    # probe and probe_many in the leaf-stage form their lookups run, at the
    # same shapes: beside the plain stage (every lane's full key gathered,
    # compared and selected) and the unfused stage (the mask form, then
    # that gather, compare and select)
    one_tree = _as_stack(tree)
    for name, stacked, node_s, queries_s, kernel_fn, plain_fn in [
            ("probe", one_tree, node[None], q0[None],
             lambda: leaf_stage(one_tree, node[None], q0[None]),
             lambda: leaf_stage_many_plain(one_tree, node[None], q0[None])),
            ("probe_many", st_m, node_m, q_m, lambda: leaf_stage_many(st_m, node_m, q_m),
             lambda: leaf_stage_many_plain(st_m, node_m, q_m))]:
        entry = next(e for e in report if e["name"] == name)
        counts = leaf_stage_counts(stacked, node_s, queries_s)
        entry["leaf_stage"] = {
            **counts,
            **measure(kernel_fn, plain_fn, counts["bytes"], counts["operations"],
                      f"{name} (leaf stage)"),
            "plain_stage_ms": cuda_ms(plain_fn, args.reps),
            "unfused_stage_ms": cuda_ms(lambda: unfused_leaf_stage(stacked, node_s, queries_s),
                                        args.reps)}
        entry["leaf_stage"]["over_plain_stage"] = \
            entry["leaf_stage"]["ms"] / entry["leaf_stage"]["plain_stage_ms"]
    # dbit's bitmap form at the refresh's run and at meta_from_keys' sorted
    # full keys, beside the u32 bound of all words and the floor of every
    # sector at the int64 carrier's width
    dbit_entry = next(e for e in report if e["name"] == "dbit")
    dbit_entry.update(
        form="positions", shape=comp_counts,
        launches_by_form={form: sum(path["dbit_by_form"][form] for path in launches.values())
                          for form in cudalib.LAUNCHES_BY_FORM["dbit"]},
        **dbit_floors(comp_counts, "positions"))
    dbit_entry["bitmap_form"] = {
        "shape": comp_counts,
        **measure(lambda: adjacent_dbitmap(comp_run), lambda: adjacent_dbitmap_plain(comp_run),
                  *dbit_cost(comp_counts, "bitmap"), "dbit (bitmap form)"),
        **dbit_floors(comp_counts, "bitmap")}
    dbit_entry["full_key_bitmap_form"] = {
        "shape": full_counts,
        **measure(lambda: adjacent_dbitmap(full_run), lambda: adjacent_dbitmap_plain(full_run),
                  *dbit_cost(full_counts, "bitmap"), "dbit (full-key bitmap form)"),
        **dbit_floors(full_counts, "bitmap")}
    # bitonic's stacked form: the one launch over run_many's stacked
    # members (each rounded up to whole blocks), beside the plain network
    # member by member
    keys_s, rows_s = many["stacked"]["args"]
    k_s = len(many["sizes"])
    n_pad = int(keys_s.shape[0]) // k_s
    wc_s = int(keys_s.shape[1])

    def stacked_plain():
        parts = [block_sort_plain(keys_s[i * n_pad:(i + 1) * n_pad],
                                  rows_s[i * n_pad:(i + 1) * n_pad]) for i in range(k_s)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    rows_total = k_s * n_pad
    bitonic_entry = next(e for e in report if e["name"] == "bitonic_block_sort")
    bitonic_entry["stacked_form"] = {
        "shape": {"members": k_s, "rows_per_member": n_pad, "key_words": wc_s},
        "launches": launches["run_many"]["bitonic_block_sort"]
        - many["line"]["other_shape_launches"]["bitonic_block_sort"],
        **measure(lambda: block_sort(keys_s, rows_s), stacked_plain,
                  2 * rows_total * (wc_s + 1) * 4,
                  rows_total // 2 * log_block * (log_block + 1) // 2, "bitonic (stacked form)")}
    del comp, comp_m, rows_m, words_dev, rowc, keys_s, rows_s
    print(json.dumps({"kernels": report}), flush=True)
    print(f"[wall] the whole script took {time.perf_counter() - t_script:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
