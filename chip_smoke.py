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
   multiple, 128-word keys (pext, merge-rank, dbit), duplicate and
   all-ones keys (bitonic, merge-rank), searched runs of 1 and 2^k±1 rows
   and pad rows of both reserved ranges (merge-rank), windows starting on
   a word boundary and in the last word (pk-window, probe), equal pairs
   and pairs that differ in the last bit only (dbit);
3. the slice: ``ReconstructionPipeline(backend="cuda").run`` on the
   paper's Zipf(s=1.5, n=64 bytes, m=0) keys (§6.3, Table 4 dataset 15)
   at 10M keys, rows shuffled by a seeded permutation, rids = row index;
   unchunked (one 2^24 sort bucket), run twice (the second is timed) plus
   the full-key baseline, checked against the plain ``"torch"`` backend
   on the same card;
4. lookups: four batches of 2^18 queries, half hits and half misses,
   then one more run and lookup batch traced with ``torch.profiler``
   (device time by kernel, idle share of the window);
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
9. kernel report: each kernel's launches on the main paths (phases 3, 5,
   6, 7 and 8, each counted from 0), its time at the main path's shapes,
   its plain version's time and the least time the card could take for
   the same bytes and operations.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.configs.paper_index import ZipfConfig  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.btree import NOT_FOUND_RID, _descend, _descend_many  # noqa: E402
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import (  # noqa: E402
    NO_DBIT, compute_dbitmap, lex_less, sort_words, sort_words_keyed)
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.core.metadata import meta_from_keys  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline, fold_keyset  # noqa: E402
from repro_torch.core.snapshot import SnapshotCell  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data.synthetic import zipf_keys  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import DEFAULT_BLOCK, block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import pk_windows, pk_windows_plain  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits, adjacent_dbits_plain  # noqa: E402
from repro_torch.kernels.lookup import probe, probe_many, probe_many_plain, probe_plain  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain  # noqa: E402
from repro_torch.kernels.merge import ops as merge_ops  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
from repro_torch.serve import MultiTenantEngine, TenantRegistry  # noqa: E402
from repro_torch.serve.loadgen import run_multitenant_load  # noqa: E402

#: H100 SXM HBM3 rate (NVIDIA data sheet), for the bytes bound
PEAK_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit rate outside the tensor cores (NVIDIA data sheet, the
#: float32 figure), for the operations bound of the kernels' integer work
PEAK_OPS_PER_S = 67e12
BATCH = 1 << 18
N_BATCHES = 4
N_TENANTS = 6
TENANT_QUERIES = 1 << 15
RAGGED_TENANT = 2

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
    "probe_many": ("src/repro_torch/csrc/probe_many.cu",
                   "src/repro/kernels/lookup/kernel.py:91"),
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


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    # bitonic: duplicates, all-ones keys with a permuted payload, a ragged
    # last block, the full-key width, and 128-word keys in a 64-row block
    for n, w, block, kind in [(4096 + 77, 4, 512, "dup"), (1000, 2, 512, "ones"),
                              (5000, 16, 512, "dup"), (777, 3, 128, "rand"),
                              (300, 128, 64, "dup")]:
        if kind == "dup":
            keys = np.repeat(rand_words(rng, -(-n // 4), w, 0x000000FF), 4, axis=0)[:n]
        elif kind == "ones":
            keys = np.full((n, w), 0xFFFFFFFF, np.uint32)
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
    # pk-window: starts on word boundaries (sh == 0), in the last word,
    # and outside the key (clipped), for pk 1, 16 and 32
    for m, w in [(10007, 16), (333, 1), (4096, 4)]:
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
    # merge-rank: n_q off any multiple of 256; searched runs of 1, 2^k - 1
    # and 2^k + 1 rows; duplicate keys whose ties fall to the row word;
    # 128-word keys
    def sorted_run(n, w, mask, row_base):
        keys = to_carrier(rand_words(rng, n, w, mask), dev)
        return sort_words_keyed(keys, row_base + torch.as_tensor(rng.permutation(n), device=dev))

    for n_q, n_s, w, mask in [(1000, 4097, 3, 0x0F0F0F0F), (777, 1, 4, 0xFF),
                              (5003, 4095, 4, 0xFF), (300, 65537, 2, 0x3),
                              (129, 300, 128, 0x1)]:
        keys_s, rows_s = sorted_run(n_s, w, mask, 0)
        keys_q, rows_q = sorted_run(n_q, w, mask, n_s)
        check(same(merge_ranks(keys_q, rows_q, keys_s, rows_s),
                   merge_ranks_plain(keys_q, rows_q, keys_s, rows_s)),
              f"merge-rank kernel != plain at n_q={n_q} n_s={n_s} W={w}")
    # all-ones keys against pad rows of both reserved ranges
    ones = torch.full((2048, 2), plancache.SENTINEL, dtype=torch.int64, device=dev)
    lane = torch.arange(1024, device=dev)
    rows_s = torch.cat([lane, plancache.ROW_PAD_A + lane])
    rows_q = torch.cat([lane[:300] + 1024, plancache.ROW_PAD_B + lane[:700]])
    check(same(merge_ranks(ones[:1000], rows_q, ones, rows_s),
               merge_ranks_plain(ones[:1000], rows_q, ones, rows_s)),
          "merge-rank kernel != plain on all-ones keys and pad rows")
    # dbit: equal pairs, a pair that differs in the last bit of the last
    # word only, 128-word keys
    for n, w, mask in [(5003, 3, 0x00FF00FF), (300, 128, 0x01010101), (4097, 16, 0x3)]:
        keys = sort_words(to_carrier(rand_words(rng, n, w, mask), dev))[0]
        keys[n // 2] = keys[n // 2 - 1]
        keys[3] = keys[2]
        keys[3, -1] ^= 1
        got = adjacent_dbits(keys)
        check(same(got, adjacent_dbits_plain(keys)), f"dbit kernel != plain at n={n} W={w}")
        check(int(got[2]) == 32 * w - 1 and int(got[n // 2 - 1]) == NO_DBIT,
              f"dbit kernel misses the last-bit or the equal pair at W={w}")


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


def check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"the {path} path never launched the {name} kernel")


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


def profile_slice(pipe, keyset, tree, queries, log_dir) -> dict:
    """One traced ``run`` of the slice plus one lookup batch under
    ``torch.profiler``: device time by kernel, and the share of the window
    in which the device ran nothing (busy time is the sum of device
    events, which on one stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe._sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipe.run(keyset)
        pipe.backend.lookup(tree, queries)
        pipe._sync()
        wall = time.perf_counter() - t0
    device = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda row: -row[1],
    )
    busy_ms = sum(ms for _, ms, _ in device)
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
        (log_dir / "profile_device_ms.txt").write_text("".join(
            f"{ms:12.3f} ms {count:6d}x  {name}\n" for name, ms, count in device))
    return {
        "traced_wall_s": wall, "traced_stage_s": res.timings,
        "device_busy_s": busy_ms / 1e3, "idle_share": 1 - busy_ms / 1e3 / wall,
        "top_device_ms": [[name[:60], ms, count] for name, ms, count in device[:10]],
        # the port's own kernels (csrc/*.cu, in anonymous namespaces)
        "port_kernel_device_ms": {
            name.split("::")[1].split("(")[0]: [ms, count]
            for name, ms, count in device if name.startswith("(anonymous namespace)::")},
    }


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
    launches["multitenant"] = dict(cudalib.LAUNCHES)
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
    launches["mt_load"] = dict(cudalib.LAUNCHES)
    check_launches("mt_load", launches["mt_load"])
    print(f"[mt_load] {json.dumps(plain)}", flush=True)
    print(f"[mt_load] slo {json.dumps(slo)}", flush=True)
    print(f"[mt_load] launches {json.dumps(launches['mt_load'])}; no torn read, no stale "
          "epoch, no error, every tenant served, with and without the SLO", flush=True)


def main(argv=None) -> int:
    """Run the phases on CUDA device 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-keys", type=int, default=10_000_000)
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
    print(f"[kernels] pext, bitonic, pk-window, probe, merge-rank, dbit, probe_many == "
          f"plain at edge shapes ({time.perf_counter() - t0:.2f} s)", flush=True)

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
    launches = {"slice": dict(cudalib.LAUNCHES)}
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
    results_equal(res, ref_pipe.run(keyset), "cuda vs torch")
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
    launches["chunked"] = dict(cudalib.LAUNCHES)
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
    launches["incremental"] = dict(cudalib.LAUNCHES)
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

    # -- 9. kernel report at the main paths' shapes ------------------------------
    b = plancache.bucket(n)
    words_dev = plancache.pad_tail(to_carrier(keyset.words, dev), b, plancache.SENTINEL)
    plan = make_plan(res.extract_bitmap, keyset.n_words)
    comp = pext(words_dev, plan)
    comp_m, rows_m = plancache._mask_run(comp, plancache.iota(b, dev), n, plancache.ROW_PAD_A)
    tree = res.tree
    starts = tree.leaf["dpos"].reshape(-1)[:n] + 1
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
        "pk_window": (lambda: pk_windows(tree.sorted_full, starts, pk),
                      lambda: pk_windows_plain(tree.sorted_full, starts, pk),
                      (touched_words(starts, torch.arange(n, device=dev)) + 2 * n) * 4,
                      n * 6),
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
        row read once, one int32 written per query, and each searched row
        a search can probe read once; a ceil(log2(n_s + 1))-step search
        comparing up to Wc + 1 words (load and compare) per step.  Step l
        of n_q binary searches probes at most min(2^l, n_q) distinct rows
        of the searched run, whatever the queries."""
        shape = rank_shape(rank_args)
        n_q, n_s, words = shape["n_q"], shape["n_s"], shape["words"]
        steps = n_s.bit_length()
        probed = min(n_s, sum(min(1 << lvl, n_q) for lvl in range(steps)))
        return (lambda: merge_ranks(*rank_args), lambda: merge_ranks_plain(*rank_args),
                (n_q + probed) * words * 4 + n_q * 4, n_q * steps * 2 * words)

    # the dbit pass over the compressed run of the 2^24 bucket: one read of
    # each key and one int32 per pair; xor, test and branch for each word
    # up to the first that differs, and one clz
    dpos = adjacent_dbits(res.comp_sorted)
    dbit_words = torch.where(dpos == NO_DBIT, wc, dpos // 32 + 1)
    cases["merge_rank"] = rank_case(cascade_rank["args"])
    cases["dbit"] = (lambda: adjacent_dbits(res.comp_sorted),
                     lambda: adjacent_dbits_plain(res.comp_sorted),
                     n * wc * 4 + (n - 1) * 4, 3 * int(dbit_words.sum()) + (n - 1))
    del dpos, dbit_words

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
    # merge_rank at its two shapes: the rank pass of the largest cascade
    # merge (the entry's own numbers) and that of the incremental merge
    merge_entry = next(e for e in report if e["name"] == "merge_rank")
    merge_entry["shape"] = rank_shape(cascade_rank["args"])
    merge_entry["at_incremental_merge"] = {
        "shape": rank_shape(delta_rank["args"]),
        **measure(*rank_case(delta_rank["args"]), "merge_rank (incremental)")}
    del comp, comp_m, rows_m, words_dev
    print(json.dumps({"kernels": report}), flush=True)
    print(f"[wall] the whole script took {time.perf_counter() - t_script:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
