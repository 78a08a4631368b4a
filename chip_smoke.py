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
   pext and both dbit forms at the token pipeline's 513-word document
   keys and at 514 words (pext with 17-bit token words, a quarter of the
   bits and every bit kept), both dbit forms (positions, bitmap) on runs
   of 1, 3, 4, 16, 33, 128, 513 and 514 words with equal pairs, pairs that differ in the last bit only, keys
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
8. plancache: the lookup programs are CUDA graphs.  On phase 3's tree a
   2^18-query and a 256-query batch replay byte for byte as their
   program's body run eagerly; batches of 256, 249 and 200 queries (one
   bucket) trace nothing; two ``run_incremental`` epochs of 10,000
   deletes with the same keys re-inserted under new rids keep the
   geometry, so each is a copy of the tree into the graph's buffers, not
   a trace, and every answer is that epoch's; the same for
   ``lookup_many`` on phase 7's arena (drift within the bucket, two
   re-stacked arenas of one geometry); ``reset_cache`` gives the graphs'
   memory back (within 1 %).  Eager and replay call times, the capture
   time, the tree copy's time and the bytes a graph holds are printed;
9. mt_load: ``serve.loadgen.run_multitenant_load`` on ``"cuda"`` (8
   tenants of 2^17 four-word keys, 8 readers, batches of 1024, mutation
   batches of 1024, 5 s), then again at the reference bench's SLO point
   (``target_p99_us`` = 4 x the unloaded p50): no torn read, no stale
   epoch, no error, every tenant served, no warm trace;
10. online: phase 3's 10M-key ``"cuda"`` result wrapped in an
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
11. run_many: five disjoint key sets of one Zipf(1.5, 64, 0) draw (seed
   ``seed+11``): four of 2.09M down to 2.0M keys in the 2^21 bucket that
   share their union's DS-metadata, as replicas of one index do (one
   group: a pext launch per member, one bitonic launch over the stack),
   and one of 300,000 keys with no metadata given (another bucket:
   ``meta_from_keys``, then ``run``); each member equal to its single run
   and to the ``"torch"`` backend's ``run_many``; the batched wall against
   the single runs' (at the pipeline's defaults and unchunked);
12. replication: phase 3's keys as the base table of a ``StreamPrimary``
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
   directory spool keeps every invariant (no trace in its steady rounds);
13. load: ``serve.loadgen.run_load`` on ``"cuda"`` at the reference
   bench's key shape (two words, mask ``0x00FF0F0F``) with 2^22 draws
   (about 4.19M keys after the dedupe): 8 reader threads, probe batches
   of 256, a writer folding 1,024 redrawn keys per cycle through
   ``run_incremental``, 5 s; the writer's first incremental result, made
   before the readers start, equals a full ``"cuda"`` run over its folded
   keyset and the ``"torch"`` backend's ``run_incremental`` on the same
   inputs.  Then again at the reference's admission point (a writer
   owing a cycle every 1 ms, lag bound 1, shed): both runs without a
   torn read, stale epoch, error or warm trace, at least 3 epochs,
   acquires equal to releases, two readers pinned at once in the first,
   sheds in the second; each run's ``to_row()``, beside the figures
   ``PERF.md`` records for the same run with eager lookups;
14. pager: a ``"cuda"`` ``serve.pager.PagedKVManager`` of 2^17 pages of
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
15. kernel report: each kernel's launches on the main paths (phases 3, 5,
   6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 18 and 19, each counted from 0; phase 16's
   summed over its ranks; a lookup graph's
   replay counts the launches its capture recorded), its device time at the
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
   member;
16. distributed (run before the report, which counts its launches):
   ``repro_torch.tools.rankgroup`` starts four gloo ranks that share the
   card; each loads the inputs this process wrote as ``.npy`` files (phase
   3's keyset, phase 6's delta, delete mask and union meta, phase 4's
   first batch) and runs the ``"distributed"`` backend: phase 3's ``run``
   at ``--n-keys`` (unchunked: the sample sort, its two exchanges timed
   apart, retries counted), phase 6's ``run_incremental`` (the owner-routed
   merge), the 2^18-query batch through the routed lookup (at least two
   ranks answer), ``lookup_many`` over eight ``[mt_load]``-shaped tenants
   (2^17 four-word keys; two a rank), ``run_many`` over eight disjoint
   262,144-key parts of the slice with phase 3's meta (two a rank), and
   the reference's skewed overflow input at capacity 0.5 (overflow
   reported, then retried to the sorted order).  Every output's SHA-256
   digest equals the ``"cuda"`` result's and every other rank's; each
   rank's sort wall, exchange bytes beside the bytes of the same exchange
   with 16-word full keys, retries and peak memory are printed, labelled
   as gloo over host loopback with four ranks on one card.  Then a
   one-rank NCCL group in this process runs the slice through
   ``"distributed"``, equal to phase 3;
17. lm_serve (run before phase 16): llama3-8b at full width and depth
   (8.03 B parameters, random bf16 weights from ``seed+51``) served by a
   ``"cuda"`` ``ServeEngine`` (batch 4, max_seq 1024, pages of 16
   tokens): four 512-token prompts, 32 greedy tokens, every step's
   logits finite, one decode step traced with ``torch.profiler`` (its
   device time, idle share and launches); at nine generated positions,
   the first and last included, a fresh prefill over the prefix lands
   within 5e-2 of the logits' scale of the decode step's logits and its
   clear argmax (top-2 margin above that) is the generated token.  A
   restart rebuilds the page index (== a ``"torch"`` twin pager byte for
   byte, every page found through ``lookup_page``); one sequence freed
   and another grown, a second restart folds the journal incrementally
   (merge-rank launched), freed pages answer ``None``; a standby engine
   following the primary's stream over a ``QueueTransport`` restarts at
   lag 0 and finds every page.  Then qwen3-moe-235b-a22b at full width
   with its 94 layers cut to 2 (6.2 B parameters): a prefill of 4 x 512
   tokens (16,384 dispatch entries, a 21-bit one-word key) and 8 decode
   steps with the ``sort`` and the ``einsum`` dispatch from the same
   weights: positions byte-identical, dropped fractions and tokens
   equal, logits within 1e-6 of their scale.  Init, prefill, decode ms
   (median, p90), tokens/s, peak memory, each restart's wall and path
   and the phase's wall are printed with the card;
18. train (after phase 17, before phase 16): the LM training path.  The
   token pipeline on ``"cuda"`` at a corpus shard's size:
   ``shuffle_order`` over 10M document ids (== ``"torch"`` == numpy's
   lexsort of ``(fnv1a(seed||doc), doc)``) and ``dedup_tokens`` over
   262,144 ``lm_tokens`` documents of 513 tokens, one in eight a planted
   copy (== ``"torch"`` == numpy's first occurrences), pext and dbit ==
   plain at those 513-word keys.  llama3-8b at full width with its 32
   layers cut to 4 (1.92 B parameters; f32 master weights, gradients and
   AdamW moments of all 8.03 B would need about 128 GB), master weights
   from ``seed+62``, batch 4 x 512 from a ``TokenPipeline``: one
   ``accum=2`` step against one ``accum=1`` step from one start (losses
   within 1e-2, parameters within two learning rates, the mean gap
   within 5 % of one), the same held between rematerialised training
   (the model's default) and ``remat=False`` (losses equal to the bit),
   six ``accum=1`` steps on the repeated batch (finite, the first loss
   within 1.0 of ln V, falling), one traced, and three without remat,
   one traced; for each, step ms, tokens/s, peak and activations, the
   traced step's busy ms, idle share and launches.  Then llama3-8b at the
   reference's ``train_4k`` length: 4 x 4096 tokens at ``accum=2``
   (microbatch 2 x 4096), rematerialised, four steps on one batch, one
   traced (finite, falling); step ms, tokens/s, peak, and the peak
   without remat reckoned from the activations measured at 512 tokens.
   ``repro_torch.launch.train.main`` at repro-100m's full size:
   20 steps of 8 x 256 with checkpoints every 10, a resume to 30 (the
   manifest index rebuilt on ``"cuda"``: pk-window and probe launched),
   the restored tree == the saved one byte for byte, the losses == an
   uninterrupted 30-step run's within 1e-3; the index rebuild, the
   checkpoint's bytes and walls;
19. examples (after phase 18, before phase 16): the example twins run in
   this process through their ``main(argv)`` on the card, each timed:
   ``examples/train_lm_torch.py --quick`` (repro-100m, 30 steps of 4 x
   128, checkpoints at 25 and 30; with step 30's removed, a second run
   resumes from 25 and its losses equal the first run's within 1e-3),
   ``examples/serve_moe_torch.py`` (reduced qwen3-moe with the sort
   dispatch: 16 tokens for 4 sequences, a restart that rebuilds the page
   index, sequence 2's page 1 found at the page the table holds) and
   ``examples/replication_torch.py --fast`` (replica B caught up through
   the checkpoint chain; A, B and the primary byte-identical).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import shutil
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
from repro_torch.configs import ARCHS  # noqa: E402
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
from repro_torch.core.u32 import sync_stream, to_carrier, to_u32  # noqa: E402
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
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    ChangeLog, DirectoryTransport, QueueTransport, StreamPrimary, StreamReplica)
from repro_torch.replication import replica as replica_mod  # noqa: E402
from repro_torch.replication.stream import _state_like  # noqa: E402
from repro_torch.tools.chaos_soak import run_soak  # noqa: E402
from repro_torch.serve import MultiTenantEngine, TenantRegistry  # noqa: E402
from repro_torch.serve.loadgen import (  # noqa: E402
    _probe_keyset_exact, run_load, run_multitenant_load, run_pager_load)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
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
#: the same run with eager lookups, as PERF.md section 5 records it (three
#: calls on an H100 80GB HBM3 at 700 W): lookups/s and p50 of 8 readers
EAGER_LOAD = {"lookups_per_s": [7500, 10300], "p50_us": [190000, 260000]}
#: pager: 2^17 pages of 16 tokens, filled with 4,000 sequences of 32 pages
#: (3,072 free), and the churn rounds after the first build
PAGER_PAGES = 1 << 17
PAGER_TOKENS = 16
PAGER_SEQS = 4000
PAGER_SEQ_PAGES = 32
PAGER_ROUNDS = 10
#: distributed: gloo ranks on the one card, [mt_load]-shaped tenants, and
#: run_many's disjoint parts of the slice
DIST_RANKS = 4
DIST_TENANTS = 8
DIST_TENANT_KEYS = 1 << 17
DIST_PARTS = 8
DIST_PART_KEYS = 262_144
#: phase 17: llama3-8b served at full width and depth
LM_SERVE = {"arch": "llama3-8b", "batch": 4, "prompt": 512, "new": 32, "max_seq": 1024,
            "page_tokens": 16}
#: generated positions held against a fresh prefill (first and last included)
TF_POSITIONS = (0, 1, 5, 9, 13, 17, 21, 25, 31)
#: the decode step traced with torch.profiler (left out of the step times)
TRACE_STEP = 16
#: decode against prefill logits in bf16, as a fraction of the logits' scale
#: (max |logit|): the two paths round in different orders
LOGIT_TOL = 5e-2
#: phase 17's MoE part: qwen3-moe at full width, depth cut to fit one card
MOE_SERVE = {"arch": "qwen3-moe-235b-a22b", "layers": 2, "decode": 8}
#: sort against einsum dispatch: the same positions give the same arithmetic
MOE_LOGIT_TOL = 1e-6

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
    "plancache": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe",
                  "probe_many"),
    "distributed": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe",
                    "probe_many"),
    "lm_serve": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
    "train": ("pext", "bitonic_block_sort", "pk_window", "dbit", "probe"),
    "examples": ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"),
    "mesh": ("pext", "bitonic_block_sort", "pk_window", "dbit", "probe"),
}
#: phase 19: the example twins, run in this process
EXAMPLES = ROOT / "examples"


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
    # pext at the token pipeline's document keys (513 words: 512 tokens and
    # the label) and just past them: 17-bit token words, a third of the
    # bits at random, and every bit (the launcher halves its tile to fit)
    for w in (513, 514):
        for name, mask in (("17-bit tokens", 0x0001FFFF), ("a quarter of the bits", None),
                           ("every bit", None)):
            words = to_carrier(rand_words(rng, 4099, w, mask or 0xFFFFFFFF), dev)
            if mask is not None:
                bm = to_u32(compute_dbitmap(words))
            elif name == "every bit":
                bm = np.full(w, 0xFFFFFFFF, np.uint32)
            else:
                bm = rand_words(rng, 1, w)[0] & rand_words(rng, 1, w)[0]
            plan = make_plan(bm, w)
            check(same(pext(words, plan), pext_plain(words, plan)),
                  f"pext kernel != plain at W={w} ({name}, {plan.n_bits} bits)")
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
    for w in (1, 3, 4, 16, 33, 128, 513, 514):
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
            "node": _descend_many(arena.stacked, q_norm), "trees": trees, "q_np": q_np,
            "n_valid": n_valid}


def call_ms(fn, reps: int) -> float:
    """Median wall of one call of ``fn`` from an idle card, the host's
    launches included (CUDA events around the call)."""
    return cuda_ms(fn, reps, with_launch=True)


def eager_lookup(prog, tree, queries, n_valid):
    """A lookup program's body run eagerly on the card over the padded
    batch (the comparison for its graph): bucket-shaped (found, rid)."""
    return prog.body(tree, queries, torch.as_tensor(np.asarray(n_valid, np.int64),
                                                    device=queries.device))


def tree_copy_ms(tree, reps: int) -> float:
    """Device time of copying every array of ``tree`` into same-shaped
    buffers: the copy a lookup graph makes for a new same-geometry epoch."""
    src = plancache._tree_tensors(tree)
    dst = [torch.empty_like(t) for t in src]

    def copy():
        for d, t in zip(dst, src):
            d.copy_(t)

    ms = cuda_ms(copy, reps)
    del dst
    return ms


def plancache_phase(args, dev, rng, pipe, keyset, res, mt, launches: dict) -> None:
    """Phase 8: the plan cache on the card.  The lookup programs are CUDA
    graphs: on phase 3's 10M-key tree, a 2^18-query and a 256-query batch
    replay byte for byte as their program's body run eagerly; batches of
    256, 249 and 200 queries (one bucket) trace nothing; two
    run_incremental epochs of 10,000 deletes and the same keys inserted
    again under new rids keep the geometry: each is a tree copy, no trace,
    and the replay equals the eager body on that epoch's tree; the same
    for ``lookup_many`` on phase 7's six-tenant arena (drift within the
    bucket, two re-stacked arenas of the same geometry).  ``reset_cache``
    then gives back the memory the graphs held.  The path (the lookups
    and the epochs' rebuilds, not the eager comparisons) is counted from
    0."""
    import gc

    t_phase = time.perf_counter()
    plancache.reset_cache()
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    cache = plancache.get_cache()
    cuda = pipe.backend
    acc = launches.setdefault("plancache", {})
    reps = max(args.reps, 10)
    big_np, big_expect = make_queries(keyset.words, rng, BATCH)
    small_np, small_expect = make_queries(keyset.words, rng, 256)
    out = {"batches": {}}

    def prog_of(op, *key):
        return cache.programs[(op, "cuda") + key]

    # -- replay == eager, capture and call times, for both batches ----------
    for name, q_np, expect in (("2^18", big_np, big_expect), ("256", small_np, small_expect)):
        q = to_carrier(q_np, dev)
        b = plancache.bucket_for("lookup", q.shape[0])
        mem_before = torch.cuda.memory_allocated(dev)
        with counted(acc):
            found, rid = cuda.lookup(res.tree, q)
            torch.cuda.synchronize()
        prog = prog_of("lookup", b, keyset.n_words)
        check(prog.captured and prog.captures == 1, f"{name}: the lookup was not captured")
        check(np.array_equal(to_u32(rid), expect), f"{name}: a replayed answer is wrong")
        qp = plancache.pad_tail(q, b, 0xFFFFFFFF)
        f_e, r_e = eager_lookup(prog, res.tree, qp, q.shape[0])
        check(same(found, f_e[: q.shape[0]]) and same(rid, r_e[: q.shape[0]]),
              f"{name}: the graph's replay differs from its body run eagerly")
        out["batches"][name] = {
            "bucket": b,
            "capture_s": prog.capture_s,
            "graph_buffer_bytes": prog.buffer_bytes,
            "graph_pool_bytes": prog.pool_bytes,
            "allocated_after_capture_bytes": torch.cuda.memory_allocated(dev) - mem_before,
            "replay_launches": prog.replay_launches[0],
            "eager_call_ms": call_ms(lambda: eager_lookup(prog, res.tree, qp, q.shape[0]), reps),
            "replay_call_ms": call_ms(lambda: cuda.lookup(res.tree, q), reps),
        }
    traces0 = plancache.cache_stats()["traces"]

    # -- drift within the 256 bucket ----------------------------------------
    prog = prog_of("lookup", 256, keyset.n_words)
    for size in (256, 249, 200):
        q = to_carrier(small_np[:size], dev)
        with counted(acc):
            found, rid = cuda.lookup(res.tree, q)
        f_e, r_e = eager_lookup(prog, res.tree, plancache.pad_tail(q, 256, 0xFFFFFFFF), size)
        check(same(found, f_e[:size]) and same(rid, r_e[:size]),
              f"drift to {size} queries: replay differs from eager")
    check(plancache.cache_stats()["traces"] == traces0, "a batch within its bucket traced")

    # -- two same-geometry epochs: 10,000 deletes, the same keys re-inserted
    # -- under new rids ---------------------------------------------------------
    q_big = to_carrier(big_np, dev)
    prog = prog_of("lookup", BATCH, keyset.n_words)
    prev, base, expect = res, keyset, big_expect.copy()
    hits = expect != NOT_FOUND_RID
    epochs = []
    for e in range(2):
        victims = rng.choice(base.n, size=10_000, replace=False)
        keep = np.ones(base.n, bool)
        keep[victims] = False
        new_rids = np.uint32((1 << 30) + (e << 20)) + np.arange(10_000, dtype=np.uint32)
        delta = KeySet(words=base.words[victims], lengths=base.lengths[victims],
                       rids=new_rids)
        moved = dict(zip(np.asarray(base.rids)[victims].tolist(), new_rids.tolist()))
        copies, traces_e = prog.tree_copies, plancache.cache_stats()["traces"]
        with counted(acc):
            t1 = time.perf_counter()
            prev, base = pipe.run_incremental(prev, base, delta, keep_rows=keep)
            torch.cuda.synchronize()
            rebuild_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            found, rid = cuda.lookup(prev.tree, q_big)
            torch.cuda.synchronize()
            first_call_s = time.perf_counter() - t1
        check(btree.tree_geometry(prev.tree) == btree.tree_geometry(res.tree),
              f"epoch {e}: the geometry changed")
        check(prog.tree_copies == copies + 1 and prog.captures == 1,
              f"epoch {e}: the new tree was not copied into the graph")
        if e == 1:
            check(plancache.cache_stats()["traces"] == traces_e,
                  "the second same-geometry epoch traced a program")
        f_e, r_e = eager_lookup(prog, prev.tree, q_big, BATCH)
        check(same(found, f_e) and same(rid, r_e), f"epoch {e}: replay differs from eager")
        expect[hits] = [moved.get(int(x), int(x)) for x in expect[hits]]
        check(np.array_equal(to_u32(rid), expect), f"epoch {e}: an answer is stale")
        epochs.append({"incremental": prev.stats["incremental"], "rebuild_s": rebuild_s,
                       "first_lookup_s": first_call_s, "traces": plancache.cache_stats()[
                           "traces"] - traces_e})
    out["epochs"] = epochs
    lookup_traces = plancache.cache_stats()["per_op"]["lookup"]["traces"]
    check(lookup_traces == 2, f"the lookups traced {lookup_traces} times, not 2")
    out["tree_copy_device_ms"] = tree_copy_ms(prev.tree, reps)
    out["copy_call_ms"] = call_ms(
        lambda: (cuda.lookup(res.tree, q_big), cuda.lookup(prev.tree, q_big)), reps) / 2
    out["tree_copies"] = cache.tree_copies

    # -- lookup_many on the six-tenant arena ----------------------------------
    stacked, q_mt, n_valid = mt["stacked"], mt["q_np"], mt["n_valid"]
    t_cap, n_q = int(stacked.sorted_full.shape[0]), q_mt.shape[1]
    bm = plancache.bucket_for("lookup_many", n_q)
    queries = to_carrier(q_mt, dev)
    with counted(acc):
        found, rid = cuda.lookup_many(stacked, queries, n_valid)
        torch.cuda.synchronize()
    prog_m = prog_of("lookup_many", t_cap, bm, 16, btree.tree_geometry(stacked))
    nv_full = np.zeros(t_cap, np.int64)
    nv_full[: len(n_valid)] = n_valid
    qp = plancache.pad_tail(queries, t_cap, 0xFFFFFFFF)
    f_e, r_e = eager_lookup(prog_m, stacked, qp, nv_full)
    check(same(found, f_e[: len(n_valid)]) and same(rid, r_e[: len(n_valid)]),
          "lookup_many: the replay differs from its body run eagerly")
    traces_m = plancache.cache_stats()["traces"]
    for cut in (1, 100):
        nv_cut = np.minimum(n_valid, n_q - cut)
        with counted(acc):
            found, rid = cuda.lookup_many(stacked, queries[:, : n_q - cut], nv_cut)
        nv_c = np.zeros(t_cap, np.int64)
        nv_c[: len(nv_cut)] = nv_cut
        f_e, r_e = eager_lookup(prog_m, stacked, qp, nv_c)
        check(same(found, f_e[: len(n_valid), : n_q - cut])
              and same(rid, r_e[: len(n_valid), : n_q - cut]),
              f"lookup_many at {n_q - cut} queries: replay differs from eager")
    trees = [mt["trees"][t] for t in range(N_TENANTS)]
    for e in (1, 2):
        rotated = btree.stack_trees(trees[e:] + trees[:e], capacity=t_cap)
        copies = prog_m.tree_copies
        with counted(acc):
            found, rid = cuda.lookup_many(rotated, queries, n_valid)
        check(prog_m.tree_copies == copies + 1, f"arena {e}: not copied into the graph")
        f_e, r_e = eager_lookup(prog_m, rotated, qp, nv_full)
        check(same(found, f_e[: len(n_valid)]) and same(rid, r_e[: len(n_valid)]),
              f"arena {e}: replay differs from eager")
        del rotated
    check(plancache.cache_stats()["traces"] == traces_m,
          "lookup_many traced within its bucket or across same-geometry arenas")
    out["lookup_many"] = {
        "t_cap": t_cap, "bucket": bm, "capture_s": prog_m.capture_s,
        "graph_buffer_bytes": prog_m.buffer_bytes, "graph_pool_bytes": prog_m.pool_bytes,
        "replay_launches": prog_m.replay_launches[0],
        "eager_call_ms": call_ms(lambda: eager_lookup(prog_m, stacked, qp, nv_full), reps),
        "replay_call_ms": call_ms(lambda: cuda.lookup_many(stacked, queries, n_valid), reps),
    }
    out["graphs"] = cache.graph_stats()
    out["stats"] = plancache.cache_stats()
    check_launches("plancache", acc)

    # -- reset: the graphs give their memory back ------------------------------
    del found, rid, f_e, r_e, qp, q_big, queries, prev, base, prog, prog_m
    plancache.reset_cache()
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(dev)
    check(abs(mem1 - mem0) <= mem0 // 100,
          f"after reset_cache {mem1} bytes are allocated, {mem0} before the phase")
    out["allocated_before_gib"] = mem0 / 2**30
    out["allocated_after_reset_gib"] = mem1 / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = acc
    print(f"[plancache] {json.dumps(out)}", flush=True)
    print("[plancache] lookup and lookup_many replay their graphs == their bodies run "
          "eagerly; no trace across drift within a bucket and same-geometry epochs (tree "
          f"copies); reset_cache gives the memory back; {card_line()}", flush=True)


def check_load(rep: dict, what: str) -> None:
    check(rep["torn_reads"] == 0, f"{what}: {rep['torn_reads']} torn reads")
    check(rep["stale_epochs"] == 0, f"{what}: {rep['stale_epochs']} stale epochs")
    check(rep["errors"] == [], f"{what}: errors {rep['errors']}")
    served = rep["served_per_tenant"]
    check(sorted(served) == list(range(rep["n_tenants"])) and min(served.values()) > 0,
          f"{what}: a tenant was starved ({served})")
    check(rep["epochs_published"] > 8, f"{what}: {rep['epochs_published']} epochs published")
    check(rep["warm_traces"] == 0, f"{what}: {rep['warm_traces']} warm traces")


def mt_load_phase(args, dev, launches: dict) -> None:
    """Phase 9: the closed-loop multi-tenant harness without the SLO, then
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
    """Phase 10: the slice's index taken online on ``"cuda"`` beside a
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
    """Phase 11: ``run_many`` on ``"cuda"`` over four same-bucket key sets
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
# phase 12: replication and index recovery
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
    """Phase 12: phase 3's keys as the base table of a ``StreamPrimary``
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
        "insert_rule_rank": ins_rank_line, "soak_steady_traces": soak["steady_traces"],
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
    check(rep.warm_traces == 0, f"{what}: {rep.warm_traces} warm traces")
    st = rep.cell_stats
    check(st["acquires"] == st["releases"] and st["pinned"] == 0,
          f"{what}: {st['acquires']} acquires, {st['releases']} releases")


def load_phase(args, dev, launches: dict) -> None:
    """Phase 13: ``run_load`` on ``"cuda"`` at the reference bench's key
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
            "wall_s": plain_wall, "eager_lookups_recorded": EAGER_LOAD}
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
    """Phase 14: a ``"cuda"`` ``PagedKVManager`` of 2^17 pages of 16 tokens
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


# ---------------------------------------------------------------------------
# phase 17: the LM serving path, llama3-8b at full width and depth, then
# qwen3-moe at full width with its depth cut
# ---------------------------------------------------------------------------

def lm_param_count(params: dict) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return tree.numel()
    return count(params)


@contextmanager
def recorded_logits(engine, steps: list, trace_at: int | None = None, traced: dict | None = None):
    """Record the engine's logits, each admit and step timed to the
    device's end (a clone of every call's (B, V) logits and its wall).
    Call ``trace_at`` (0 is the admit) runs under ``torch.profiler``; its
    profile goes to ``traced["prof"]`` and its wall to ``traced["wall_s"]``."""
    from torch.profiler import ProfilerActivity, profile

    admit, step = engine.admit, engine.step

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            if len(steps) == trace_at:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    logits = fn(*a, **k)
                    torch.cuda.synchronize()
                    traced.update(prof=prof, wall_s=time.perf_counter() - t0)
            else:
                t0 = time.perf_counter()
                logits = fn(*a, **k)
                torch.cuda.synchronize()
            steps.append((logits.clone(), time.perf_counter() - t0))
            return logits
        return call

    engine.admit, engine.step = timed(admit), timed(step)
    try:
        yield steps
    finally:
        del engine.admit, engine.step


def step_profile(traced: dict) -> dict:
    """A traced decode step: its wall, the device's busy time and idle
    share, the kernels it launched and the host calls that launched them,
    and the kernels that took the most device time."""
    prof = traced["prof"]
    device = device_ms_by_kernel(prof)
    busy_ms = sum(ms for _, ms, _ in device)
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                    "cuLaunchKernelEx"))
    return {"wall_ms": traced["wall_s"] * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / 1e3 / traced["wall_s"],
            "device_kernels": sum(count for _, _, count in device),
            "host_launch_calls": launch_calls,
            "top_device_ms": [[name[:60], ms, count] for name, ms, count in device[:6]]}


@contextmanager
def dispatch_spy():
    """Record the MoE dispatch positions of every call, in either mode,
    the compressed key's width, and each layer's dropped fraction."""
    seen = {"pos": [], "key_bits": [], "dropped": []}
    sort_fn, cumsum_fn, ffn = (moe_mod.dispatch_indices_sort, moe_mod.dispatch_indices_cumsum,
                               lm_mod.moe_ffn)

    def by_sort(expert_id, n_experts):
        seen["key_bits"].append(moe_mod._bits_for(n_experts)
                                + moe_mod._bits_for(int(expert_id.shape[0])))
        pos, perm = sort_fn(expert_id, n_experts)
        seen["pos"].append(pos.clone())
        return pos, perm

    def by_cumsum(onehot):
        pos = cumsum_fn(onehot)
        seen["pos"].append(pos.clone())
        return pos

    def moe_ffn(*a, **k):
        out, aux = ffn(*a, **k)
        seen["dropped"].append(float(aux["dropped_frac"]))
        return out, aux

    moe_mod.dispatch_indices_sort, moe_mod.dispatch_indices_cumsum = by_sort, by_cumsum
    lm_mod.moe_ffn = moe_ffn
    try:
        yield seen
    finally:
        moe_mod.dispatch_indices_sort, moe_mod.dispatch_indices_cumsum = sort_fn, cumsum_fn
        lm_mod.moe_ffn = ffn


def check_pages(answer, table: dict, gone, what: str) -> None:
    """``answer(seq, page)`` gives every mapped page its physical page and
    ``None`` for every pair of ``gone``."""
    wrong = [k for k, phys in table.items() if answer(*k) != phys]
    check(not wrong, f"{what}: {len(wrong)} mapped pages answered wrong, first {wrong[:3]}")
    answered = [k for k in gone if answer(*k) is not None]
    check(not answered, f"{what}: freed pages answered: {answered[:3]}")


def logit_stats(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the scale: max |want|)."""
    return float((got - want).abs().max()), float(want.abs().max())


def step_ms(walls: list) -> dict:
    ms = np.asarray(walls) * 1e3
    return {"median": float(np.median(ms)), "p90": float(np.percentile(ms, 90))}


def lm_serve_phase(args, dev, launches: dict) -> None:
    """Phase 17: the LM serving path.  Part A: llama3-8b at full width and
    depth (8.03 B parameters, random from the seed, bf16) served by a
    ``"cuda"`` ``ServeEngine`` (batch 4, max_seq 1024, pages of 16
    tokens): four prompts of 512 tokens, 32 greedy tokens, every step's
    logits finite, nine positions held against a fresh prefill over their
    prefix (teacher forcing); a restart rebuilds the page index (== a
    ``"torch"`` twin pager, every page found through ``lookup_page``), one
    sequence is freed and another grown, a second restart folds the
    journal incrementally (merge-rank), and a standby that follows the
    primary over a ``QueueTransport`` finds every page at lag 0.  Part B:
    qwen3-moe at full width, two layers, prefill 4 x 512 and 8 decode
    steps with the sort and the einsum dispatch from one set of weights:
    positions byte-identical, dropped fractions equal, logits within the
    tolerance.  The primary's generate, restarts and page gets and the
    standby's restart and gets are the path, counted from 0."""
    t_phase = time.perf_counter()
    card = card_line()
    acc = launches.setdefault("lm_serve", {})
    a = LM_SERVE
    rng = np.random.default_rng(args.seed + 51)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 51)

    # -- part A: llama3-8b ---------------------------------------------------
    cfg = ARCHS[a["arch"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm_param_count(params)
    # the config's count leaves out the norm vectors (two a layer, one final)
    check(n_params == cfg.total_params() + (2 * cfg.n_layers + 1) * cfg.d_model,
          f"{n_params} parameters for {cfg.name}, config says {cfg.total_params()}")
    opts = dict(max_seq=a["max_seq"], batch_size=a["batch"], page_tokens=a["page_tokens"],
                device=dev)
    transport = QueueTransport()
    eng = ServeEngine(model, params, **opts)
    eng.pager.attach_stream(StreamPrimary(transport, n_words=2, device=dev))
    standby = ServeEngine(model, params, **opts)
    standby.follow(StreamReplica(transport, backend="cuda", device=dev))
    twin = PagedKVManager(n_pages=eng.pager.n_pages, page_tokens=a["page_tokens"],
                          backend="torch", device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (a["batch"], a["prompt"]))
    steps: list = []
    traced: dict = {}
    with counted(acc), recorded_logits(eng, steps, TRACE_STEP, traced):
        t0 = time.perf_counter()
        out = eng.generate(prompts, a["new"])
        gen_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(out.shape == (a["batch"], a["new"]), f"generate returned {out.shape}")
    check(all(bool(torch.isfinite(lg).all()) for lg, _ in steps),
          "a step's logits are not finite")
    kv_gib = sum(t.numel() * t.element_size() for sub in eng._cache.values()
                 for t in sub.values()) / 2**30

    # teacher forcing: each recorded position against a fresh prefill over
    # its prefix (steps[j] gave out[:, j]; its prefix holds out[:, :j])
    full = np.concatenate([prompts, out], axis=1)
    tf = []
    for j in TF_POSITIONS:
        n_tok = a["prompt"] + j
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, want = model.prefill(params, {"tokens": torch.as_tensor(full[:, :n_tok], device=dev)},
                                model.init_cache(a["batch"], n_tok))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got = steps[j][0]
        err, scale = logit_stats(got, want)
        check(err <= LOGIT_TOL * scale,
              f"position {j}: decode logits {err} from the prefill's (scale {scale})")
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL * scale
        agree = want.argmax(dim=-1).cpu().numpy() == out[:, j]
        check(bool(np.all(agree[clear.cpu().numpy()])),
              f"position {j}: a generated token is not the prefill's clear argmax")
        tf.append({"position": j, "max_abs_err": err, "scale": scale,
                   "clear": int(clear.sum()), "agree": int(agree.sum()), "prefill_s": prefill_s})
        del want
    twin_ops = [(b, a["prompt"]) for b in range(a["batch"])]
    twin_ops += [(b, pos + 1) for pos in range(a["prompt"], a["prompt"] + a["new"])
                 for b in range(a["batch"])]
    for seq, n_tok in twin_ops:
        twin.pages_for(seq, n_tok)

    # first restart: the page index rebuilt from the table
    with counted(acc):
        st1 = eng.restart()
        check_pages(eng.lookup_page, eng.pager._table, [(a["batch"], 0)], "first restart")
    twin.rebuild_index()
    pagers_equal(eng.pager, twin, "first restart, cuda vs torch")
    check(not st1["incremental"], "the first restart did not build from the table")
    check(result_digests(eng.pager._index) == result_digests(twin._index),
          "first restart: digests differ")

    # second restart: free one sequence, grow another, fold the journal
    victim, grown = a["batch"] - 1, 1
    gone = [k for k in eng.pager._table if k[0] == victim]
    for p in (eng.pager, twin):
        p.free_seq(victim)
        p.pages_for(grown, a["max_seq"])
    second = {}
    with counted(second):
        st2 = eng.restart()
        check_pages(eng.lookup_page, eng.pager._table, gone, "second restart")
    add_launches(acc, second)
    twin.rebuild_index()
    pagers_equal(eng.pager, twin, "second restart, cuda vs torch")
    check(st2["incremental"] is True, f"the second restart was not incremental: {st2}")
    check(second["merge_rank"] > 0, "the incremental restart launched no merge-rank kernel")

    # the standby follows the primary's stream
    with counted(acc):
        t0 = time.perf_counter()
        sst = standby.restart()
        standby_s = time.perf_counter() - t0
        check_pages(standby.lookup_page, eng.pager._table, gone, "standby")
    check(sst["followed_stream"] and sst["lag_frames"] == 0,
          f"the standby is behind: {sst}")
    check(sst["applied_lsn"] == eng.pager._log.start_lsn - 1,
          "the standby is not current through the primary's journal")
    check_launches("lm_serve", acc)

    decode_walls = [w for i, (_, w) in enumerate(steps) if i not in (0, TRACE_STEP)]
    line_a = {
        "arch": cfg.name, "params": n_params, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": "bfloat16", "batch": a["batch"],
        "prompt": a["prompt"], "new_tokens": a["new"], "max_seq": a["max_seq"],
        "kv_cache_gib": kv_gib, "init_s": init_s, "prefill_s": steps[0][1],
        "warm_prefill_s": tf[0]["prefill_s"], "decode_ms": step_ms(decode_walls),
        "traced_decode_step": {"index": TRACE_STEP, **step_profile(traced)}, "generate_s": gen_s,
        "tokens_per_s": out.size / gen_s, "decode_tokens_per_s": a["batch"] / np.median(decode_walls),
        "peak_gib": peak_gib, "logit_tol": LOGIT_TOL, "teacher_forcing": tf,
        "table_pages": len(eng.pager._table),
        "restart_1": {"rebuild_s": st1["rebuild_s"], "path": "first build",
                      "stage_s": st1["stage_s"]},
        "restart_2": {"rebuild_s": st2["rebuild_s"], "path": "incremental",
                      "replayed": st2["log_entries_replayed"], "stage_s": st2["stage_s"]},
        "standby": {"restart_s": standby_s, "applied_lsn": sst["applied_lsn"],
                    "lag_frames": sst["lag_frames"], "incremental": sst["incremental"]},
    }
    print(f"[lm_serve] {json.dumps(line_a)}; {card}", flush=True)
    del eng, standby, twin, params, model, steps, full
    gc.collect()
    torch.cuda.empty_cache()

    # -- part B: qwen3-moe at full width, two layers ---------------------------
    cfg_b = dataclasses.replace(ARCHS[MOE_SERVE["arch"]], n_layers=MOE_SERVE["layers"])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    models = {mode: LM(dataclasses.replace(cfg_b, dispatch_mode=mode), device=dev)
              for mode in ("sort", "einsum")}
    params = models["sort"].init(gen)
    torch.cuda.synchronize()
    init_b = time.perf_counter() - t0
    prompts = rng.integers(0, cfg_b.vocab_size, (a["batch"], a["prompt"]))
    runs = {}
    for mode, model in models.items():
        eng = ServeEngine(model, params, **opts)
        steps = []
        with dispatch_spy() as seen, recorded_logits(eng, steps):
            toks = eng.generate(prompts, MOE_SERVE["decode"])
        runs[mode] = {"tokens": toks, "steps": steps, **seen}
        del eng
    srt, ein = runs["sort"], runs["einsum"]
    check(len(srt["pos"]) == len(ein["pos"]) == MOE_SERVE["layers"] * (1 + MOE_SERVE["decode"]),
          f"{len(srt['pos'])} and {len(ein['pos'])} dispatches")
    check(all(same(p, q) for p, q in zip(srt["pos"], ein["pos"])),
          "sort and einsum dispatch positions differ")
    check(srt["dropped"] == ein["dropped"], "the dropped fractions differ")
    check(max(srt["key_bits"]) <= 32, f"a dispatch key took {max(srt['key_bits'])} bits")
    errs = [logit_stats(s[0], e[0]) for s, e in zip(srt["steps"], ein["steps"])]
    check(all(err <= MOE_LOGIT_TOL * scale for err, scale in errs),
          f"sort and einsum logits differ: {errs}")
    check(all(bool(torch.isfinite(lg).all()) for lg, _ in srt["steps"]),
          "a qwen3-moe step's logits are not finite")
    check(np.array_equal(srt["tokens"], ein["tokens"]), "sort and einsum tokens differ")
    line_b = {
        "arch": cfg_b.name, "layers": cfg_b.n_layers, "full_layers": ARCHS[cfg_b.name].n_layers,
        "params": lm_param_count(params), "experts": cfg_b.n_experts, "top_k": cfg_b.top_k,
        "init_s": init_b, "prefill_entries": int(srt["pos"][0].numel()),
        "prefill_key_bits": srt["key_bits"][0], "dropped_frac_prefill": srt["dropped"][:2],
        "max_logit_err": max(e for e, _ in errs), "logit_tol": MOE_LOGIT_TOL,
        **{f"{mode}_prefill_s": r["steps"][0][1] for mode, r in runs.items()},
        **{f"{mode}_decode_ms": step_ms([w for _, w in r["steps"][1:]])
           for mode, r in runs.items()},
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"[lm_serve] moe {json.dumps(line_b)}; {card}", flush=True)
    print(f"[lm_serve] launches {json.dumps(acc)}; llama3-8b decode == prefill within "
          f"{LOGIT_TOL} of the logits' scale at {len(TF_POSITIONS)} positions, both restarts "
          "== torch, every page found on the primary and the standby, freed pages gone; "
          "qwen3-moe sort == einsum dispatch byte for byte; "
          f"the phase took {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    del params, models, runs
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: the LM training path
# ---------------------------------------------------------------------------

#: [train] part A: the token pipeline at a corpus shard's size
TRAIN_SHUFFLE_DOCS = 10_000_000
TRAIN_DEDUP = {"docs": 262_144, "seq": 512, "vocab": 128_256, "dup_every": 8}
#: part B: llama3-8b at full width, depth cut from 32 layers to 4.  The
#: peak rate is 1e-5 with one warmup step: AdamW's first steps move every
#: entry by about +-lr, so a 4096-wide dot product moves by about 4096 lr;
#: at the default 3e-4 the loss rose from 12.5 to 21.0 in six steps on the
#: H100 (PERF.md, section 6)
TRAIN_LM = {"arch": "llama3-8b", "layers": 4, "batch": 4, "seq": 512, "steps": 6,
            "trace_step": 3, "lr": 1e-5}
#: accum=2 against accum=1 after one step from one start: the losses
#: within 1e-2 relative; each parameter within two learning rates (the
#: first AdamW step moves every entry by about +-lr, so a gradient near 0
#: whose sign the bf16 sums flip moves 2 lr apart) and the mean gap
#: within 5 % of a learning rate (few such flips)
ACCUM_LOSS_RTOL = 1e-2
ACCUM_MAX_LR = 2.0
ACCUM_MEAN_LR = 0.05
#: part D: llama3-8b at the reference's train_4k length (seq 4096), depth
#: cut as in part B and the global batch of 256 (accum 8, a pod's) cut to
#: 4 at accum 2, so one card takes a microbatch of 2 x 4096; rematerialised
TRAIN_4K = {"batch": 4, "seq": 4096, "accum": 2, "steps": 4, "trace_step": 3, "lr": 1e-5}
#: part C: repro-100m through the entry point, 20 steps, a resume to 30;
#: the resumed losses against an uninterrupted run's (the card's atomics
#: may reorder the embedding's gradient sums), relative
TRAIN_RUN = {"batch": 8, "seq": 256, "first": 20, "last": 30, "every": 10}
RESUME_LOSS_RTOL = 1e-3


def fnv1a_numpy(x: np.ndarray, seed: int) -> np.ndarray:
    """The shuffle's FNV-1a keys in plain numpy (u32 in, u32 out)."""
    h = np.full(x.shape, (0xCBF29CE484222325 ^ seed) & 0xFFFFFFFF, np.uint64)
    v = x.astype(np.uint64)
    for shift in (0, 8, 16, 24):
        h = (h ^ ((v >> np.uint64(shift)) & np.uint64(0xFF))) * np.uint64(0x01000193)
        h &= np.uint64(0xFFFFFFFF)
    return h.astype(np.uint32)


def first_occurrences(docs: np.ndarray) -> np.ndarray:
    """Ascending index of each distinct row's first occurrence, by numpy:
    ``np.unique(axis=0, return_index=True)`` over each row as one opaque
    item (the same groups; the order of the groups does not matter)."""
    rows = np.ascontiguousarray(docs).view(np.dtype((np.void, docs.shape[1] * 4))).ravel()
    return np.sort(np.unique(rows, return_index=True)[1])


def sync_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tree_bytes_equal(a: dict, b: dict) -> bool:
    from repro_torch.train.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same(x, y) for x, y in zip(la, lb))


def train_steps(step, params, opt, batch, n: int, trace_at: int, dev, after_first=None):
    """``n`` train steps on one batch from ``(params, opt)``, each ended by
    a synchronize, step ``trace_at`` under ``torch.profiler`` (left out of
    the walls); ``after_first(params, metrics)`` runs after the first.  The
    peak is counted from just before the first step, beside the memory
    allocated then (the state and whatever earlier phases keep).  Returns
    ``(params, opt, run)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = torch.cuda.memory_allocated(dev)
    run = {"walls": [], "losses": [], "grad_norms": [], "traced": {}, "trace_at": trace_at}
    for i in range(n):
        if i == trace_at:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                run["traced"].update(prof=prof, wall_s=time.perf_counter() - t0)
        else:
            (params, opt, m), wall = sync_wall(lambda: step(params, opt, batch))
            run["walls"].append(wall)
        if i == 0:
            run["lr"] = float(m["lr"])
            if after_first is not None:
                after_first(params, m)
        run["losses"].append(float(m["loss"]))
        run["grad_norms"].append(float(m["grad_norm"]))
    run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    run["state_gib"] = state / 2**30
    return params, opt, run


def autograd_memory(model, params: dict, batch: dict, dev) -> dict:
    """What one forward and backward of ``model.loss`` take on the card
    beyond the memory allocated before them: what autograd holds once the
    forward has run (the activations), and the peak through the backward
    (the gradient tree included).  The gradients are dropped."""
    from repro_torch.train.optim import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    loss, _ = model.loss(live, batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    grads = torch.autograd.grad(loss, tree_leaves(live))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    del loss, grads, live
    return {"held_after_forward_gib": held / 2**30, "forward_backward_peak_gib": peak / 2**30}


def param_gaps(params: dict, host: list, lr: float, n_params: int) -> dict:
    """How far ``params`` lie from a host copy of another run's: the
    largest and the mean gap, and the entries more than ``lr`` apart."""
    from repro_torch.train.optim import tree_leaves

    max_gap, sum_gap, flips = 0.0, 0.0, 0
    for a, h in zip(tree_leaves(params), host):
        gap = (a - h.to(a.device)).abs()
        max_gap = max(max_gap, float(gap.max()))
        sum_gap += float(gap.sum(dtype=torch.float64))
        flips += int((gap > lr).sum())
        del gap
    return {"max_param_gap": max_gap, "mean_param_gap": sum_gap / n_params,
            "entries_over_lr": flips}


def train_phase(args, dev, launches: dict) -> None:
    """Phase 18: the LM training path.  Part A: the token pipeline on
    ``"cuda"`` at a corpus shard's size: ``shuffle_order`` over 10M
    document ids (== ``"torch"`` on the card == numpy's lexsort of
    ``(fnv1a(seed||doc), doc)``) and ``dedup_tokens`` over 262,144
    ``lm_tokens`` documents of 513 tokens (vocab 128,256), one in eight a
    copy of another row at a seeded position (== ``"torch"`` == numpy's
    first occurrences); pext and dbit held against their plain versions
    at the dedup's 513-word keys.  Part B: llama3-8b at its full width
    with its 32 layers cut to 4 (1.92 B parameters: f32 master weights,
    gradients and both AdamW moments of the full 8.03 B would need about
    128 GB), master weights from the seed on the card, batch 4 x 512 from
    a ``TokenPipeline`` over an ``lm_tokens`` corpus on ``"cuda"``:
    one ``accum=2`` step against one ``accum=1`` step from the same start,
    and one step of ``remat=False`` against one of the default remat (the
    losses equal to the bit), then six ``accum=1`` steps on the repeated
    batch (finite losses and norms, the first within 1.0 of ln V, the last
    below the first), one traced, and two more without remat, one traced;
    what one forward holds and the backward's peak, with remat and
    without.  Part D: the same model at ``train_4k``'s 4096 tokens, 4 x
    4096 at ``accum=2``, rematerialised: four steps on one batch (finite,
    falling), one traced, what a microbatch's forward holds, and the peak
    without remat reckoned from part B's.  Part C: ``repro_torch.launch.train.main`` at repro-100m's
    full size, 20 steps of 8 x 256 with checkpoints every 10, then a
    resume to 30 whose manifest index is rebuilt on ``"cuda"``: the
    restored tree == the saved one byte for byte, the resumed losses ==
    an uninterrupted 30-step run's within the tolerance.  Everything but
    the checks is the path, counted from 0."""
    from repro_torch.data import pipeline as data_pipeline
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optim import OptConfig, adamw_init, tree_leaves
    from repro_torch.train.trainstep import make_train_step

    t_phase = time.perf_counter()
    card = card_line()
    acc = launches.setdefault("train", {})

    # -- part A: the token pipeline ---------------------------------------------
    seed = args.seed + 61
    part_a = {}
    with counted(part_a):
        order, shuffle_s = sync_wall(lambda: data_pipeline.shuffle_order(
            TRAIN_SHUFFLE_DOCS, seed, backend="cuda", device=dev))
    add_launches(acc, part_a)
    order_t, shuffle_torch_s = sync_wall(lambda: data_pipeline.shuffle_order(
        TRAIN_SHUFFLE_DOCS, seed, backend="torch", device=dev))
    check(same(order, order_t), "shuffle_order: cuda != torch")
    doc = np.arange(TRAIN_SHUFFLE_DOCS, dtype=np.uint32)
    check(np.array_equal(order.cpu().numpy(), np.lexsort((doc, fnv1a_numpy(doc, seed)))),
          "shuffle_order != numpy's lexsort of (fnv1a(seed||doc), doc)")
    doc_t = torch.arange(TRAIN_SHUFFLE_DOCS, device=dev)
    shuffle_plan = make_plan(to_u32(compute_dbitmap(torch.stack(
        [data_pipeline._fnv1a_vec(doc_t, seed), doc_t], dim=1), dbitmap_fn=adjacent_dbitmap)), 2)
    del order_t, doc, doc_t
    d = TRAIN_DEDUP
    t0 = time.perf_counter()
    docs = lm_tokens(d["docs"], d["seq"] + 1, d["vocab"], seed=seed)
    drng = np.random.default_rng(seed)
    n_dup = d["docs"] // d["dup_every"]
    docs[drng.permutation(d["docs"])[:n_dup]] = docs[drng.integers(0, d["docs"], n_dup)]
    docs_s = time.perf_counter() - t0
    dedup_l = {}
    with counted(dedup_l):
        kept, dedup_s = sync_wall(lambda: data_pipeline.dedup_tokens(docs, backend="cuda",
                                                                     device=dev))
    add_launches(acc, dedup_l)
    kept_t, dedup_torch_s = sync_wall(lambda: data_pipeline.dedup_tokens(
        docs, backend="torch", device=dev))
    check(same(kept, kept_t), "dedup_tokens: cuda != torch")
    want = first_occurrences(docs)
    check(np.array_equal(kept.cpu().numpy(), want), "dedup_tokens != numpy's first occurrences")
    # the dedup's kernels at its own 513-word keys, against the plain versions
    words = torch.as_tensor(docs, device=dev).to(torch.int64) & 0xFFFFFFFF
    sorted_words = sort_words(words)[0]
    bm = adjacent_dbitmap(sorted_words)
    check(same(bm, adjacent_dbitmap_plain(sorted_words)),
          "dbit bitmap form != plain at the dedup's 513-word keys")
    check(same(adjacent_dbits(sorted_words), adjacent_dbits_plain(sorted_words)),
          "dbit positions form != plain at the dedup's 513-word keys")
    plan = make_plan(to_u32(bm), int(words.shape[1]))
    check(same(pext(words, plan), pext_plain(words, plan)),
          "pext kernel != plain at the dedup's 513-word keys")
    line_a = {
        "shuffle": {"docs": TRAIN_SHUFFLE_DOCS, "cuda_s": shuffle_s, "torch_s": shuffle_torch_s,
                    "dbitmap_bits": shuffle_plan.n_bits,
                    "compressed_words": shuffle_plan.n_words_out,
                    "launches": {k: part_a[k] for k in ("pext", "bitonic_block_sort", "dbit")}},
        "dedup": {"docs": d["docs"], "tokens": d["seq"] + 1, "vocab": d["vocab"],
                  "copies_planted": n_dup, "kept": int(kept.numel()), "cuda_s": dedup_s,
                  "torch_s": dedup_torch_s, "corpus_s": docs_s,
                  "dbitmap_bits": plan.n_bits, "compressed_words": plan.n_words_out,
                  "launches": {k: dedup_l[k] for k in ("pext", "bitonic_block_sort", "dbit")}},
    }
    print(f"[train] pipeline {json.dumps(line_a)}; {card}", flush=True)
    del order, kept, kept_t, docs, words, sorted_words
    gc.collect()
    torch.cuda.empty_cache()

    # -- part B: llama3-8b at full width, four layers ---------------------------
    tl = TRAIN_LM
    cfg = dataclasses.replace(ARCHS[tl["arch"]], n_layers=tl["layers"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model = LM(cfg, device=dev)

    def master():  # the same start every time: a generator seeded anew
        return model.init_master(torch.Generator(device=dev).manual_seed(args.seed + 62))

    params, init_s = sync_wall(master)
    n_params = lm_param_count(params)
    corpus = lm_tokens(max(tl["batch"] * 64, 512), tl["seq"] + 1, cfg.vocab_size,
                       seed=args.seed + 62)
    with counted(acc):
        pipe = data_pipeline.TokenPipeline(corpus, tl["batch"], tl["seq"], seed=args.seed + 62,
                                           device=dev)
        batch = pipe.batch_at(0)
    opt_cfg = OptConfig(peak_lr=tl["lr"], warmup_steps=1)
    step1 = make_train_step(model, opt_cfg, accum=1)
    step2 = make_train_step(model, opt_cfg, accum=2)
    # accum=2 against accum=1, one step each from the same start (a step
    # updates the state it is given, so the start is made again)
    (p_a, o_a, m_a), accum2_s = sync_wall(lambda: step2(params, adamw_init(params), batch))
    # host RAM (a copy even of a host tensor): the card holds one state
    p_a_host = [t.to("cpu", copy=True) for t in tree_leaves(p_a)]
    del p_a, o_a, params
    gc.collect()
    # remat off: one step from the same start on the same batch, held against
    # remat's first below, then a timed step and a traced one
    model_off = LM(cfg, device=dev, remat=False)
    step_off = make_train_step(model_off, opt_cfg, accum=1)
    first_off = {}

    def keep_first_off(p, m):
        first_off.update(loss=m["loss"].clone(),
                         host=[t.to("cpu", copy=True) for t in tree_leaves(p)])

    params = master()
    params, opt, off = train_steps(step_off, params, adamw_init(params), batch, 3, 2, dev,
                                   keep_first_off)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    gaps = {}

    def hold_first_on(p, m):
        lr = float(m["lr"])
        gaps["accum"] = param_gaps(p, p_a_host, lr, n_params)
        gaps["remat"] = param_gaps(p, first_off.pop("host"), lr, n_params)
        gaps["remat_loss_equal"] = bool(torch.equal(m["loss"], first_off["loss"]))

    params = master()
    params, opt, on = train_steps(step1, params, adamw_init(params), batch, tl["steps"],
                                  tl["trace_step"], dev, hold_first_on)
    del p_a_host
    gc.collect()
    losses, gnorms, lr = on["losses"], on["grad_norms"], on["lr"]
    accum_rel = abs(float(m_a["loss"]) - losses[0]) / abs(losses[0])
    tokens = tl["batch"] * tl["seq"]
    remat = {name: {"first_step_ms": run["walls"][0] * 1e3, "step_ms": step_ms(run["walls"][1:]),
                    "peak_gib": run["peak_gib"], "state_gib": run["state_gib"],
                    **autograd_memory(m, params, batch, dev),
                    "traced_step": {"index": run["trace_at"], **step_profile(run["traced"])}}
             for name, run, m in (("on", on, model), ("off", off, model_off))}
    line_b = {
        "arch": cfg.name, "layers": cfg.n_layers, "full_layers": ARCHS[cfg.name].n_layers,
        "params": n_params, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "compute_dtype": "bfloat16", "master_dtype": "float32", "batch": tl["batch"],
        "seq": tl["seq"], "init_s": init_s, "losses": losses, "grad_norms": gnorms, "lr": lr,
        "first_step_s": on["walls"][0], "accum2_step_s": accum2_s,
        "step_ms": step_ms(on["walls"][1:]),
        "tokens_per_s": tokens / float(np.median(on["walls"][1:])),
        "traced_step": remat["on"]["traced_step"], "peak_gib": on["peak_gib"],
        "accum": {"loss_1": losses[0], "loss_2": float(m_a["loss"]), "loss_rel": accum_rel,
                  **gaps["accum"]},
        "remat": {**remat, "loss_on": losses[0], "loss_off": off["losses"][0],
                  "losses_equal": gaps["remat_loss_equal"], **gaps["remat"]},
    }
    print(f"[train] llama3-8b {json.dumps(line_b)}; {card}", flush=True)
    check(accum_rel <= ACCUM_LOSS_RTOL,
          f"accum=2 loss {float(m_a['loss'])} vs accum=1 {losses[0]}")
    for what in ("accum", "remat"):
        g = gaps[what]
        check(g["max_param_gap"] <= ACCUM_MAX_LR * lr * (1 + 1e-3)
              and g["mean_param_gap"] <= ACCUM_MEAN_LR * lr,
              f"{what}: parameters {g['max_param_gap']} (max) and {g['mean_param_gap']} "
              f"(mean) apart after one step, lr {lr}")
    check(gaps["remat_loss_equal"],
          f"remat loss {losses[0]} != no-remat loss {off['losses'][0]} (to the bit)")
    check(all(np.isfinite(losses + off["losses"])) and all(np.isfinite(gnorms)),
          f"a loss or gradient norm is not finite: {losses} {off['losses']} {gnorms}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 1.0,
          f"first loss {losses[0]} is not within 1.0 of ln {cfg.vocab_size}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    del params, opt, m_a, pipe, batch, on, off, model_off
    gc.collect()
    torch.cuda.empty_cache()

    # -- part D: llama3-8b at train_4k's length, rematerialised ----------------
    t4 = TRAIN_4K
    params = master()
    corpus = lm_tokens(max(t4["batch"] * 64, 512), t4["seq"] + 1, cfg.vocab_size,
                       seed=args.seed + 64)
    with counted(acc):
        pipe = data_pipeline.TokenPipeline(corpus, t4["batch"], t4["seq"], seed=args.seed + 64,
                                           device=dev)
        batch = pipe.batch_at(0)
    step4 = make_train_step(model, OptConfig(peak_lr=t4["lr"], warmup_steps=1),
                            accum=t4["accum"])
    params, opt, d4 = train_steps(step4, params, adamw_init(params), batch, t4["steps"],
                                  t4["trace_step"], dev)
    tokens_4k = t4["batch"] * t4["seq"]
    micro_rows = t4["batch"] // t4["accum"]
    held = autograd_memory(model, params, {k: v[:micro_rows] for k, v in batch.items()}, dev)
    steady = d4["walls"][1:]
    # without remat, reckoned: what part B's forward held without remat,
    # per token, at the microbatch's tokens (attention's blocks grow with the
    # square of the length, so this is a floor)
    held_off = remat["off"]["held_after_forward_gib"] / tokens * micro_rows * t4["seq"]
    line_d = {
        "arch": cfg.name, "layers": cfg.n_layers, "full_layers": ARCHS[cfg.name].n_layers,
        "shape": "train_4k", "seq": t4["seq"], "batch": t4["batch"], "accum": t4["accum"],
        "microbatch": [t4["batch"] // t4["accum"], t4["seq"]], "remat": True,
        "reduced": ["n_layers 32 -> 4 (f32 master state of 8.03 B parameters needs about "
                    "128 GB)", "global batch 256 at accum 8 -> 4 at accum 2 (a pod's batch; "
                    "one card takes a microbatch of 2 x 4096)"],
        "losses": d4["losses"], "grad_norms": d4["grad_norms"], "lr": d4["lr"],
        "first_step_s": d4["walls"][0], "step_ms": step_ms(steady),
        "tokens_per_s": tokens_4k / float(np.median(steady)),
        "peak_gib": d4["peak_gib"], "state_gib": d4["state_gib"], "microbatch_memory": held,
        "traced_step": {"index": d4["trace_at"], **step_profile(d4["traced"])},
        "reckoned_held_after_forward_without_remat_gib_at_least": held_off,
        # a microbatch's backward runs beside the state and the accumulator
        "reckoned_peak_without_remat_gib_at_least":
            d4["state_gib"] + n_params * 4 / 2**30 + held["forward_backward_peak_gib"]
            - held["held_after_forward_gib"] + held_off,
    }
    print(f"[train] llama3-8b train_4k {json.dumps(line_d)}; {card}", flush=True)
    check(all(np.isfinite(d4["losses"])) and all(np.isfinite(d4["grad_norms"])),
          f"train_4k: a loss or gradient norm is not finite: {d4['losses']}")
    check(d4["losses"][-1] < d4["losses"][0],
          f"train_4k: the loss did not fall: {d4['losses']}")
    del params, opt, model, pipe, batch, d4
    gc.collect()
    torch.cuda.empty_cache()

    # -- part C: the entry point, a checkpoint and a resume ---------------------
    c = TRAIN_RUN
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        common = ["--arch", "repro-100m", "--batch", str(c["batch"]), "--seq", str(c["seq"]),
                  "--log-every", "10", "--seed", str(args.seed + 63)]
        run_dir, ref_dir = root / "run", root / "straight"
        with counted(acc):
            first = launch_train.main(common + ["--steps", str(c["first"]), "--ckpt-every",
                                                str(c["every"]), "--ckpt-dir", str(run_dir)])
        (back, stats) = restore_checkpoint(run_dir, c["first"], (first["params"], first["opt"]),
                                           device=dev, index_device=dev)
        check(tree_bytes_equal(back[0], first["params"]) and tree_bytes_equal(back[1],
                                                                               first["opt"]),
              "the restored train state differs from the saved one")
        del back
        resume_l = {}
        with counted(resume_l):
            second = launch_train.main(common + ["--steps", str(c["last"]), "--ckpt-every",
                                                 str(c["every"]), "--ckpt-dir", str(run_dir)])
        add_launches(acc, resume_l)
        check(second["restored"]["index_backend"] == "cuda"
              and second["restored"]["meta"]["step"] == c["first"],
              f"the resume did not restore step {c['first']} on cuda: {second['restored']}")
        check(resume_l["pk_window"] > 0 and resume_l["probe"] > 0,
              f"the restore launched no pk-window or probe kernel: {resume_l}")
        with counted(acc):
            straight = launch_train.main(common + ["--steps", str(c["last"]), "--ckpt-every",
                                                   "1000", "--ckpt-dir", str(ref_dir)])
        got = {**first["losses"], **second["losses"]}
        want = straight["losses"]
        check(sorted(got) == sorted(want) == list(range(1, c["last"] + 1)),
              "the runs' steps differ")
        rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in want)
        check(rel <= RESUME_LOSS_RTOL and all(np.isfinite(list(got.values()))),
              f"resumed losses differ from the uninterrupted run's by {rel}")
        step_dir = run_dir / f"step_{c['first']:08d}"
        line_c = {
            "arch": "repro-100m", "params": lm_param_count(first["params"]),
            "batch": c["batch"], "seq": c["seq"], "steps": c["last"],
            "tokens_per_s": {"first": first["tokens_per_s"], "resumed": second["tokens_per_s"],
                             "straight": straight["tokens_per_s"]},
            "losses": [got[s] for s in sorted(got)], "max_resume_rel": rel,
            "index_rebuild_ms": second["restored"]["index_rebuild_s"] * 1e3,
            "restore_leaves": second["restored"]["n_leaves"],
            "index_height": second["restored"]["index_height"],
            "compression_ratio": second["restored"]["compression_ratio"],
            "checkpoint_bytes": dir_bytes(step_dir),
            "checkpoint_walls_s": [s["wall_s"] for s in first["saves"] + second["saves"]],
            "restore_launches": {k: resume_l[k] for k in ("pk_window", "probe", "pext",
                                                          "bitonic_block_sort", "dbit")},
        }
        print(f"[train] launch {json.dumps(line_c)}; {card}", flush=True)
        del first, second, straight
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_launches("train", acc)
    print(f"[train] launches {json.dumps(acc)}; shuffle and dedup on cuda == torch == numpy; "
          "pext and dbit == plain at 513-word keys; llama3-8b (4 of 32 layers) accum=2 == "
          "accum=1 and remat == no remat within the stated bounds (losses equal to the bit), "
          "loss falling over 6 steps, and over 4 at seq 4096; repro-100m resumed "
          f"through the index on cuda == an uninterrupted run within {RESUME_LOSS_RTOL}; "
          f"the phase took {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: the example twins
# ---------------------------------------------------------------------------


def example_twin(name: str):
    """``examples/<name>.py`` loaded as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_phase(args, dev, launches: dict) -> None:
    """Phase 19: the three example twins through their ``main(argv)`` on
    the card, each timed and held to what its run shows.  The train twin
    trains repro-100m 30 steps with checkpoints at 25 and 30; with step
    30's checkpoint removed, a second run resumes from 25 and its losses
    equal the first run's within ``RESUME_LOSS_RTOL``.  The serve twin's
    restart rebuilds the page index and finds sequence 2's page 1 at the
    page the table holds.  The replication twin's replica B catches up
    through the checkpoint chain and ends byte-identical to A and the
    primary.  The runs are the path, counted from 0; the checks are not."""
    t_phase = time.perf_counter()
    card = card_line()
    acc = launches.setdefault("examples", {})
    walls = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    try:
        train_twin = example_twin("train_lm_torch")
        argv = ["--quick", "--ckpt-dir", str(root / "train")]
        with counted(acc):
            first, walls["train_lm"] = sync_wall(lambda: train_twin.main(argv))
        check([s["step"] for s in first["saves"]] == [25, 30]
              and sorted(first["losses"]) == list(range(1, 31))
              and all(np.isfinite(list(first["losses"].values()))),
              f"train_lm_torch --quick: saves {first['saves']}, losses {first['losses']}")
        shutil.rmtree(root / "train" / "step_00000030")
        with counted(acc):
            second, walls["train_lm_resume"] = sync_wall(lambda: train_twin.main(argv))
        check(second["restored"]["meta"]["step"] == 25
              and sorted(second["losses"]) == list(range(26, 31)),
              f"train_lm_torch did not resume from step 25: {second['restored']}")
        rel = max(abs(second["losses"][k] - first["losses"][k]) / abs(first["losses"][k])
                  for k in second["losses"])
        check(rel <= RESUME_LOSS_RTOL, f"train_lm_torch's resumed losses differ by {rel}")
        del first, second
        with counted(acc):
            served, walls["serve_moe"] = sync_wall(lambda: example_twin("serve_moe_torch").main(
                []))
        table = served["engine"].pager._table
        check(served["tokens"].shape == (4, 16) and served["restart"]["backend"] == "cuda"
              and served["page"] is not None and served["page"] == table[(2, 1)],
              f"serve_moe_torch: restart {served['restart']}, page {served['page']}")
        del served
        with counted(acc):
            replicated, walls["replication"] = sync_wall(
                lambda: example_twin("replication_torch").main(["--fast"]))
        check(replicated["catchup"] and replicated["a_equals_b"]
              and replicated["a_equals_primary"],
              f"replication_torch --fast: {replicated}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_launches("examples", acc)
    line = {"walls_s": walls, "train_lm_resume_max_rel": rel, "replication": replicated,
            "launches": acc, "phase_s": time.perf_counter() - t_phase}
    print(f"[examples] {json.dumps(line, default=str)}; {card}", flush=True)
    print("[examples] train_lm_torch resumed from its checkpoint == its first run; "
          "serve_moe_torch's restart found the page; replication_torch's replicas "
          f"byte-identical to the primary; {card}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: the distributed backend, four gloo ranks sharing the card
# ---------------------------------------------------------------------------

def digest(t) -> str:
    """SHA-256 of a tensor or array as u32 bytes (flags as 0/1 words)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return hashlib.sha256(np.ascontiguousarray(a.astype(np.uint32)).tobytes()).hexdigest()


def result_digests(res) -> dict:
    """Digests of a result's sorted run, row and rid permutations, every
    tree array and the refreshed meta: what ``results_equal`` compares."""
    out = {name: digest(getattr(res, name)) for name in ("comp_sorted", "row_sorted",
                                                         "rid_sorted")}
    out.update({f"tree.{k}": digest(v) for k, v in tree_arrays(res.tree).items()})
    out.update({f"meta.{f}": digest(getattr(res.meta, f))
                for f in ("dbitmap", "varbitmap", "refkey")})
    return out


def dist_tenants(seed: int) -> list:
    """``[mt_load]``'s eight tenants: 2^17 distinct masked four-word keys
    each, drawn as ``run_multitenant_load`` draws them."""
    return [_probe_keyset_exact(np.random.default_rng(seed + 1000 * (t + 1)),
                                DIST_TENANT_KEYS, 4) for t in range(DIST_TENANTS)]


def dist_parts(keyset: KeySet) -> list:
    """Eight disjoint parts of phase 3's keyset (262,144 keys each at full
    size)."""
    m = min(DIST_PART_KEYS, keyset.n // DIST_PARTS)
    return [KeySet(words=keyset.words[i * m:(i + 1) * m],
                   lengths=keyset.lengths[i * m:(i + 1) * m],
                   rids=keyset.rids[i * m:(i + 1) * m]) for i in range(DIST_PARTS)]


def skewed_input(n: int = 4 * 1024) -> tuple[np.ndarray, np.ndarray]:
    """The reference's overflow input (``tests/test_pipeline.py:171-200``):
    nearly every key in one bucket."""
    rng = np.random.default_rng(0)
    words = np.zeros((n, 2), dtype=np.uint32)
    words[: n - 8, 1] = 1
    words[n - 8:, 0] = rng.integers(1, 2**31, 8).astype(np.uint32)
    return words, np.arange(n, dtype=np.uint32)


def dist_rank(rank: int, p: int, data_dir: str, seed: int) -> dict:
    """One rank of phase 16 (runs in a spawned process, on its current
    CUDA device): the main paths through the ``"distributed"`` backend on
    the inputs the parent wrote, each output as digests, with the
    backend's ``last_info``, walls, peak memory and kernel launches."""
    from repro_torch.core.distsort import sample_sort
    from repro_torch.core.metadata import DSMeta

    dev = torch.device("cuda", torch.cuda.current_device())
    cudalib.lib()
    torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        torch.cuda.synchronize(dev)

    d = Path(data_dir)

    def load(name):
        return np.load(d / f"{name}.npy")

    keyset = KeySet(words=load("words"), lengths=load("lengths"), rids=load("rids"))
    meta_of = {pre: DSMeta(dbitmap=load(f"{pre}_dbitmap"), varbitmap=load(f"{pre}_varbitmap"),
                           refkey=load(f"{pre}_refkey"), n_words=keyset.n_words)
               for pre in ("union", "slice")}
    out: dict = {"digests": {}, "info": {}, "walls": {}}
    cudalib.reset_launches()
    pipe = ReconstructionPipeline(backend="distributed", chunk_threshold=1 << 24, device=dev)
    be = pipe.backend

    # 1. run: the sample sort at --n-keys, unchunked
    t0 = time.perf_counter()
    res = pipe.run(keyset)
    out["walls"]["run_s"] = time.perf_counter() - t0
    out["walls"]["run_timings_s"] = {k: res.timings[k] for k in ("meta", "extract", "sort",
                                                                  "build", "refresh_meta")}
    out["sample_sort"] = dict(be.last_timings)
    out["sort_rows"] = {"exchange_rows": be.last_timings["exchange_bytes"]
                        // 4 // (int(res.comp_sorted.shape[1]) + 2)}
    out["info"]["run"] = dict(be.last_info)
    out["digests"]["run"] = result_digests(res)

    # 2. run_incremental on phase 6's delta: the routed merge
    delta = KeySet(words=load("delta_words"), lengths=load("delta_lengths"),
                   rids=load("delta_rids"))
    prev = pipe.run(keyset, meta=meta_of["union"])
    t0 = time.perf_counter()
    inc, _ = pipe.run_incremental(prev, keyset, delta, keep_rows=load("keep"),
                                  meta=meta_of["union"])
    out["walls"]["incremental_s"] = time.perf_counter() - t0
    out["info"]["incremental"] = dict(be.last_info, incremental=inc.stats["incremental"])
    out["digests"]["incremental"] = result_digests(inc)
    del prev, inc

    # 3. the 2^18-query batch through the routed lookup
    q = to_carrier(load("queries"), dev)
    be.lookup(res.tree, q)  # capture
    sync()
    t0 = time.perf_counter()
    found, rid = be.lookup(res.tree, q)
    sync()
    out["walls"]["lookup_s"] = time.perf_counter() - t0
    out["info"]["lookup"] = dict(be.last_info)
    out["digests"]["lookup"] = {"found": digest(found), "rid": digest(rid)}
    del res, found, rid, q
    plancache.reset_cache()  # the 2^18 graph's buffers and pool

    # 4. lookup_many over eight tenants, two a rank
    trees = [pipe.run(ks).tree for ks in dist_tenants(seed)]
    stacked = btree.stack_trees(trees)
    del trees
    tq = to_carrier(load("tenant_queries"), dev)
    t0 = time.perf_counter()
    found, rid = be.lookup_many(stacked, tq)
    sync()
    out["walls"]["lookup_many_s"] = time.perf_counter() - t0
    out["info"]["lookup_many"] = dict(be.last_info)
    out["digests"]["lookup_many"] = {"found": digest(found), "rid": digest(rid)}
    del stacked, found, rid, tq
    plancache.reset_cache()

    # 5. run_many over eight parts of the slice, two a rank
    t0 = time.perf_counter()
    many = pipe.run_many(dist_parts(keyset), [meta_of["slice"]] * DIST_PARTS)
    out["walls"]["run_many_s"] = time.perf_counter() - t0
    out["info"]["run_many"] = dict(be.last_info, batched=[r.stats.get("batched") for r in many])
    out["digests"]["run_many"] = [result_digests(r) for r in many]
    del many

    # 6. the skewed input at capacity 0.5: reported, then retried
    words_s, rows_s = skewed_input()
    raw = sample_sort(to_carrier(words_s, dev), to_carrier(rows_s, dev), capacity_factor=0.5)
    skew_be = get_backend("distributed", device=dev, capacity_factor=0.5)
    sk, sr = skew_be.sort(to_carrier(words_s, dev), to_carrier(rows_s, dev))
    out["info"]["skew"] = dict(skew_be.last_info, raw_overflow=raw.overflow)
    out["digests"]["skew"] = {"keys": digest(sk), "rows": digest(sr)}

    sync()
    out["launches"] = path_launches()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def distributed_phase(args, dev, res, keyset, data: dict, launches: dict) -> None:
    """Phase 16: the ``"distributed"`` backend.  Four gloo ranks share the
    card (``repro_torch.tools.rankgroup``) and run the slice, phase 6's
    incremental fold, phase 4's lookup batch, ``lookup_many`` over eight
    ``[mt_load]``-shaped tenants, ``run_many`` over eight parts of the
    slice and the skewed overflow input, each equal by digest to the
    ``"cuda"`` results and to every other rank's; then a one-rank NCCL
    group in this process runs the slice, equal to phase 3."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.tools.rankgroup import run_group

    t_phase = time.perf_counter()
    d = data["dir"]
    want = data["digests"]
    # the "cuda" results the ranks are held to, beyond phases 3, 4 and 6
    cuda_pipe = ReconstructionPipeline(backend="cuda", chunk_threshold=1 << 24, device=dev)
    tenants = dist_tenants(args.seed)
    rng = np.random.default_rng(args.seed + 41)
    tq = np.stack([make_queries(ks.words, rng, TENANT_QUERIES, ks.rids)[0] for ks in tenants])
    np.save(d / "tenant_queries.npy", tq)
    stacked = btree.stack_trees([cuda_pipe.run(ks).tree for ks in tenants])
    found, rid = cuda_pipe.backend.lookup_many(stacked, to_carrier(tq, dev))
    want["lookup_many"] = {"found": digest(found), "rid": digest(rid)}
    del stacked, found, rid
    want["run_many"] = [result_digests(r) for r in cuda_pipe.run_many(
        dist_parts(keyset), [res.meta] * DIST_PARTS)]
    words_s, rows_s = skewed_input()
    order = np.lexsort(tuple(np.concatenate([words_s, rows_s[:, None]], axis=1).T[::-1]))
    want["skew"] = {"keys": digest(words_s[order]), "rows": digest(rows_s[order])}
    for f in ("dbitmap", "varbitmap", "refkey"):
        np.save(d / f"slice_{f}.npy", getattr(res.meta, f))
    del cuda_pipe
    # give the ranks the card: drop this process's graphs and cached blocks
    plancache.reset_cache()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_group(dist_rank, DIST_RANKS, str(d), args.seed, timeout=120.0, deadline=600.0)
    group_wall = time.perf_counter() - t0
    acc: dict = {}
    for r, out in enumerate(ranks):
        add_launches(acc, out["launches"])
        for case, got in out["digests"].items():
            check(got == want[case], f"rank {r}: {case} differs from the cuda result")
            check(got == ranks[0]["digests"][case], f"rank {r}: {case} differs from rank 0")
        info = out["info"]
        check(info["run"]["mesh_devices"] == DIST_RANKS and info["run"]["overflow"] == 0,
              f"rank {r}: run {info['run']}")
        check(info["incremental"]["incremental"] is True
              and sum(info["incremental"]["delta_routed"]) == data["n_delta"],
              f"rank {r}: incremental {info['incremental']}")
        routed = info["lookup"]["lookup_routed"]
        check(sum(routed) == BATCH and sum(1 for c in routed if c) >= 2,
              f"rank {r}: lookup routed {routed}")
        check(info["lookup_many"]["tenants_per_shard"] == DIST_TENANTS // DIST_RANKS,
              f"rank {r}: lookup_many {info['lookup_many']}")
        check(info["run_many"]["batch_per_shard"] == DIST_PARTS // DIST_RANKS
              and info["run_many"]["batched"] == [DIST_PARTS] * DIST_PARTS,
              f"rank {r}: run_many {info['run_many']}")
        skew = info["skew"]
        check(skew["raw_overflow"] > 0 and skew["overflow"] == 0
              and skew["capacity_retries"] >= 1, f"rank {r}: skewed input {skew}")
        ss, rows = out["sample_sort"], out["sort_rows"]["exchange_rows"]
        line = {
            "rank": r, "run_wall_s": out["walls"]["run_s"],
            "run_timings_s": out["walls"]["run_timings_s"],
            "sample_sort_s": ss["sort_s"], "spread_exchange_s": ss["spread_s"],
            "spread_bytes": ss["spread_bytes"], "exchange_s": ss["exchange_s"],
            "exchange_bytes": ss["exchange_bytes"],
            # the same exchange with the 16-word full keys: rows x (W + rid + valid)
            "exchange_bytes_full_keys": rows * (keyset.n_words + 2) * 4,
            "gather_s": ss["gather_s"],
            "capacity_retries": info["run"]["capacity_retries"],
            "capacity_factor": info["run"]["capacity_factor"],
            "incremental_s": out["walls"]["incremental_s"],
            "delta_routed": info["incremental"]["delta_routed"],
            "lookup_s": out["walls"]["lookup_s"], "lookup_routed": routed,
            "lookup_many_s": out["walls"]["lookup_many_s"],
            "run_many_s": out["walls"]["run_many_s"],
            "skew_capacity_retries": skew["capacity_retries"],
            "skew_overflow_at_0.5": skew["raw_overflow"], "peak_gib": out["peak_gib"],
        }
        print(f"[distributed] {json.dumps(line)}", flush=True)

    # one rank of NCCL in this process: p == 1, the slice == phase 3
    nccl_dir = Path(tempfile.mkdtemp(prefix="nccl-", dir=d))
    dist.init_process_group("nccl", init_method=f"file://{nccl_dir / 'rendezvous'}",
                            world_size=1, rank=0, timeout=timedelta(seconds=120))
    try:
        with counted(acc):
            pipe_n = ReconstructionPipeline(backend="distributed", chunk_threshold=1 << 24,
                                            device=dev)
            check(pipe_n.backend.p == 1, "the NCCL group is not one rank")
            t0 = time.perf_counter()
            res_n = pipe_n.run(keyset)
            nccl_wall = time.perf_counter() - t0
        results_equal(res_n, res, "one-rank NCCL group vs cuda")
        check(res_n.stats["mesh_devices"] == 1 and res_n.stats["overflow"] == 0,
              f"NCCL run stats {res_n.stats}")
    finally:
        dist.destroy_process_group()
    del res_n, pipe_n
    launches["distributed"] = acc
    check_launches("distributed", acc)
    summary = {
        "ranks": DIST_RANKS, "transport": "gloo over host loopback, four ranks sharing one card",
        "group_wall_s": group_wall, "nccl_one_rank_run_s": nccl_wall,
        "phase_s": time.perf_counter() - t_phase, "launches": acc,
    }
    print(f"[distributed] {json.dumps(summary)}", flush=True)
    print(f"[distributed] {DIST_RANKS} gloo ranks: run, run_incremental, the routed lookup, "
          "lookup_many, run_many and the skewed retry == cuda on every rank; one NCCL rank's "
          "run == phase 3", flush=True)


#: phase 20 ([mesh]): llama3-8b at full width with its 32 layers cut to 4,
#: as in [train] part B, on a (2, 2) ("data", "model") mesh of four ranks
#: sharing the card; one step at accum 1, then one at accum 2, each held
#: against the same step on one rank (the tolerances of [train]'s accum
#: comparison: tensor parallelism splits the bf16 sums of wo, w2 and the
#: head, so neither the loss nor the parameters are equal to the bit)
MESH = {"arch": "llama3-8b", "layers": 4, "batch": 4, "seq": 512, "lr": 1e-5,
        "shape": (2, 2), "axes": ("data", "model")}
MESH_RANKS = 4


def tree_digests(tree) -> dict:
    """SHA-256 of each leaf's bytes, by path: a DTensor leaf gathered whole
    (a collective: every rank of its mesh calls this)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.checkpoint import _leaves

    out = {}
    for path, leaf in _leaves(tree):
        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        out["/".join(path)] = hashlib.sha256(
            t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def mesh_rank(rank: int, p: int, host0: dict, batch_np: dict, ckpt_dir: str) -> dict:
    """One rank (a thread) of [mesh]: place the start on the (2, 2) mesh,
    step at accum 1 and save, step at accum 2 and save (rank 0 writes
    the gathered tree), one more step counted by ``OpCounter``, then
    restore step 2 onto a ("model",) mesh of four through this rank's own
    manifest index on ``"cuda"``: every leaf equal to the saved one's
    bytes, on the placements the rules give."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.distributed.sharding import param_spec, to_placements
    from repro_torch.launch.opcount import OpCounter
    from repro_torch.launch.shardings import (batch_shardings, guard_spec,
                                              params_shardings, place)
    from repro_torch.train.optim import OptConfig, adamw_init, tree_leaves
    from repro_torch.train.trainstep import make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(ARCHS[MESH["arch"]], n_layers=MESH["layers"])
    model = LM(cfg, device=dev)
    mesh = init_device_mesh("cuda", MESH["shape"], mesh_dim_names=MESH["axes"])
    p_sh = params_shardings(mesh, host0)

    def walk(tree, sh):  # one leaf on the card at a time
        if isinstance(tree, dict):
            return {k: walk(v, sh[k]) for k, v in tree.items()}
        return distribute_tensor(tree.to(dev), sh.mesh, sh.placements(tree.dim()),
                                 src_data_rank=None)

    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    batch = place(batch, batch_shardings(mesh, batch))
    opt_cfg = OptConfig(peak_lr=MESH["lr"], warmup_steps=1)
    out = {"rank": rank, "steps": []}
    for accum in (1, 2):  # each step from the same start
        params = opt = None
        params = walk(host0, p_sh)
        opt = adamw_init(params)
        if accum == 1:
            resident = sum(t.to_local().numel() * t.element_size() for t in tree_leaves(
                params) + tree_leaves({"m": opt["m"], "v": opt["v"]}))
            out["resident_state_gib"] = resident / 2**30
            dist.barrier()
            if rank == 0:
                sync_stream(dev)
                torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(model, opt_cfg, accum=accum, param_shardings=p_sh)
        dist.barrier()
        sync_stream(dev)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            params, opt, m = step(params, opt, batch)
        sync_stream(dev)
        wall = time.perf_counter() - t0
        dist.barrier()
        out["steps"].append({"accum": accum, "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]), "wall_s": wall})
        if rank == 0:
            print(f"[mesh] rank 0: step at accum {accum}: {json.dumps(out['steps'][-1])}",
                  flush=True)
        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, accum, params, device=dev)
        out["steps"][-1]["save_s"] = time.perf_counter() - t0
    saved = tree_digests(params)
    if rank == 0:
        out["peak_gib_all_ranks"] = torch.cuda.max_memory_allocated(dev) / 2**30
    # the collectives and matmuls of one more accum=1 step, counted
    step = make_train_step(model, opt_cfg, accum=1, param_shardings=p_sh)
    with OpCounter() as ops, use_mesh(mesh):
        step(params, opt, batch)
    out["ops"] = ops.summary()
    del params, opt
    # elastic restore of step 2 onto ("model",) = 4, the four ranks at
    # once and with no lock: each rebuilds its manifest index and captures
    # its lookup graphs while the others do the same (the library never
    # synchronizes the whole device, which would break a capture)
    mesh1 = init_device_mesh("cuda", (MESH_RANKS,), mesh_dim_names=("model",))
    t0 = time.perf_counter()
    got, stats = restore_checkpoint(ckpt_dir, 2, host0, backend="cuda",
                                    shardings=params_shardings(mesh1, host0))
    out["restore_s"] = time.perf_counter() - t0
    out["restore_index_rebuild_s"] = stats["index_rebuild_s"]
    restored = tree_digests(got)
    check(restored == saved, f"rank {rank}: the restore onto ('model',) differs from the save")

    def placed_by_rules(tree, path=()):
        if isinstance(tree, dict):
            return all(placed_by_rules(v, path + (k,)) for k, v in tree.items())
        spec = guard_spec(mesh1, param_spec(path, tree), tuple(tree.shape))
        return tuple(tree.placements) == to_placements(mesh1, spec, tree.dim())

    check(placed_by_rules(got), f"rank {rank}: a restored leaf is not placed as the rules say")
    out["saved_digests"] = saved if rank == 0 else None
    return out


#: [mesh] (d): llama3-8b at full width with its 32 layers cut to 4, bf16,
#: at decode_32k's cache length (32,768) with its batch cut from 128 to 4:
#: a 4 x 512 prefill, then 16 decode steps teacher-forced with one rank's
#: greedy tokens; (e): qwen3-moe at full width with its 94 layers cut to 2
#: (as [lm_serve] cuts it), sort dispatch, its 128 experts split two ways
#: over "model": a 4 x 512 prefill and 8 decode steps.  (d) is held against
#: one rank's logits, (e) against one rank run with the mesh's expert
#: choices, both within [lm_serve]'s decode bound (LOGIT_TOL); (e)'s router
#: probabilities against that run's within the same bound, and each choice
#: of the mesh that differs from that run's top-k explained by their
#: difference (``routing_gate``).  (e)'s logits against one rank's own
#: routing are printed, not held: a token routed apart moves far
MESH_DECODE = {"arch": "llama3-8b", "layers": 4, "batch": 4, "prompt": 512, "cache": 32768,
               "steps": 16, "seed": 93}
MESH_MOE = {"arch": "qwen3-moe-235b-a22b", "layers": 2, "batch": 4, "prompt": 512,
            "cache": 1024, "steps": 8, "seed": 94}
#: [mesh] (f): a lookup-graph capture beside a timed rebuild, rounds each
MESH_CAPTURE = {"rebuild_keys": 1_000_000, "tree_keys": (200_000, 230_000), "queries": 1 << 14,
                "rounds": 8}


def zeros_placed(struct, shardings):
    """Zero DTensors of ``struct``'s shapes and dtypes (meta tensors) under
    ``shardings``, each rank making only its own block on its card."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(struct, dict):
        return {k: zeros_placed(v, shardings[k]) for k, v in struct.items()}
    placements = shardings.placements(struct.dim())
    local = list(struct.shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= shardings.mesh.size(i)
    x = torch.zeros(local, dtype=struct.dtype, device=torch.cuda.current_device())
    return DTensor.from_local(x, shardings.mesh, placements, run_check=False,
                              shape=struct.shape, stride=struct.stride())


def serve_one_rank(model, params, spec: dict, prompts: np.ndarray, dev,
                   tokens: np.ndarray | None = None) -> dict:
    """A prefill of ``prompts`` and ``spec["steps"]`` decode steps on one
    rank, greedy or fed ``tokens``: each step's logits and the tokens, on
    the host, and the walls."""
    cache, feed = model.init_cache(spec["batch"], spec["cache"]), tokens
    with torch.no_grad():
        (cache, lg), prefill_s = sync_wall(
            lambda: model.prefill(params, {"tokens": torch.from_numpy(prompts).to(dev)}, cache))
        logits, tokens, walls = [lg.cpu()], [], []
        for i in range(spec["steps"]):
            tok = lg.argmax(-1) if feed is None else torch.from_numpy(feed[i]).to(dev)
            tokens.append(tok.cpu().numpy())
            (cache, lg), wall = sync_wall(lambda: model.decode_step(
                params, cache, {"token": tok, "pos": spec["prompt"] + i}))
            logits.append(lg.cpu())
            walls.append(wall)
    return {"logits": logits, "tokens": np.stack(tokens), "prefill_s": prefill_s,
            "decode_ms": step_ms(walls)}


def mesh_serve_rank(rank: int, p: int, cfg, params: dict, spec: dict, prompts: np.ndarray,
                    tokens: np.ndarray) -> dict:
    """One rank (a thread) of [mesh] (d) and (e): the serving parameters and
    a zero cache placed by the rules on the (2, 2) mesh (the cache split on
    its sequence over "model"), the prefill, then the decode steps fed
    ``tokens`` (teacher forcing), each step's logits gathered; one more
    step counted by ``OpCounter``; this rank's cache and expert-weight
    blocks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.launch.opcount import OpCounter
    from repro_torch.launch.shardings import (batch_shardings, cache_shardings,
                                              params_shardings, place)

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", MESH["shape"], mesh_dim_names=MESH["axes"])
    model = LM(cfg, device=dev)
    p_sh = params_shardings(mesh, params)

    def walk(tree, sh):  # this rank's block of each leaf
        if isinstance(tree, dict):
            return {k: walk(v, sh[k]) for k, v in tree.items()}
        return distribute_tensor(tree, sh.mesh, sh.placements(tree.dim()), src_data_rank=None)

    pm = walk(params, p_sh)
    struct = model.cache_struct(spec["batch"], spec["cache"])
    cache = zeros_placed(struct, cache_shardings(mesh, cfg, struct))

    def token_batch(i):
        b = {"token": torch.from_numpy(tokens[i]).to(dev)}
        b = place(b, batch_shardings(mesh, b))
        b["pos"] = spec["prompt"] + i
        return b

    out = {"rank": rank, "decode_s": []}
    with use_mesh(mesh), torch.no_grad():
        b = {"tokens": torch.from_numpy(prompts).to(dev)}
        b = place(b, batch_shardings(mesh, b))
        dist.barrier()
        sync_stream(dev)
        t0 = time.perf_counter()
        cache, lg = model.prefill(pm, b, cache)
        sync_stream(dev)
        out["prefill_s"] = time.perf_counter() - t0
        logits = [lg.full_tensor().cpu()]
        for i in range(spec["steps"]):
            b = token_batch(i)
            dist.barrier()
            sync_stream(dev)
            t0 = time.perf_counter()
            cache, lg = model.decode_step(pm, cache, b)
            sync_stream(dev)
            out["decode_s"].append(time.perf_counter() - t0)
            logits.append(lg.full_tensor().cpu())
        # one more step (at the next position), its collectives counted
        b = token_batch(spec["steps"] - 1)
        b["pos"] = spec["prompt"] + spec["steps"]
        with OpCounter() as ops:
            model.decode_step(pm, cache, b)
    out["decode_ops"] = ops.summary()
    out["cache_bytes"] = sum(t.to_local().numel() * t.element_size()
                             for sub in cache.values() for t in sub.values())
    out["cache_placements"] = str(cache["0"]["k"].placements)
    out["experts"] = {name: {"local_shape": list(t.to_local().shape),
                             "bytes": t.to_local().numel() * t.element_size()}
                      for name, t in pm["blocks"]["0"].items() if name.startswith("moe_w")}
    out["logits"] = logits if rank == 0 else None
    return out


@contextmanager
def routing_spy(thread_name: str | None = None, forced: list | None = None):
    """Record each MoE call's router probabilities and top-k expert ids (on
    the host) in call order; with ``thread_name``, only that thread's
    calls.  With ``forced`` (such a record), call i takes the experts of
    ``forced[i]`` instead of its own top-k, each gated by its own
    probability: one device run with another run's routing."""
    seen = []
    orig = moe_mod.top_k_lower

    def spy(probs, k):
        if forced is not None:
            idx = forced[len(seen)][1].to(probs.device)
            vals = probs.gather(-1, idx)
        else:
            vals, idx = orig(probs, k)
        if thread_name is None or threading.current_thread().name == thread_name:
            seen.append((probs.cpu(), idx.cpu()))
        return vals, idx

    moe_mod.top_k_lower = spy
    try:
        yield seen
    finally:
        moe_mod.top_k_lower = orig


def routing_ties(one: list, mesh: list, rows: list) -> dict:
    """Where the mesh routed a token to other experts than one rank did:
    the token count (in every call, and at ``rows[i]``, the compared rows
    of call i) and the widest one-rank probability gap between an expert
    only one side chose and one only the other chose, relative to the
    token's k-th largest probability."""
    tokens = compared = 0
    widest = 0.0
    for i, ((probs, a), (_, b)) in enumerate(zip(one, mesh)):
        a, b = a.sort(dim=-1).values, b.sort(dim=-1).values
        differ = (a != b).any(-1)
        tokens += int(differ.sum())
        compared += int(differ[rows[i]].sum())
        for t in torch.nonzero(differ).flatten().tolist():
            sa, sb = set(a[t].tolist()), set(b[t].tolist())
            p = probs[t]
            kth = float(p[a[t]].min())
            gap = (max(float(p[e]) for e in sa ^ sb) - min(float(p[e]) for e in sa ^ sb))
            widest = max(widest, gap / kth)
    return {"calls": len(one), "tokens": tokens, "compared_rows": compared,
            "widest_gap_of_kth_prob": widest}


def routing_gate(forced: list, mesh: list, k: int) -> dict:
    """The mesh's expert choices against the forced run's own router
    probabilities (the same routing history, call by call): where the
    top-k of the forced run's probabilities differs from the mesh's
    choice, the gap by which the strongest expert the mesh left out leads
    the weakest one it took must be at most twice the token's largest
    router-probability difference between the two runs, the noise that
    can reorder them.  An expert taken against the probabilities fails
    it."""
    tokens = unexplained = 0
    widest = 0.0
    for (pf, _), (pm, b) in zip(forced, mesh):
        a = moe_mod.top_k_lower(pf, k)[1]
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
        noise = (pm - pf).abs().amax(-1)
        for t in torch.nonzero(differ).flatten().tolist():
            sa, sb = set(a[t].tolist()), set(b[t].tolist())
            gap = (max(float(pf[t, e]) for e in sa - sb)
                   - min(float(pf[t, e]) for e in sb - sa))
            tokens += 1
            unexplained += gap > 2 * float(noise[t]) + 1e-6
            widest = max(widest, gap / max(2 * float(noise[t]), 1e-30))
    return {"tokens": tokens, "unexplained": unexplained,
            "widest_gap_of_twice_noise": widest}


def mesh_serve(args, dev, spec: dict, part: str) -> dict:
    """[mesh] (d) or (e): ``spec``'s model on one rank (greedy), then on the
    (2, 2) mesh's four threaded ranks fed the one rank's tokens; every
    step's logits within LOGIT_TOL of the logits' scale."""
    from repro_torch.tools.rankgroup import run_threads

    cfg = dataclasses.replace(ARCHS[spec["arch"]], n_layers=spec["layers"])
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, dispatch_mode="sort")
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed + spec["seed"]))
    rng = np.random.default_rng(args.seed + spec["seed"])
    prompts = rng.integers(0, cfg.vocab_size, (spec["batch"], spec["prompt"]))
    with routing_spy() as one_routes:
        one = serve_one_rank(model, params, spec, prompts, dev)
    t0 = time.perf_counter()
    with routing_spy("rank0") as mesh_routes:
        ranks = run_threads(mesh_serve_rank, MESH_RANKS, cfg, params, spec, prompts,
                            one["tokens"], timeout=600.0)
    group_s = time.perf_counter() - t0
    got = ranks[0]["logits"]
    errs = [logit_stats(g, w) for g, w in zip(got, one["logits"])]
    worst = max(e / s for e, s in errs)
    if cfg.n_experts:
        # top-k routing is discontinuous: where the mesh's bf16 sums round
        # apart from one rank's, a router tie can go the other way and move
        # a token's logits far.  So the logits are held against one rank
        # run with the mesh's expert choices, and the router's
        # probabilities, whose order makes the choices, against that run's
        # within the same bound
        rows = ([[b * spec["prompt"] + spec["prompt"] - 1 for b in range(spec["batch"])]]
                * cfg.n_layers + [slice(None)] * (len(one_routes) - cfg.n_layers))
        ties = routing_ties(one_routes, mesh_routes, rows)
        with routing_spy(forced=mesh_routes) as forced_routes:
            forced = serve_one_rank(model, params, spec, prompts, dev, tokens=one["tokens"])
        # the routing's inputs: the router probabilities of every call
        # against the forced run's (the same routing history)
        router_gap = max(float((pm - pf).abs().max()) / float(pf.abs().max())
                         for (pf, _), (pm, _) in zip(forced_routes, mesh_routes))
        gate = routing_gate(forced_routes, mesh_routes, cfg.top_k)
        unforced = worst
        errs = [logit_stats(g, w) for g, w in zip(got, forced["logits"])]
        worst = max(e / s for e, s in errs)
    # greedy agreement: the mesh's argmax against the one rank's tokens
    agree = float(np.mean([np.array_equal(g.argmax(-1).numpy(), t)
                           for g, t in zip(got[:-1], one["tokens"])]))
    line = {
        "part": part, "arch": cfg.name, "layers": cfg.n_layers,
        "full_layers": ARCHS[cfg.name].n_layers, "batch": spec["batch"],
        "cache_len": spec["cache"], "prompt": spec["prompt"], "steps": spec["steps"],
        "max_logit_gap_of_scale": worst, "max_logit_gap": max(e for e, _ in errs),
        "logit_tol": LOGIT_TOL, "greedy_agreement": agree,
        "one_rank": {"prefill_s": one["prefill_s"], "decode_ms": one["decode_ms"]},
        "mesh": {"prefill_s": [o["prefill_s"] for o in ranks],
                 "decode_ms": [step_ms(o["decode_s"]) for o in ranks]},
        "cache_bytes_a_rank": [o["cache_bytes"] for o in ranks],
        "cache_placements": ranks[0]["cache_placements"],
        "decode_step_collectives_a_rank": ranks[0]["decode_ops"]["collective_bytes"],
        "decode_step_collective_counts": ranks[0]["decode_ops"]["collective_counts"],
        "group_s": group_s,
    }
    if cfg.n_experts:
        line["logits_against"] = "one rank with the mesh's routing"
        line["unforced_max_logit_gap_of_scale"] = unforced
        line["router_prob_gap_of_scale"] = router_gap
        line["routing_differs"] = ties
        line["routing_gate"] = gate
        e_local = [o["experts"]["moe_w1"]["local_shape"][1] for o in ranks]
        line["experts_a_rank"] = e_local
        line["expert_bytes_a_rank"] = [sum(v["bytes"] for v in o["experts"].values())
                                       for o in ranks]
        line["expert_bytes_whole"] = sum(params["blocks"]["0"][k].numel()
                                         * params["blocks"]["0"][k].element_size()
                                         for k in ("moe_w1", "moe_w3", "moe_w2"))
    print(f"[mesh] ({part}) {json.dumps(line)}; {card_line()}", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in got), f"[mesh] ({part}): logits not finite")
    check(worst <= LOGIT_TOL, f"[mesh] ({part}): the mesh's logits are {worst} of the scale "
          f"from one rank's (bound {LOGIT_TOL})")
    if cfg.n_experts:
        check(router_gap <= LOGIT_TOL,
              f"[mesh] (e): the router's probabilities are {router_gap} of the scale from one "
              f"rank's with the same routing (bound {LOGIT_TOL})")
        check(gate["unexplained"] == 0,
              f"[mesh] (e): {gate['unexplained']} of {gate['tokens']} tokens routed to experts "
              "that their router probabilities do not rank first within the runs' difference")
        check(all(e == cfg.n_experts // MESH["shape"][1] for e in line["experts_a_rank"]),
              f"[mesh] (e): ranks hold {line['experts_a_rank']} experts each, not "
              f"{cfg.n_experts // MESH['shape'][1]}")
    del params, model, ranks, one
    gc.collect()
    torch.cuda.empty_cache()
    return line


def capture_beside_rebuild(args, dev) -> dict:
    """[mesh] (f): one thread captures lookup graphs (two trees of other
    geometry in turn, so every round captures again) while another runs
    ``ReconstructionPipeline.run`` with its per-stage waits, at once and
    with no lock; every answer and every rebuild equal to a serial run's
    (the library's waits are for the calling thread's stream, so neither
    breaks the other's capture)."""
    c = MESH_CAPTURE
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    sets = [zipf_keys(ZipfConfig(1.5, 64, 0, n), seed=args.seed + 95 + i)
            for i, n in enumerate(c["tree_keys"])]
    ks_r = zipf_keys(ZipfConfig(1.5, 64, 0, c["rebuild_keys"]), seed=args.seed + 97)
    rng = np.random.default_rng(args.seed + 98)
    queries = to_carrier(make_queries(np.concatenate([s.words for s in sets]), rng,
                                      size=c["queries"])[0], dev)
    trees = [pipe.run(s).tree for s in sets]
    plancache.reset_cache()
    want = [[digest(x) for x in pipe.backend.lookup(t, queries)] for t in trees]
    want_run = result_digests(pipe.run(ks_r))
    start = threading.Barrier(2)
    errors, walls, captures = [], {}, [plancache.get_cache().captures]

    def capturer():
        try:
            start.wait()
            t0 = time.perf_counter()
            for i in range(c["rounds"]):
                got = [digest(x) for x in pipe.backend.lookup(trees[i % 2], queries)]
                if got != want[i % 2]:
                    errors.append(f"capture round {i}: answers differ from the serial run's")
            walls["capture_s"] = time.perf_counter() - t0
        except Exception as e:  # surfaced below
            errors.append(f"capturer: {e!r}")

    def rebuilder():
        try:
            other = ReconstructionPipeline(backend="cuda", device=dev)
            start.wait()
            t0 = time.perf_counter()
            for i in range(c["rounds"]):
                if result_digests(other.run(ks_r)) != want_run:
                    errors.append(f"rebuild round {i}: differs from the serial run")
            walls["rebuild_s"] = time.perf_counter() - t0
        except Exception as e:  # surfaced below
            errors.append(f"rebuilder: {e!r}")

    threads = [threading.Thread(target=capturer), threading.Thread(target=rebuilder)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads), "[mesh] (f): a thread did not finish")
    check(errors == [], f"[mesh] (f): {errors[:3]}")
    captures.append(plancache.get_cache().captures)
    check(captures[1] - captures[0] >= c["rounds"],
          f"[mesh] (f): {captures[1] - captures[0]} captures in {c['rounds']} rounds")
    del trees, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return {"rounds": c["rounds"], "captures": captures[1] - captures[0], **walls}


def mesh_phase(args, dev, launches: dict) -> None:
    """Phase 20: the LM on a device mesh.  (a) llama3-8b at full width with
    4 of its 32 layers, batch 4 x 512, remat, AdamW at peak 1e-5: one
    step at accum 1 and one at accum 2 on one rank, kept on the host; then
    the same two steps on four ranks (threads of this process in PyTorch's
    threaded group: gloo's functional-collective wait faulted on CUDA
    tensors) sharing the card on a (2, 2) ("data", "model") mesh placed by
    the sharding rules, each saved from the mesh; the losses and the
    saved parameters against the single rank's within [train]'s accum
    tolerances; the four ranks' peak together, each rank's state, the
    step walls, one more step's collectives by kind.  (b) step 2 restored
    onto ("model",) = 4 on every rank through its own manifest index on
    ``"cuda"``, equal to the saved tree to the bit and placed as the rules
    say, and onto one rank (this process), equal to the same digests.
    (c) fake dry runs (``launch.dryrun``, subprocesses started first and
    running meanwhile): llama3-8b ``train_4k`` at 256 and 512 ranks, and
    (a)'s own cell at (2, 2); their peaks, FLOPs, collective bytes and
    roofline rows at H100 peaks; (a)'s predicted peak beside the measured
    one.  The restores and the save are the path, counted from 0."""
    from repro_torch.launch import roofline
    from repro_torch.tools.rankgroup import run_threads
    from repro_torch.train.optim import OptConfig, adamw_init, tree_leaves, tree_map
    from repro_torch.train.trainstep import make_train_step

    t_phase = time.perf_counter()
    acc = launches.setdefault("mesh", {})
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-"))
    atexit.register(shutil.rmtree, work, True)

    # (c) first: the dry runs trace on the host while (a) and (b) run
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    dry = ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
            "--shape", "train_4k", "--force", "--out-root", str(work / "dryrun")])
    small = ["--mesh", "2x2", "--override", f"n_layers={MESH['layers']}", "--batch",
             str(MESH["batch"]), "--seq", str(MESH["seq"])]
    procs = {
        "pod1": subprocess.Popen(dry + ["--mesh", "pod1"], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
        "pod2": subprocess.Popen(dry + ["--mesh", "pod2"], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
        "small": subprocess.Popen(
            dry + small + ["--accum", "1", "--out-suffix", "__a1"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }

    # (a) the single rank first, its results on the host
    cfg = dataclasses.replace(ARCHS[MESH["arch"]], n_layers=MESH["layers"])
    model = LM(cfg, device=dev)
    params = model.init_master(torch.Generator(device=dev).manual_seed(args.seed + 91))
    host0 = tree_map(lambda t: t.to("cpu", copy=True), params)
    n_params = sum(t.numel() for t in tree_leaves(host0))
    rng = np.random.default_rng(args.seed + 92)
    toks = rng.integers(0, cfg.vocab_size, (MESH["batch"], MESH["seq"] + 1)).astype(np.int64)
    batch_np = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    opt_cfg = OptConfig(peak_lr=MESH["lr"], warmup_steps=1)
    single = []
    for accum in (1, 2):  # each step from the same start
        params = opt = m = None
        params = tree_map(lambda t: t.to(dev), host0)
        opt = adamw_init(params)
        step = make_train_step(model, opt_cfg, accum=accum)
        (params, opt, m), wall = sync_wall(lambda: step(params, opt, batch_np))
        single.append({"accum": accum, "loss": float(m["loss"]), "wall_s": wall,
                       "host": [t.to("cpu", copy=True) for t in tree_leaves(params)]})
    del params, opt, m, step
    gc.collect()
    torch.cuda.empty_cache()

    # (a) and (b) on the mesh: the save and the restores are the path
    ckpt_dir = work / "ckpt"
    with counted(acc):
        t0 = time.perf_counter()
        ranks = run_threads(mesh_rank, MESH_RANKS, host0, batch_np, str(ckpt_dir),
                            timeout=900.0)
        group_wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    lr = MESH["lr"]
    for i, want in enumerate(single):
        for r, out in enumerate(ranks):
            got = out["steps"][i]
            check(np.isfinite(got["loss"]) and got["loss"] == ranks[0]["steps"][i]["loss"],
                  f"rank {r}: step {i + 1}'s loss {got['loss']} differs from rank 0's")
        got = ranks[0]["steps"][i]
        check(abs(got["loss"] - want["loss"]) <= ACCUM_LOSS_RTOL * abs(want["loss"]),
              f"mesh step {i + 1} (accum {want['accum']}): loss {got['loss']} against one "
              f"rank's {want['loss']}")
    # (b) onto one rank: each saved step through this process's own index
    like = host0
    gaps = []
    for i, want in enumerate(single):
        with counted(acc):
            restored, stats = restore_checkpoint(ckpt_dir, i + 1, like, device=dev,
                                                 backend="cuda")
        g = param_gaps(restored, want.pop("host"), lr, n_params)
        check(g["max_param_gap"] <= ACCUM_MAX_LR * lr * (1 + 1e-3)
              and g["mean_param_gap"] <= ACCUM_MEAN_LR * lr,
              f"mesh step {i + 1}: parameters against one rank's {g}")
        gaps.append(g)
        if i == 1:
            check(tree_digests(restored) == ranks[0]["saved_digests"],
                  "the one-rank restore of step 2 differs from the saved tree")
        del restored
    del host0, like
    check_launches("mesh", acc)

    # (c) the dry runs
    recs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"dry run {name} failed:\n{out[-2000:]}\n{err[-2000:]}")
    for mesh_name, suffix in (("pod1", ""), ("pod2", ""), ("2x2", "__a1")):
        rec = json.loads((work / "dryrun" / mesh_name / f"llama3-8b__train_4k{suffix}.json")
                         .read_text())
        check(rec["status"] == "ok", f"dry run {mesh_name}: {rec.get('error')}")
        recs[mesh_name] = rec
    for mesh_name in ("pod1", "pod2"):
        rec = recs[mesh_name]
        check(rec["memory"]["peak_bytes"] < 80 * 2**30,
              f"dry run {mesh_name}: peak {rec['memory']['peak_bytes']} past 80 GiB")
        row = roofline.analyze_cell(rec)
        print(f"[mesh] dry run {json.dumps({'mesh': mesh_name, 'ranks': rec['n_devices'], 't_trace_s': rec['t_trace_s'], 'memory_gib': {k: v / 2**30 for k, v in rec['memory'].items()}, 'op_summary': rec['op_summary'], 'roofline': row})}",
              flush=True)
    predicted = recs["2x2"]["memory"]["peak_bytes"] / 2**30

    # (d) decode and (e) the MoE on the mesh, then (f) a capture beside a
    # rebuild; each part frees its models before the next
    t_new = time.perf_counter()
    card = card_line()
    parts = {}
    for part, spec in (("d", MESH_DECODE), ("e", MESH_MOE)):
        t0 = time.perf_counter()
        parts[part] = mesh_serve(args, dev, spec, part)
        parts[part]["part_s"] = time.perf_counter() - t0
        print(f"[mesh] ({part}) took {parts[part]['part_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    parts["f"] = capture_beside_rebuild(args, dev)
    parts["f"]["part_s"] = time.perf_counter() - t0
    print(f"[mesh] (f) {json.dumps(parts['f'])}; {card}", flush=True)
    new_parts_s = time.perf_counter() - t_new
    line = {
        "card": card_line(), "parameters": n_params, "ranks": MESH_RANKS,
        "mesh": dict(zip(MESH["axes"], MESH["shape"])),
        "group": "threaded (one process, four threads)",
        "single": single,
        "mesh_steps": ranks[0]["steps"], "param_gaps": gaps,
        "resident_state_gib": [o["resident_state_gib"] for o in ranks],
        "peak_gib_four_ranks": ranks[0]["peak_gib_all_ranks"],
        "predicted_peak_gib_a_rank": predicted,
        "predicted_peak_gib_four_ranks": 4 * predicted,
        "collectives_a_rank": [o["ops"] for o in ranks],
        "restore_model4_s": [o["restore_s"] for o in ranks],
        "group_wall_s": group_wall, "parts_d_e_f_s": new_parts_s,
        "phase_s": time.perf_counter() - t_phase, "launches": acc,
    }
    print(f"[mesh] {json.dumps(line)}", flush=True)
    print("[mesh] the (2, 2) mesh's steps at accum 1 and 2 == one rank's within the tolerances; "
          "the restores onto ('model',) = 4, four threads at once with no lock, and onto one "
          "rank == the saved tree to the bit; the dry runs fit 80 GiB; decode over the "
          "sequence-split cache and the expert-parallel MoE == one rank's within "
          f"{LOGIT_TOL} of the scale; lookup-graph captures beside a timed rebuild == serial "
          f"runs; (d)-(f) took {new_parts_s:.1f} s; {card}", flush=True)


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
    res_torch = ref_pipe.run(keyset)  # kept for phase 10's "torch" twin
    results_equal(res, res_torch, "cuda vs torch")
    results_equal(full, ref_pipe.run(keyset, full_keys=True), "full keys, cuda vs torch")
    del full, ref_pipe
    print("[slice] sorted run, permutation, tree and meta == torch backend", flush=True)
    # phase 16's ranks read their inputs from here and are held to these
    dist_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-dist-"))
    atexit.register(shutil.rmtree, dist_dir, True)
    for name, a in (("words", keyset.words), ("lengths", keyset.lengths), ("rids", keyset.rids)):
        np.save(dist_dir / f"{name}.npy", a)
    dist_data = {"dir": dist_dir, "digests": {"run": result_digests(res)}}

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
    np.save(dist_dir / "queries.npy", query_batches[0][0])
    dist_data["digests"]["lookup"] = {"found": digest(answers[0][0]), "rid": digest(answers[0][1])}
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
    for name, a in (("delta_words", delta.words), ("delta_lengths", delta.lengths),
                    ("delta_rids", delta.rids), ("keep", keep), ("union_dbitmap", meta.dbitmap),
                    ("union_varbitmap", meta.varbitmap), ("union_refkey", meta.refkey)):
        np.save(dist_dir / f"{name}.npy", a)
    dist_data["digests"]["incremental"] = result_digests(inc)
    dist_data["n_delta"] = nd
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

    # -- 8. plancache: the lookups replayed as CUDA graphs ---------------------
    plancache_phase(args, dev, rng, pipe, keyset, res, mt, launches)
    del mt["trees"]

    # -- 9. mt_load: the closed-loop harness, with and without the SLO ----------
    mt_load_phase(args, dev, launches)

    # -- 10. online: phase 3's index takes inserts, deletes, searches, rebuilds ---
    online_phase(args, dev, rng, keyset, res, res_torch, launches)
    del res_torch

    # -- 11. run_many: four same-bucket key sets batched, a fifth alone ----------
    many = run_many_phase(args, dev, rng, launches)

    # -- 12. replication: a primary, two tails and a recovering lagger ---------
    replication_phase(args, dev, rng, keyset, launches)

    # -- 13. load: reads racing incremental rebuilds, with and without shedding -
    load_phase(args, dev, launches)

    # -- 14. pager: the serving page table, its standby and its load run --------
    pager_phase(args, dev, launches)

    # -- 17. lm_serve: llama3-8b served and restarted, qwen3-moe's two dispatches -
    lm_serve_phase(args, dev, launches)

    # -- 18. train: the token pipeline, llama3-8b's train step, launch.train ----
    train_phase(args, dev, launches)

    # -- 19. examples: the example twins on the card -----------------------------
    examples_phase(args, dev, launches)

    # -- 16. distributed: four gloo ranks on the card, one NCCL rank here -------
    # (before the report, which counts its launches)
    distributed_phase(args, dev, res, keyset, dist_data, launches)

    # -- 20. mesh: the sharded train step, elastic restore, the dry runs --------
    # (before the report, which counts its launches)
    mesh_phase(args, dev, launches)

    # -- 15. kernel report at the main paths' shapes -----------------------------
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
