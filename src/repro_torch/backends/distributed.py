"""Process-group backend: the row-column sample sort over ``torch.distributed``.

Wraps ``repro_torch.core.distsort.make_sample_sort`` so a group run gives
the same (keys_sorted, rows_sorted) pair, and so the same
``ReconstructionResult``, as the single-device backends; the counterpart
of the reference's ``distributed`` backend, with the process group in the
place of the mesh.

**Interconnect volume** is why this backend lives inside the pipeline:
the extract stage runs before the sort stage, so before the sample sort's
bucketed exchange, and the bytes crossing the group are the compressed
sort keys.  The exchange shrinks by the paper's sort-key ratio.

**The SPMD model.**  Every rank of the group constructs the backend and
makes the same calls with the same global inputs; every rank returns the
whole result, as the reference's global arrays are whole.  Each host-side
branch (``p == 1``, empty runs, ``T % p``, ``k % p``, the overflow retry,
the routed group sizes) is decided from values every rank holds alike, so
no rank skips a collective the others wait in.  Without an initialised
process group ``p`` is 1 and no collective runs, as with the reference's
one-device mesh.

**The local backend.**  Every shard-local stage goes through the
``"cuda"`` backend on a CUDA device and the ``"torch"`` backend on the
CPU: ``extract``, ``build``, ``refresh_meta`` and the D-bit and rank hooks
are its own, the sample sort's two local sorts are its ``sort``, each
rank's owner-chunk merge its ``merge_sorted``, each routed group its
``lookup``, each tenant shard its ``lookup_many`` and each batch shard
its ``batched_extract_sort``.  On CUDA the pext, bitonic, merge-rank,
pk-window, dbit, probe and probe_many kernels therefore run on every rank.
The local stages' programs are cached under the local backend's name;
the sharded ``lookup_many`` and ``run_many`` programs under the
reference's keys, with ``"distributed"`` and ``p`` in them.

Buckets have a capacity and the sort *reports* overflow; this backend
retries with doubled capacity until the sort is overflow-free and
records the attempts in ``last_info`` (``mesh_devices`` is the group's
size, as the reference names its mesh's).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.distsort import (
    SENTINEL, all_gather_rows, from_wire, group_layout, make_sample_sort, to_wire)
from repro_torch.core.plancache import (
    bucket_for, get_cache, iota, pad_run, pad_tail)
from repro_torch.kernels.merge import merge_ranks_plain

from .base import ExecutionBackend, get_backend, register_backend

__all__ = ["DistributedBackend"]


@register_backend("distributed")
class DistributedBackend(ExecutionBackend):
    """The sample sort, the owner-routed merge and lookup, and the tenant-
    and batch-axis shards over the ranks of ``group``."""

    supports_batched = True

    def __init__(self, device=None, group=None, capacity_factor: float = 1.5,
                 max_capacity_retries: int = 4, local=None) -> None:
        super().__init__(device)
        self.group = group
        self.p, self.rank = group_layout(group)
        if local is None:
            local = "cuda" if self.device.type == "cuda" else "torch"
        self.local = (local if isinstance(local, ExecutionBackend)
                      else get_backend(local, device=self.device))
        self.dbitmap_fn = self.local.dbitmap_fn
        self.dpos_fn = self.local.dpos_fn
        self.rank_fn = self.local.rank_fn
        self.capacity_factor = float(capacity_factor)
        self.max_capacity_retries = int(max_capacity_retries)
        self._fns: dict = {}  # (n_per_shard, n_words, capacity) -> sort fn
        self.last_info = {"mesh_devices": self.p}
        #: the last sample sort's walls and exchange bytes on this rank
        self.last_timings: dict = {}

    # -------------------------------------------------- the local stages
    def extract(self, words, plan):
        # row-parallel, ahead of the exchange: what shrinks its bytes
        return self.local.extract(words, plan)

    def build(self, comp_sorted, row_sorted, meta, words, lengths, config,
              rids=None, n_valid=None):
        return self.local.build(comp_sorted, row_sorted, meta, words, lengths, config,
                                rids=rids, n_valid=n_valid)

    def refresh_meta(self, comp_sorted, meta, ref_key, n_valid=None):
        return self.local.refresh_meta(comp_sorted, meta, ref_key, n_valid=n_valid)

    # --------------------------------------------------------------- sort
    def _sort_fn(self, n_per_shard: int, n_words: int, capacity: float):
        key = (n_per_shard, n_words, capacity)
        if key not in self._fns:
            self._fns[key] = make_sample_sort(self.group, n_per_shard, n_words, capacity,
                                              local=self.local)
        return self._fns[key]

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        b = int(keys.shape[0])
        n = b if n_valid is None else int(n_valid)
        p = self.p
        if n_valid is not None:
            # bucket-shaped inputs: pad keys to the sentinel, pad rows to
            # their lane (>= n, so the compaction strips them)
            lane = iota(b, keys.device)
            valid = lane < n
            keys = torch.where(valid[:, None], keys, torch.full_like(keys, SENTINEL))
            rows = torch.where(valid, rows, lane)
        # shard padding takes the row ids n..: reject rows that would be
        # confused with it
        if n and int(rows[:n].max()) >= n:
            raise ValueError(
                "distributed backend requires row positions in [0, n); "
                f"got max row {int(rows[:n].max())} for n={n}")
        # pad to a shard multiple: sentinel keys, row ids cur.., so the
        # (key, row) tie-break keeps real all-ones keys ahead
        total = b + (-b) % p
        if total != b:
            keys = pad_tail(keys, total, SENTINEL)
            rows = torch.cat([rows, iota(total, rows.device)[b:]])
        res = self.sample_sort_raw(keys, rows)
        # compact the shard-padded result to the dense global order
        k, r = res.keys[res.valid], res.rids[res.valid]
        real = r < n
        ks, rs = k[real], r[real]
        if keep_padded:
            return pad_run(ks, rs, b if n_valid is not None else bucket_for("sort", n))
        return ks, rs

    def sample_sort_raw(self, keys, rows):
        """The sample sort with the overflow retry: the shard-padded global
        :class:`~repro_torch.core.distsort.DistSortResult`, no compaction.
        ``n`` must be a multiple of the group's size (``sort`` pads)."""
        n, w = (int(s) for s in keys.shape)
        p = self.p
        if n % p:
            raise ValueError(f"n={n} must divide over {p} ranks")
        capacity = self.capacity_factor
        attempts = 0
        while True:
            attempts += 1
            res = self._sort_fn(n // p, w, capacity)(keys, rows)
            # all-reduced: every rank takes the same branch
            if res.overflow == 0:
                break
            if attempts > self.max_capacity_retries:
                raise RuntimeError(
                    f"distributed sort still overflowing after {attempts} attempts "
                    f"(capacity {capacity}, overflow {res.overflow})")
            capacity *= 2.0
        self.last_info = {
            "mesh_devices": p,
            "capacity_factor": capacity,
            "capacity_retries": attempts - 1,
            "overflow": res.overflow,
        }
        self.last_timings = dict(res.stats)
        return res

    # -------------------------------------------------------------- merge
    def merge_sorted(self, keys_a, rows_a, keys_b, rows_b, *,
                     n_valid_a=None, n_valid_b=None, keep_padded=False):
        """Owner-chunk routing and chunk-local merges.

        The base run A is globally sorted, so already range-partitioned
        into ``p`` contiguous chunks.  Only the delta B moves: the rank of
        each delta pair in A (the local ``rank_fn``, the merge-rank kernel
        on CUDA) names the chunk that owns its merge position, rank ``i``
        merges chunk ``i`` with its routed slice through the local
        ``merge_sorted``, and the merged chunks are all-gathered (padded to
        the largest) in rank order.  ``last_info["delta_routed"]`` holds the
        per-chunk delta counts.
        """
        ba, bb = int(keys_a.shape[0]), int(keys_b.shape[0])
        if n_valid_a is not None:
            keys_a, rows_a = keys_a[: int(n_valid_a)], rows_a[: int(n_valid_a)]
        if n_valid_b is not None:
            keys_b, rows_b = keys_b[: int(n_valid_b)], rows_b[: int(n_valid_b)]
        na, nb = int(keys_a.shape[0]), int(keys_b.shape[0])

        def _shape_out(ks, rs):
            return pad_run(ks, rs, ba + bb) if keep_padded else (ks, rs)

        p = self.p
        if na == 0 or nb == 0 or p == 1:
            mk, mr = self.local.merge_sorted(keys_a, rows_a, keys_b, rows_b)
            self.last_info = {"mesh_devices": p, "delta_routed": [nb]}
            return _shape_out(mk, mr)
        chunk = -(-na // p)
        # rank r lands between A[r-1] and A[r], so inside chunk r // chunk
        rank_b = (self.rank_fn or merge_ranks_plain)(keys_b, rows_b, keys_a, rows_a)
        owner = (rank_b.to(torch.int64) // chunk).clamp(max=p - 1)
        routed = torch.bincount(owner, minlength=p).tolist()
        order = torch.argsort(owner, stable=True)  # each group in delta order
        offsets = np.concatenate([[0], np.cumsum(routed)])
        sizes = [max(0, min((i + 1) * chunk, na) - i * chunk) + routed[i] for i in range(p)]
        i = self.rank
        s, e = i * chunk, min((i + 1) * chunk, na)
        sel = order[offsets[i]:offsets[i + 1]]
        mk, mr = self.local.merge_sorted(keys_a[s:e], rows_a[s:e], keys_b[sel], rows_b[sel])
        m = max(sizes)
        w = int(keys_a.shape[1])
        part = torch.cat([mk, mr[:, None]], dim=1)
        glob = from_wire(all_gather_rows(to_wire(pad_tail(part, m, SENTINEL)), p,
                                         self.group))
        merged = torch.cat([glob[j * m: j * m + sizes[j]] for j in range(p)])
        self.last_info = {"mesh_devices": p, "delta_routed": routed}
        return _shape_out(merged[:, :w].contiguous(), merged[:, w].contiguous())

    # ------------------------------------------------------------- lookup
    def lookup(self, tree, queries):
        """Owner-chunk routed point lookups.

        The sorted key space splits into ``p`` contiguous chunks (the
        partition the sample sort made); a query belongs to the last chunk
        whose first key is <= it (one compare against the ``p - 1``
        boundary keys).  Rank ``i`` answers group ``i`` through the local
        ``lookup`` (on CUDA the probe kernel's leaf-stage form, replayed as
        a graph), and the answers are all-gathered back into query order,
        byte-identical to the unrouted lookup because each answer is
        independent of its group.  ``last_info["lookup_routed"]`` holds the
        per-rank query counts.
        """
        from repro_torch.core.dbits import lex_compare_le

        q = int(queries.shape[0])
        p = self.p
        n = int(tree.n_keys)
        if p == 1 or q == 0 or n < p:
            out = self.local.lookup(tree, queries)
            self.last_info = {"mesh_devices": p, "lookup_routed": [q]}
            return out
        chunk = -(-n // p)
        idx = (torch.arange(1, p, device=queries.device) * chunk).clamp(max=n - 1)
        bounds = tree.sorted_full[idx]
        owner = lex_compare_le(bounds[None, :, :], queries[:, None, :]).sum(dim=1)
        routed = torch.bincount(owner, minlength=p).tolist()
        order = torch.argsort(owner, stable=True)
        offsets = np.concatenate([[0], np.cumsum(routed)])
        sel = order[offsets[self.rank]:offsets[self.rank + 1]]
        m = max(routed)
        part = torch.zeros((m, 2), dtype=torch.int64, device=queries.device)
        if sel.numel():
            f, r = self.local.lookup(tree, queries[sel])
            part[: sel.numel(), 0] = f.to(torch.int64)
            part[: sel.numel(), 1] = r
        glob = from_wire(all_gather_rows(to_wire(part), p, self.group))
        answers = torch.cat([glob[j * m: j * m + routed[j]] for j in range(p)])
        found = torch.zeros((q,), dtype=torch.bool, device=queries.device)
        rid = torch.zeros((q,), dtype=torch.int64, device=queries.device)
        found[order] = answers[:, 0] != 0
        rid[order] = answers[:, 1]
        self.last_info = {"mesh_devices": p, "lookup_routed": routed}
        return found, rid

    @staticmethod
    def _tenant_shard(stacked, lo: int, hi: int):
        """Tenants ``[lo, hi)`` of an arena, as views."""
        return replace(
            stacked,
            levels=tuple({k: v[lo:hi] for k, v in level.items()} for level in stacked.levels),
            leaf={k: v[lo:hi] for k, v in stacked.leaf.items()},
            sorted_full=stacked.sorted_full[lo:hi],
            sorted_rids=stacked.sorted_rids[lo:hi],
        )

    def lookup_many(self, stacked, queries, n_valid=None):
        """The fused multi-tenant lookup with the tenant axis over the
        group: every tenant's descent is independent, so rank ``i`` answers
        tenants ``[i*T/p, (i+1)*T/p)`` of the arena through the local
        ``lookup_many`` (probe_many on CUDA) and the answers are
        all-gathered: batch parallelism, only the answers cross the group.
        The program is cached per ``(T, query bucket, W, geometry, p)``;
        an arena that does not tile the group runs unsharded.
        ``last_info["tenants_per_shard"]`` records the placement.
        """
        from repro_torch.core.btree import tree_geometry

        t_q, q, w = (int(s) for s in queries.shape)
        t_cap = int(stacked.sorted_full.shape[0])
        p = self.p
        if p == 1 or t_cap % p:
            self.last_info = {"mesh_devices": p, "tenants_per_shard": t_cap}
            return self.local.lookup_many(stacked, queries, n_valid)
        if t_q > t_cap:
            raise ValueError(f"{t_q} tenant blocks > arena capacity {t_cap}")
        if n_valid is None:
            nv = np.full((t_q,), q, np.int64)
        else:
            nv = np.asarray(n_valid, np.int64).reshape(-1)
            if nv.shape[0] != t_q:
                raise ValueError(f"n_valid has {nv.shape[0]} rows, expected {t_q}")
        nv_full = np.zeros((t_cap,), np.int64)
        nv_full[:t_q] = np.minimum(nv, q)
        b = bucket_for("lookup_many", q)
        tp = t_cap // p
        lo = self.rank * tp
        cache = get_cache()

        def builder():
            def prog(arena, qp, counts):
                f, r = self.local.lookup_many(self._tenant_shard(arena, lo, lo + tp),
                                              qp[lo:lo + tp], np.asarray(counts[lo:lo + tp]))
                part = torch.stack([f.to(torch.int64), r], dim=-1)  # (tp, b, 2)
                glob = from_wire(all_gather_rows(to_wire(part), p, self.group))
                return glob[..., 0] != 0, glob[..., 1]

            return cache.traced(prog)

        prog = cache.program(
            ("lookup_many", self.name, t_cap, b, w, tree_geometry(stacked), p), builder)
        qp = pad_tail(pad_tail(queries, b, SENTINEL, dim=1), t_cap, SENTINEL, dim=0)
        found, rid = prog(stacked, qp, tuple(int(c) for c in nv_full))
        self.last_info = {"mesh_devices": p, "tenants_per_shard": tp}
        return found[:t_q, :q], rid[:t_q, :q]

    # ---------------------------------------------------- batched (many)
    def batched_extract_sort(self, words, bitmaps, rows, plans):
        """``run_many``'s batch axis over the group: rank ``i`` extracts and
        sorts members ``[i*k/p, (i+1)*k/p)`` through the local
        ``batched_extract_sort`` (on CUDA pext per member, then one stacked
        bitonic launch) and the sorted members are all-gathered: batch
        parallelism instead of the sample sort's key parallelism.  The
        program is cached per ``(k, n, W, Wc, p)``; a batch that does not
        tile the group runs unsharded.
        """
        k, n, w = (int(s) for s in words.shape)
        p = self.p
        if p == 1 or k % p:
            return self.local.batched_extract_sort(words, bitmaps, rows, plans)
        n_words_out = plans[0].n_words_out  # equal across the batch
        kp = k // p
        lo = self.rank * kp
        cache = get_cache()

        def builder():
            def prog(wds, bms, rws, member_plans):
                comp, rs = self.local.batched_extract_sort(
                    wds[lo:lo + kp], bms[lo:lo + kp], rws[lo:lo + kp],
                    list(member_plans[lo:lo + kp]))
                part = torch.cat([comp, rs[..., None]], dim=-1)  # (kp, n, Wc+1)
                glob = from_wire(all_gather_rows(to_wire(part), p, self.group))
                return glob[..., :n_words_out].contiguous(), glob[..., n_words_out].contiguous()

            return cache.traced(prog)

        prog = cache.program(("run_many", self.name, k, n, w, n_words_out, p), builder)
        self.last_info = {"mesh_devices": p, "batch_per_shard": kp}
        return prog(words, bitmaps, rows, tuple(plans))
