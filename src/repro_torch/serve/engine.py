"""Batched serving engine: prefill + greedy/temperature decode loop.

Drives the model's ``prefill``/``decode_step`` with a contiguous KV cache
(the paged manager tracks logical->physical pages for admission control
and the restart-time index rebuild).  The engine runs eagerly on
``device`` (CUDA unless the caller names another); its pager rebuilds and
answers page gets on ``backend`` (``"cuda"``, the hand-written kernels,
unless the caller names ``"torch"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.u32 import resolve_device
from repro_torch.models.lm import LM

from .pager import PagedKVManager

__all__ = ["ServeEngine"]


@dataclass
class ServeEngine:
    model: LM
    params: dict
    max_seq: int
    batch_size: int
    page_tokens: int = 128
    #: concurrent-serving knobs, forwarded to the pager: serve page gets
    #: from the current published epoch while the journal is dirty
    #: (required when lookups run on reader threads), and optionally bound
    #: rebuild lag with admission control (see PagedKVManager)
    read_through_dirty: bool = False
    max_lag_epochs: int | None = None
    admission: str = "shed"
    #: the pager's reconstruction and lookup backend
    backend: str = "cuda"
    #: where the engine runs: CUDA unless the caller names one
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.pager = PagedKVManager(
            n_pages=self.batch_size * (-(-self.max_seq // self.page_tokens)) * 2,
            page_tokens=self.page_tokens,
            backend=self.backend,
            device=self.device,
            read_through_dirty=self.read_through_dirty,
            max_lag_epochs=self.max_lag_epochs,
            admission=self.admission,
        )
        self._cache = None
        self._pos = 0
        self._follow = None

    def _extras(self, extras: dict | None) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in (extras or {}).items()}

    def admit(self, tokens: np.ndarray, extras: dict | None = None) -> torch.Tensor:
        """Prefill a (B, T) batch of prompts; returns last-token logits."""
        B, T = tokens.shape
        if B != self.batch_size or T > self.max_seq:
            raise ValueError(f"prompts {tuple(tokens.shape)} do not fit batch_size "
                             f"{self.batch_size} and max_seq {self.max_seq}")
        for b in range(B):
            self.pager.pages_for(seq_id=b, n_tokens=T)
        self._cache = None  # the old cache goes before the new one is made
        cache = self.model.init_cache(B, self.max_seq)
        batch = {"tokens": torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                           device=self.device), **self._extras(extras)}
        self._cache, logits = self.model.prefill(self.params, batch, cache)
        self._pos = T
        return logits

    def step(self, tokens, extras: dict | None = None) -> torch.Tensor:
        """One decode step for the whole batch; returns (B, V) logits."""
        for b in range(self.batch_size):
            self.pager.pages_for(seq_id=b, n_tokens=self._pos + 1)
        batch = {
            "token": torch.as_tensor(tokens, dtype=torch.int64, device=self.device),
            "pos": self._pos,
            **self._extras(extras),
        }
        self._cache, logits = self.model.decode_step(self.params, self._cache, batch)
        self._pos += 1
        return logits

    def generate(self, prompts: np.ndarray, n_new: int, temperature: float = 0.0,
                 seed: int = 0, extras: dict | None = None) -> np.ndarray:
        """Greedy (or sampled) continuation of (B, T) prompts by n_new tokens.

        Sampling draws from a ``torch.Generator`` seeded with ``seed`` on
        the engine's device: a seed gives the same tokens on every run."""
        logits = self.admit(prompts, extras)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = self._pick(logits, temperature, gen)
        for _ in range(n_new):
            out.append(tok.cpu().numpy())
            if self._pos >= self.max_seq:
                break
            logits = self.step(tok, extras)
            tok = self._pick(logits, temperature, gen)
        return np.stack(out, axis=1)

    @staticmethod
    def _pick(logits: torch.Tensor, temperature: float, generator: torch.Generator):
        """Greedy argmax (the first maximal index), or a draw from
        ``softmax(logits / temperature)`` by the Gumbel-max trick."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)

    # ------------------------------------------------------------ page gets
    def lookup_page(self, seq_id: int, page_no: int) -> int | None:
        """Resolve a logical page through the index read path.

        On a primary this is the pager's snapshot-pinned ``lookup`` (the
        plan-cached backend op against the current epoch); on a following
        standby (``follow``) it reads through the stream replica's pinned
        snapshot — either way a get racing a rebuild answers from the
        pre-rebuild epoch, never a torn index.
        """
        if self._follow is not None:
            found, rid = self._follow.search(np.asarray([seq_id, page_no], np.uint32))
            return int(rid) if found else None
        return self.pager.lookup(seq_id, page_no)

    # ------------------------------------------------------- fault recovery
    def follow(self, stream_replica) -> None:
        """Run this engine as a streaming standby of another engine's pager.

        ``stream_replica`` is a ``repro_torch.replication.StreamReplica``
        over the transport a primary pager publishes to (see
        ``PagedKVManager.attach_stream``).  From then on ``restart``
        replays the *stream* instead of the local journal: the standby's
        page index is reconstructed from the primary's shipped change-log
        batches, so a failover starts from a warm, current index without
        ever receiving an index image.
        """
        self._follow = stream_replica

    def restart(self, backend: str | None = None) -> dict:
        """Simulated engine restart: decode state dropped, page index
        reconstructed from the page table (paper §5 applied to serving).
        ``backend`` picks the reconstruction substrate for this restart
        (defaults to the pager's configured backend).  After the first
        restart the pager replays its mutation log through the incremental
        delta-merge path — ``incremental``/``log_entries_replayed`` in the
        returned stats say which path ran and how much churn it folded.
        A following standby (``follow``) instead drains its stream replica
        and reports the stream watermark/lag alongside the rebuild stats;
        the stream replica's backend is fixed at construction, so passing
        ``backend`` to a following restart is an error, not a silent no-op.
        """
        if self._follow is not None:
            if backend is not None:
                raise ValueError(
                    "a following standby rebuilds on its StreamReplica's "
                    "backend; construct the replica with backend=... instead"
                )
            poll = self._follow.poll()
            rep = self._follow.replica
            if rep is None:
                raise RuntimeError("standby stream has delivered no state yet")
            res = rep.result
            # a shed frame can split the poll into several apply spans —
            # account for all of them, not just the last
            applies = poll.get("applies") or ([poll["apply"]] if poll.get("apply") else [])
            return {
                "index_height": res.tree.height,
                "compression_ratio": res.stats["compression_ratio"],
                "backend": res.stats["backend"],
                "followed_stream": True,
                "applied_lsn": poll["applied_lsn"],
                "lag_frames": poll["lag_frames"],
                "catchup": poll["catchup"],
                "incremental": bool(applies)
                and all(st.get("incremental", False) for st in applies),
                "log_entries_replayed": sum(
                    st.get("n_delta", 0) + st.get("n_deleted", 0) for st in applies
                ),
                "snapshot_epoch": rep.snapshots.epoch,
            }
        res = self.pager.rebuild_index(backend=backend)
        tm = res.timings
        stage_keys = ("meta", "extract", "sort", "build", "refresh_meta", "filter", "merge")
        return {
            "index_height": res.tree.height,
            "compression_ratio": res.stats["compression_ratio"],
            # the restart pays every stage, metadata refresh included —
            # tm["total"] is only the paper's extract+sort+build breakdown
            "rebuild_s": tm["meta"] + tm["total"] + tm["refresh_meta"],
            "backend": res.stats["backend"],
            "stage_s": {k: tm[k] for k in stage_keys if k in tm},
            "snapshot_epoch": self.pager.stats["snapshot_epoch"],
            **self.pager.stats["last_rebuild"],
        }
