"""Async streaming replication on the PyTorch + CUDA port: one primary, two
lagging replicas.

The paper's motivating scenario (§1, §6) end to end: the wire carries the
table's change log and checkpoint *manifests* — never an index image —
and every consumer keeps its index current by reconstructing with the
compressed key sort on the hand-written kernels:

* the **primary** owns the table, ships LSN-ordered ``ChangeLog`` batches
  over a ``DirectoryTransport`` spool, and checkpoints its state through
  ``save_checkpoint`` / ``save_checkpoint_delta`` chains;
* **replica A** tails the stream: every poll folds the pending batches
  through ONE incremental delta-merge rebuild (sort the delta, merge into
  the standing run);
* **replica B** sleeps through most of the stream; bounded-lag
  backpressure makes the primary checkpoint + truncate the spool, so B is
  forced onto the catch-up path — restore the checkpoint chain, then tail
  — and still lands **byte-identical** to A and to the primary.

  PYTHONPATH=src python examples/replication_torch.py [--fast] [--device cpu]

The twin of ``examples/replication.py``.  It runs on the GPU unless
``--device cpu`` is given, where the ``"cuda"`` backend runs every
kernel's plain version.
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs.paper_index import ZipfConfig
from repro_torch.data.synthetic import zipf_keys
from repro_torch.replication import (
    ChangeLog,
    DirectoryTransport,
    StreamPrimary,
    StreamReplica,
)


def _same_bytes(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def identical(a, b) -> bool:
    """Byte-identity of two replicas' standing state."""
    return (
        _same_bytes(a.result.comp_sorted, b.result.comp_sorted)
        and _same_bytes(a.result.rid_sorted, b.result.rid_sorted)
        and np.array_equal(a.meta.dbitmap, b.meta.dbitmap)
        and a.applied_lsn == b.applied_lsn
    )


def main(argv=None) -> dict:
    """Run the scenario; returns ``{"a_equals_b", "a_equals_primary",
    "catchup", "applied_lsn", "probe"}`` and raises ``SystemExit`` if the
    replicas diverge."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="smaller sizes (CI smoke)")
    ap.add_argument("--backend", default="cuda", help="replica backend (cuda/torch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n_keys = 4096 if args.fast else 32768
    n_batches = 10 if args.fast else 14
    batch = 128 if args.fast else 512
    opts = {"backend": args.backend, "device": args.device}

    rng = np.random.default_rng(0)
    base = zipf_keys(ZipfConfig(1.5, 40, 0, n_keys=n_keys), seed=0)

    with tempfile.TemporaryDirectory() as d:
        transport = DirectoryTransport(d + "/spool")
        primary = StreamPrimary(
            transport, base,
            ckpt_dir=d + "/ckpt",
            max_lag_batches=2,       # bounded lag: checkpoint + truncate past 2
            coalesce_min=batch,      # ship bucket-aligned batches
            **opts,
        )
        rep_a = StreamReplica(transport, **opts)
        rep_b = StreamReplica(transport, **opts)

        st = rep_a.poll()
        print(f"== replica A bring-up from the genesis batch on {rep_a.device}: "
              f"{st['apply']['n_keys']} keys ==")

        next_rid = n_keys
        for b in range(n_batches):
            log = ChangeLog(base.n_words, start_lsn=primary.next_lsn)
            pick = rng.integers(0, primary.replica.keyset.n, size=batch)
            log.append_inserts(
                np.asarray(primary.replica.keyset.words)[pick],
                np.arange(next_rid, next_rid + batch, dtype=np.uint32),
            )
            next_rid += batch
            dead = rng.choice(np.asarray(primary.replica.keyset.rids),
                              size=batch // 4, replace=False)
            log.append_deletes(dead)
            primary.publish(log)

            t0 = time.perf_counter()
            st = rep_a.poll()     # A stays current; B sleeps
            if st["apply"]:
                a = st["apply"]
                path = "noop" if a.get("noop") else (
                    "incremental" if a["incremental"] else f"full ({a['fallback']})")
                print(f"   batch {b}: A applied {st['applied_batches']} frame(s) "
                      f"[{path}] +{a['n_delta']} -{a['n_deleted']} "
                      f"in {(time.perf_counter()-t0)*1e3:.1f}ms "
                      f"(lsn {st['applied_lsn']}, B lags {rep_b.lag_frames()} frames)")

        print(f"== primary: {primary.stats['n_batches_published']} batches, "
              f"{primary.stats['ckpt_step']} checkpoint step(s), "
              f"{primary.stats['transport_retained']} frames retained ==")

        t0 = time.perf_counter()
        st = rep_b.poll()
        print("== replica B wakes up: catch-up from the checkpoint chain ==")
        print(f"   catchup={st['catchup']} "
              f"(truncation jumped: {st['truncated_jump']}), then applied "
              f"{st['applied_batches']} batch frame(s) in "
              f"{time.perf_counter()-t0:.2f}s -> lsn {st['applied_lsn']}")

        ok_ab = identical(rep_a.replica, rep_b.replica)
        ok_ap = identical(rep_a.replica, primary.replica)
        print(f"   byte-identical: A==B {ok_ab}, A==primary {ok_ap}")
        if not (ok_ab and ok_ap):
            raise SystemExit("replicas diverged")

        # a point lookup answers the same everywhere
        probe = np.asarray(primary.replica.keyset.words)[17]
        answers = [primary.replica.search(probe), rep_a.search(probe), rep_b.search(probe)]
        print(f"   probe lookup: primary={answers[0]} A={answers[1]} B={answers[2]}")
        return {"a_equals_b": ok_ab, "a_equals_primary": ok_ap, "catchup": st["catchup"],
                "applied_lsn": st["applied_lsn"], "probe": answers}


if __name__ == "__main__":
    main()
