#!/usr/bin/env python
"""Chaos soak harness: replication under a hostile wire, byte-for-byte.

The port's twin of the reference's ``tools/chaos_soak.py``: the same
seeded schedules, the same churn, the same batches, on the port's
backends.  Drives a :class:`StreamPrimary` and a churning fleet of
supervised :class:`StreamReplica` consumers over a fault-injecting
transport (:class:`repro_torch.replication.chaos.FaultyTransport`) with a
seeded :class:`ChaosPlan` — drops, duplicates, reorders, bit flips,
delayed visibility, spurious truncation signals, and scheduled mid-stream
retention cuts — plus mid-span replica kill/restart churn, and then
asserts the invariants that make the fault layer trustworthy:

1. **byte identity** — after a fault-free drain every surviving replica's
   keyset, metadata, and standing reconstruction equal the primary's
   never-lagged tracked replica exactly (and again after the steady
   rounds);
2. **no quarantine leak** — bounded transient faults must be absorbed by
   the degradation ladder (retry -> resync -> checkpoint), never end in a
   quarantined supervisor;
3. **zero retraces in steady state** — once the constant-shape churn has
   warmed every program, the plan cache traces nothing new (the report's
   ``steady_traces``; on CUDA no lookup graph is captured again).

Every run is reproducible from ``(seed, transport, backend)``; the
injection ledger is part of the report, so a failure names exactly which
faults the schedule dealt.

Usage::

    PYTHONPATH=src python -m repro_torch.tools.chaos_soak --seeds 0-7 \
        --transports queue,dir --fast --backend torch --device cpu  # the CPU smoke
    PYTHONPATH=src python -m repro_torch.tools.chaos_soak --seeds 0-31 --soak

Every index lives on the GPU unless ``--device`` names another device,
whichever ``--backend`` (``cuda``, the default, or the plain ``torch``)
runs; without a GPU and without ``--device cpu`` the soak raises.
Exits non-zero if any run violates an invariant.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.core import plancache
from repro_torch.core.keyformat import KeySet
from repro_torch.replication import (
    ChangeLog,
    ChaosPlan,
    DirectoryTransport,
    FaultyTransport,
    QueueTransport,
    ReplicaSupervisor,
    StreamPrimary,
    StreamReplica,
    SupervisorPolicy,
)

#: constant batch churn: equal insert/delete volume keeps the keyset size
#: (and therefore every bucket) fixed across the whole soak
N_INS = N_DEL = 24
BASE_KEYS = 600


def _keyset(rng: np.random.Generator, n: int, w: int = 3) -> KeySet:
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    words &= np.uint32(0x00FF0F0F)
    return KeySet(
        words=words,
        lengths=np.full(n, w * 4, np.int32),
        rids=np.arange(n, dtype=np.uint32),
    )


def _batch(rng: np.random.Generator, prim: StreamPrimary) -> ChangeLog:
    """One constant-shape batch: re-draw live keys, retire as many rids.

    Re-drawing live key words adds no new distinction bits (the §4.3
    insert rule lands on already-set positions), so every warm apply stays
    on the incremental path.
    """
    ks = prim.replica.keyset
    log = ChangeLog(ks.n_words, start_lsn=prim.next_lsn)
    pick = rng.integers(0, ks.n, size=N_INS)
    log.append_inserts(
        np.asarray(ks.words)[pick],
        100_000 + rng.integers(0, 2**20, size=N_INS).astype(np.uint32),
    )
    dead = rng.choice(np.asarray(ks.rids), size=N_DEL, replace=False)
    log.append_deletes(dead)
    return log


def _identical(rep, ref) -> list[str]:
    """Byte-identity violations between a replica and the reference."""
    bad = []
    pairs = [
        ("keyset.words", rep.keyset.words, ref.keyset.words),
        ("keyset.rids", rep.keyset.rids, ref.keyset.rids),
        ("meta.dbitmap", rep.meta.dbitmap, ref.meta.dbitmap),
        ("meta.varbitmap", rep.meta.varbitmap, ref.meta.varbitmap),
        ("comp_sorted", rep.result.comp_sorted.cpu(), ref.result.comp_sorted.cpu()),
        ("rid_sorted", rep.result.rid_sorted.cpu(), ref.result.rid_sorted.cpu()),
    ]
    for name, a, b in pairs:
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            bad.append(name)
    if rep.applied_lsn != ref.applied_lsn:
        bad.append(f"applied_lsn {rep.applied_lsn} != {ref.applied_lsn}")
    return bad


def _mk_supervisor(
    transport, backend: str, device, start_pos: int = 0
) -> ReplicaSupervisor:
    rep = StreamReplica(
        transport, backend=backend, device=device, start_pos=start_pos,
        reorder_window=4,
    )
    # no real sleeping: the ladder's backoff schedule is exercised, the
    # wall clock is not (the whole soak must run in smoke-test time)
    return ReplicaSupervisor(
        rep, SupervisorPolicy(), clock=time.monotonic, sleep=lambda s: None
    )


def run_soak(
    seed: int,
    transport_kind: str,
    backend: str = "cuda",
    workdir: str | None = None,
    steps: int = 24,
    n_replicas: int = 3,
    intensity: float = 1.0,
    steady_rounds: int = 3,
    device=None,
) -> dict:
    """One seeded chaos run; returns a report with a ``violations`` list.

    ``workdir`` holds the spool and the checkpoints (a temporary
    directory, removed at the end, when ``None``); ``device`` is where
    every index lives (CUDA unless named).
    """
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_soak(seed, transport_kind, backend, tmp, steps, n_replicas,
                            intensity, steady_rounds, device)
    rng = np.random.default_rng(seed)
    root = Path(workdir)
    if transport_kind == "queue":
        inner = QueueTransport()
    elif transport_kind == "dir":
        inner = DirectoryTransport(root / "spool")
    else:
        raise ValueError(f"unknown transport kind {transport_kind!r}")
    plan = ChaosPlan.sample(seed, n_publishes_hint=steps + 4,
                            intensity=intensity)
    wire = FaultyTransport(inner, plan)

    prim = StreamPrimary(
        wire, _keyset(rng, BASE_KEYS), backend=backend, device=device,
        ckpt_dir=str(root / "ckpt"), max_lag_batches=3,
    )
    sups = [_mk_supervisor(wire, backend, device) for _ in range(n_replicas)]
    kill_at, restart_at = max(2, steps // 3), max(3, steps // 2)
    n_killed = 0

    # ---- chaos phase: publish, churn replicas, pump at skewed cadences
    for step in range(1, steps + 1):
        prim.publish(_batch(rng, prim))
        if step == kill_at and len(sups) > 1:
            sups.pop()  # a replica dies mid-span, state lost
            n_killed += 1
        if step == restart_at:
            # a fresh replica joins mid-stream: its cursor starts at 0,
            # long since truncated — the catch-up ladder brings it up
            sups.append(_mk_supervisor(wire, backend, device))
        for i, sup in enumerate(sups):
            if step % (i + 1) == 0:  # skewed cadence: replica i lags i+1 steps
                sup.pump()

    # ---- drain phase: faults off, one fault-free checkpoint at head
    wire.quiesce()
    prim.flush()
    prim.checkpoint()
    violations: list[str] = []
    for i, sup in enumerate(sups):
        for _ in range(40):
            out = sup.pump()
            if out.get("state") == "quarantined":
                break
            if "error_class" not in out and out.get("lag_frames", 1) == 0:
                break
        else:
            violations.append(f"replica {i} never converged: {out}")
        if sup.state == "quarantined":
            violations.append(f"replica {i} quarantine leak: {sup.stats()}")
        elif sup.replica.replica is None:
            violations.append(f"replica {i} never built an index")
        else:
            bad = _identical(sup.replica.replica, prim.replica)
            if bad:
                violations.append(f"replica {i} diverged: {bad}")

    # ---- steady phase: warm the constant shapes, then demand 0 traces
    for _ in range(2):
        prim.publish(_batch(rng, prim))
        for sup in sups:
            sup.pump()
    t0 = plancache.cache_stats()["traces"]
    for _ in range(steady_rounds):
        prim.publish(_batch(rng, prim))
        for sup in sups:
            out = sup.pump()
            if "error_class" in out:
                violations.append(f"steady-state pump faulted: {out}")
    steady_traces = plancache.cache_stats()["traces"] - t0
    if steady_traces != 0:
        violations.append(f"steady_state_traces={steady_traces}, want 0")
    for i, sup in enumerate(sups):
        if sup.replica.replica is None:
            continue  # already reported above
        bad = _identical(sup.replica.replica, prim.replica)
        if bad:
            violations.append(f"replica {i} diverged post-steady: {bad}")

    return {
        "seed": seed,
        "transport": transport_kind,
        "backend": backend,
        "steps": steps,
        "plan": {
            k: getattr(plan, k)
            for k in ("p_drop_publish", "p_duplicate", "p_reorder",
                      "p_corrupt", "p_delay", "p_spurious_truncated",
                      "truncate_at")
        },
        "faults_injected": dict(wire.counts),
        "n_killed": n_killed,
        "survivors": len(sups),
        "steady_traces": int(steady_traces),
        "supervisors": [sup.stats() for sup in sups],
        "violations": violations,
    }


def _parse_seeds(spec: str) -> list[int]:
    """``"0-7"`` or ``"1,3,9"`` (or a mix) -> a list of seeds."""
    seeds: list[int] = []
    for part in spec.split(","):
        if "-" in part.strip().lstrip("-"):
            lo, hi = part.split("-", 1)
            seeds.extend(range(int(lo), int(hi) + 1))
        else:
            seeds.append(int(part))
    return seeds


def main(argv: "list[str] | None" = None) -> int:
    """CLI entry point; returns the process exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-3", help="range (0-7) or list (1,3)")
    ap.add_argument("--transports", default="queue,dir")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--device", default=None,
                    help="where every index lives (default: cuda; cpu runs on the host)")
    ap.add_argument("--steps", type=int, default=None,
                    help="chaos steps per run (default 12 fast / 40 soak)")
    ap.add_argument("--intensity", type=float, default=1.0,
                    help="scale all sampled fault probabilities")
    ap.add_argument("--fast", action="store_true",
                    help="smoke sizing (fewer steps, 2 replicas)")
    ap.add_argument("--soak", action="store_true",
                    help="full sweep sizing (long runs, 3 replicas)")
    ap.add_argument("--json", action="store_true",
                    help="dump the full per-run reports as JSON")
    args = ap.parse_args(argv)

    steps = args.steps or (40 if args.soak else 12 if args.fast else 24)
    n_replicas = 2 if args.fast else 3
    failures = 0
    reports = []
    for kind in args.transports.split(","):
        for seed in _parse_seeds(args.seeds):
            rep = run_soak(
                seed, kind.strip(), args.backend, None,
                steps=steps, n_replicas=n_replicas,
                intensity=args.intensity, device=args.device,
            )
            reports.append(rep)
            ok = not rep["violations"]
            failures += 0 if ok else 1
            faults = sum(rep["faults_injected"].values())
            print(
                f"[{'ok' if ok else 'FAIL'}] seed={seed} "
                f"transport={rep['transport']} backend={rep['backend']} "
                f"faults={faults} survivors={rep['survivors']} "
                f"steady_traces={rep['steady_traces']}"
                + ("" if ok else f" violations={rep['violations']}")
            )
    if args.json:
        print(json.dumps(reports, indent=2, default=str))
    print(f"{len(reports)} runs, {failures} failing")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
