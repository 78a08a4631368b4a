"""Split the serving harnesses' loaded latency between the card and the host.

    PYTHONPATH=src python3 scripts/serve_load.py [--reps 1] [--n-keys 4194304]

Runs ``repro_torch.serve.loadgen.run_load`` at ``chip_smoke.py``'s load
settings (two-word keys from ``--n-keys`` draws, probe batches of 256,
mutation batches of 1,024, 5 s a run) and ``run_pager_load`` at its pager
settings (2^17 pages of 16 tokens, 4,000 sequences of 32 pages, 5 s),
each a few ways: 8 readers racing the writer (the smoke test's point); 8
readers with the writer idle after its first cycle (a period of 60 s);
one reader racing the writer (``run_load`` only); and 8 readers racing
the writer with the interpreter's thread switch interval at 0.1 ms
instead of 5 ms.  If the readers wait for the interpreter lock behind
the writer's host work, the idle writer and the short interval cut the
loaded p50 while the single reader keeps it near the unloaded one.  A
first line counts the PyTorch operations one 256-query lookup dispatches
on the card at that size (each hands the interpreter lock back).  One
JSON line a run, each with the card's name and power limit as
``nvidia-smi`` gives them; the script imports only what its
``PYTHONPATH`` gives.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.backends import get_backend
from repro_torch.core.pipeline import ReconstructionPipeline
from repro_torch.core.u32 import to_carrier
from repro_torch.serve.loadgen import _probe_batch, _probe_keyset, run_load, run_pager_load

#: the report fields each line keeps
FIELDS = ("n_requests", "n_shed", "epochs_published", "lookups_per_s", "p50_us", "p90_us",
          "p99_us", "duration_s", "torn_reads", "stale_epochs", "errors")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def lookup_ops(n_keys: int) -> dict:
    """The operations of one ``run_load`` lookup: ``n_keys`` draws, the
    probe batch of 256, the ``"cuda"`` backend on the card."""
    ks = _probe_keyset(np.random.default_rng(0), n_keys, 2)
    res = ReconstructionPipeline(backend="cuda", device="cuda").run(ks)
    _, _, probe = _probe_batch(np.asarray(ks.words), 256, 1024)
    backend, q = get_backend("cuda", device="cuda"), to_carrier(probe, "cuda")
    backend.lookup(res.tree, q)
    with _OpCount() as count:
        found, rid = backend.lookup(res.tree, q)
        found.cpu(), rid.cpu()
    return {"n_keys": ks.n, "tree_height": res.tree.height, "aten_ops_per_lookup": count.n}


def with_switch_interval(interval: float | None, fn):
    """``fn()`` with the interpreter's switch interval set, then restored."""
    old = sys.getswitchinterval()
    if interval is not None:
        sys.setswitchinterval(interval)
    try:
        return fn()
    finally:
        sys.setswitchinterval(old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--n-keys", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(json.dumps({"run": "lookup_ops", **lookup_ops(args.n_keys), "card": card}),
          flush=True)
    load = dict(backend="cuda", device="cuda", n_keys=args.n_keys, n_words=2, batch=256,
                mutation_batch=1024, duration_s=5.0)
    pager = dict(backend="cuda", device="cuda", n_pages=1 << 17, page_tokens=16,
                 n_seqs=4000, pages_per_seq=32, n_readers=8, duration_s=5.0)
    failed = False
    for rep in range(args.reps):
        runs = [
            ("load_loaded", None, lambda: run_load(**load, n_readers=8, seed=rep)),
            ("load_writer_idle", None,
             lambda: run_load(**load, n_readers=8, mutation_period_s=60.0, seed=rep)),
            ("load_one_reader", None, lambda: run_load(**load, n_readers=1, seed=rep)),
            ("load_switch_0.1ms", 1e-4, lambda: run_load(**load, n_readers=8, seed=rep)),
            ("pager_loaded", None, lambda: run_pager_load(**pager, seed=rep)),
            ("pager_writer_idle", None,
             lambda: run_pager_load(**pager, rebuild_period_s=60.0, seed=rep)),
            ("pager_switch_0.1ms", 1e-4, lambda: run_pager_load(**pager, seed=rep)),
        ]
        for name, interval, fn in runs:
            out = with_switch_interval(interval, fn)
            row = out if isinstance(out, dict) else {**out.to_row(), "errors": out.errors}
            line = {"rep": rep, "run": name, **{k: row[k] for k in FIELDS}}
            if "unloaded_p50_us" in row:
                line["unloaded_p50_us"] = row["unloaded_p50_us"]
            line["card"] = card
            failed |= bool(row["errors"] or row["torn_reads"] or row["stale_epochs"])
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
