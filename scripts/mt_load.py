"""Repeat the multi-tenant load harness and print each run as a JSON line.

    PYTHONPATH=src python3 scripts/mt_load.py [--tag NAME] [--reps 2]

Each repetition runs ``repro_torch.serve.loadgen.run_multitenant_load``
at ``chip_smoke.py``'s mt_load settings (8 tenants of 2^17 four-word
keys, 8 readers, batches and mutation batches of 1024, 5 s a run) four
ways: the writer alone (no readers: how fast it rebuilds and publishes),
the readers unloaded, with the SLO at 4x that run's unloaded p50 (the
rule ``chip_smoke.py`` uses) and with the SLO at a fixed target, which
holds two checkouts to the same target.  The script imports only what its
``PYTHONPATH`` gives, so the same file measures any checkout of the port.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.serve.loadgen import run_multitenant_load

#: the report's fields that each line keeps
FIELDS = ("epochs_published", "n_batches", "n_requests", "n_shed", "lookups_per_s",
          "unloaded_p50_us", "p50_us", "p99_us", "duration_s", "torn_reads", "stale_epochs",
          "errors")
#: the fixed SLO target (about 4x the unloaded p50 that chip_smoke.py's
#: mt_load phase reads on an H100)
FIXED_P99_US = 28000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a name printed on every line")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    opts = dict(backend="cuda", device="cuda", n_tenants=8, n_keys=1 << 17, n_words=4,
                batch=1024, mutation_batch=1024, duration_s=5.0)
    for rep in range(args.reps):
        writer = run_multitenant_load(**opts, n_readers=0, seed=rep)
        plain = run_multitenant_load(**opts, n_readers=8, seed=rep)
        runs = [("writer_alone", writer, None), ("unloaded", plain, None)]
        for name, target in (("slo_4x_p50", 4 * plain["unloaded_p50_us"]),
                             ("slo_fixed", FIXED_P99_US)):
            runs.append((name, run_multitenant_load(**opts, n_readers=8, seed=rep,
                                                    target_p99_us=target), target))
        for name, rep_out, target in runs:
            line = {"tag": args.tag, "rep": rep, "run": name, "target_p99_us": target,
                    **{k: rep_out[k] for k in FIELDS}}
            # every tenant publishes twice before the timed window: its
            # first build and its warm-up writer cycle
            line["epochs_in_window"] = rep_out["epochs_published"] - 2 * 8
            line["ms_per_epoch"] = 1e3 * rep_out["duration_s"] / max(line["epochs_in_window"], 1)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
