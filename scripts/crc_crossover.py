"""Time the two CRC32C evaluations of ``replication/wire.py`` on the host.

    PYTHONPATH=src python3 scripts/crc_crossover.py [--reps 3] [--max-log2 22]

For payloads of 2^8 up to 2^max-log2 bytes (seeded random bytes), it
prints one JSON line a size with the best of ``--reps`` walls of the
byte loop (``_crc_bytes``) and two walls of the chunk-parallel numpy
evaluation (``_crc_parallel``): cold, its zeros tables built in the
call, and warm, as they are for a chunk length that recurs (every
payload under 4 x ``_PARALLEL_CHUNKS`` bytes has 4-byte chunks).  It
checks that both
give the same register, and ends with the smallest size from which the
parallel evaluation is the faster at that size and at every larger one,
warm below 4 x ``_PARALLEL_CHUNKS`` bytes and cold from there: the value
for ``wire._PARALLEL_MIN``.  Host work only; no device is used.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

import numpy as np

from repro_torch.replication import wire


def best_wall(fn, reps: int) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-log2", type=int, default=22)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    rows = []
    for log2 in range(8, args.max_log2 + 1):
        data = rng.integers(0, 256, size=1 << log2, dtype=np.uint8).tobytes()
        want = wire._crc_bytes(0xFFFFFFFF, data)
        wire._zeros_tables.cache_clear()
        t0 = time.perf_counter()
        check = wire._crc_parallel(0xFFFFFFFF, data)
        cold = time.perf_counter() - t0
        if check != want:
            raise SystemExit(f"the evaluations disagree at {len(data)} bytes")
        warm = best_wall(lambda: wire._crc_parallel(0xFFFFFFFF, data), args.reps)
        row = {"bytes": len(data),
               "byte_loop_s": best_wall(lambda: wire._crc_bytes(0xFFFFFFFF, data), args.reps),
               "parallel_cold_s": cold, "parallel_warm_s": warm,
               "parallel_s": warm if len(data) < 4 * wire._PARALLEL_CHUNKS else cold}
        rows.append(row)
        print(json.dumps(row), flush=True)
    crossover = None
    for i, row in enumerate(rows):
        if all(r["parallel_s"] < r["byte_loop_s"] for r in rows[i:]):
            crossover = row["bytes"]
            break
    print(json.dumps({"crossover_bytes": crossover, "parallel_min_now": wire._PARALLEL_MIN,
                      "cpu": platform.processor() or platform.machine(),
                      "python": platform.python_version(), "numpy": np.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
