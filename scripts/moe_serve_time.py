"""Time qwen3-moe serving on one card and print each repetition as a JSON line.

    PYTHONPATH=src python3 scripts/moe_serve_time.py [--tag NAME] [--reps 3]

qwen3-moe-235b-a22b at full width with its 94 layers cut to 2, random
bf16 weights from ``--seed``, the sort dispatch: a 4 x 512-token prefill,
then ``--decode`` greedy steps, as ``chip_smoke.py``'s ``[lm_serve]``
serves it, without the engine's pager.  Each repetition prints the
prefill's wall and each decode step's, every wall ending in a wait for
the card, with the card's name and power limit.  The script imports only
what its ``PYTHONPATH`` gives, so the same file times any checkout of the
port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.models.lm import LM


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a name printed on every line")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"], n_layers=args.layers,
                              dispatch_mode="sort")
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt))).to(dev)

    def wall(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    with torch.no_grad():
        for rep in range(args.reps):
            cache = model.init_cache(args.batch, args.prompt + args.decode)
            (cache, lg), prefill_s = wall(lambda: model.prefill(params, {"tokens": prompts}, cache))
            steps = []
            for i in range(args.decode):
                tok = lg.argmax(-1)
                (cache, lg), s = wall(lambda: model.decode_step(
                    params, cache, {"token": tok, "pos": args.prompt + i}))
                steps.append(s * 1e3)
            print(json.dumps({"tag": args.tag, "rep": rep, "layers": args.layers,
                              "batch": args.batch, "prompt": args.prompt,
                              "prefill_s": prefill_s, "decode_ms": steps,
                              "decode_ms_median": statistics.median(steps),
                              "logits_finite": bool(torch.isfinite(lg).all()),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
