"""Serving entry point: batched generation with the paged-KV engine.

  python -m repro_torch.launch.serve --arch llama3-8b [--reduced]

Runs on the GPU unless ``--device cpu`` is given (and raises where there
is none).  The weights are random, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.u32 import resolve_device
from repro_torch.launch.train import REPRO_100M, resolve_arch  # noqa: F401
from repro_torch.models.lm import LM
from repro_torch.serve.engine import ServeEngine

__all__ = ["REPRO_100M", "resolve_arch", "main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = resolve_arch(args.arch, args.reduced)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(model, params, max_seq=args.max_seq, batch_size=args.batch,
                         device=dev)

    rng = np.random.default_rng(args.seed)
    extras = {}
    if cfg.n_img_tokens:
        extras["img_embeds"] = rng.normal(
            size=(args.batch, cfg.n_img_tokens, cfg.d_model)
        ).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))

    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens, extras=extras or None)
    dt = time.perf_counter() - t0
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} on {device_name}: generated {out.shape} tokens in {dt:.2f}s "
          f"({out.size / dt:,.0f} tok/s)")
    print("first sequences:", out[:2, :12].tolist())
    print("pager:", engine.pager.stats)
    restart = engine.restart()
    print("restart (index rebuild):", restart)
    return {"tokens": out, "restart": restart}


if __name__ == "__main__":
    main()
