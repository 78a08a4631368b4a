"""End-to-end training entry point.

Trains a model with the full substrate: synthetic Zipf token pipeline
(compressed-key-sort shuffle on the ``"cuda"`` backend's kernels),
microbatched AdamW train step on f32 master parameters, periodic atomic
checkpoints, and crash-restart via the reconstructed manifest index.

  python -m repro_torch.launch.train --arch repro-100m --steps 300
  python -m repro_torch.launch.train --arch llama3-8b --reduced --device cpu

Runs on the GPU unless ``--device cpu`` is given (and raises where there
is none).  The weights are random, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.core.u32 import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.lm import LM
from repro_torch.train.optim import OptConfig, adamw_init
from repro_torch.train.trainstep import make_train_step

__all__ = ["REPRO_100M", "resolve_arch", "main"]

# ~100M-param end-to-end example model: dense llama-style
REPRO_100M = ArchConfig(
    name="repro-100m",
    family="dense",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=32768,
    pattern=((("attn", "dense")),),
    rope_theta=10000.0,
    q_chunk=128,
    kv_chunk=128,
    loss_chunk=128,
)


def resolve_arch(name: str, reduced: bool) -> ArchConfig:
    cfg = REPRO_100M if name == "repro-100m" else ARCHS[name]
    return cfg.reduced() if reduced else cfg


def main(argv=None) -> dict:
    """Train; returns ``{"params", "opt", "losses" (step -> loss),
    "restored" (the restore's stats, or None), "saves" (one {step, wall_s,
    path} a checkpoint), "tokens_per_s"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = resolve_arch(args.arch, args.reduced)
    model = LM(cfg, device=dev)
    print(f"arch={cfg.name} params~{cfg.total_params()/1e6:.1f}M "
          f"active~{cfg.active_params()/1e6:.1f}M on {dev}")

    docs = lm_tokens(
        n_docs=max(args.batch * 64, 512), doc_len=args.seq + 1,
        vocab=cfg.vocab_size, seed=args.seed,
    )
    pipe = TokenPipeline(docs, args.batch, args.seq, seed=args.seed, device=dev)

    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=20, decay_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum=args.accum)

    params = model.init_master(torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    start, restored = 0, None
    prev = latest_step(args.ckpt_dir)
    if prev is not None:
        (params, opt), restored = restore_checkpoint(
            args.ckpt_dir, prev, (params, opt), device=dev, index_device=dev
        )
        start = restored["meta"]["step"]
        print(f"restored step {start} (manifest index rebuilt in "
              f"{restored['index_rebuild_s']*1e3:.1f} ms, "
              f"compression {restored['compression_ratio']:.2f}:1)")

    t0 = time.time()
    tokens_done = 0
    losses, saves = {}, []
    for step in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, pipe.batch_at(step))
        losses[step + 1] = metrics["loss"]
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            tps = tokens_done / (time.time() - t0)
            print(f"step {step+1:5d} loss={m['loss']:.4f} "
                  f"xent={m.get('xent', m['loss']):.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} tok/s={tps:,.0f}",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            ts = time.time()
            path = save_checkpoint(
                args.ckpt_dir, step + 1, (params, opt),
                extra_meta={"step": step + 1, "arch": cfg.name}, device=dev,
            )
            saves.append({"step": step + 1, "wall_s": time.time() - ts, "path": str(path)})
            print(f"checkpointed -> {path}")
    wall = time.time() - t0
    print(f"done: {args.steps - start} steps, "
          f"{tokens_done/1e6:.2f}M tokens in {wall:.1f}s")
    return {"params": params, "opt": opt, "losses": {k: float(v) for k, v in losses.items()},
            "restored": restored, "saves": saves,
            "tokens_per_s": tokens_done / wall if wall > 0 else 0.0}


if __name__ == "__main__":
    main()
