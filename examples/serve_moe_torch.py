"""Serve a (reduced) Qwen3-MoE model on the PyTorch + CUDA port with the
compressed-key-sort dispatch and the paged KV cache whose page index is a
reconstructable B-tree, rebuilt on the hand-written kernels.

  PYTHONPATH=src python examples/serve_moe_torch.py               # the GPU
  PYTHONPATH=src python examples/serve_moe_torch.py --device cpu  # the host

The twin of ``examples/serve_moe.py``.  ``--device cpu`` runs the same
``"cuda"`` pager with every kernel's plain version.
"""

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.models.lm import LM
from repro_torch.serve import ServeEngine


def main(argv=None) -> dict:
    """Generate, restart, look a page up; returns ``{"tokens", "restart",
    "page", "engine"}`` (``page``: the physical page the index gives for
    sequence 2's page 1)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = replace(ARCHS["qwen3-moe-235b-a22b"].reduced(), dispatch_mode="sort")
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"== serving {cfg.name} (reduced; {cfg.n_experts} experts top-{cfg.top_k}, "
          f"sort-based dispatch) on {model.device} ==")

    eng = ServeEngine(model, params, max_seq=96, batch_size=4, page_tokens=16,
                      device=model.device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    out = eng.generate(prompts, n_new=16, temperature=0.8)
    print(f"   generated {out.shape[1]} tokens x {out.shape[0]} seqs")
    print(f"   pager: {eng.pager.stats}")

    print("== engine restart: page index reconstruction ==")
    st = eng.restart()
    print(f"   rebuilt in {st['rebuild_s']*1e3:.1f}ms, "
          f"compression {st['compression_ratio']:.2f}:1, "
          f"height {st['index_height']}")
    phys = eng.pager.lookup(seq_id=2, page_no=1)
    print(f"   lookup (seq 2, page 1) -> physical page {phys}")
    return {"tokens": out, "restart": st, "page": phys, "engine": eng}


if __name__ == "__main__":
    main()
