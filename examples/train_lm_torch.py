"""End-to-end training on the PyTorch + CUDA port: train the ~100M-parameter
repro-100m model with the full substrate — the compressed-key-sort data
shuffle on the hand-written kernels, rematerialised microbatched AdamW,
atomic checkpoints, crash-restart through the reconstructed manifest index.

  PYTHONPATH=src python examples/train_lm_torch.py                   # ~300 steps
  PYTHONPATH=src python examples/train_lm_torch.py --quick           # smoke
  PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu

The twin of ``examples/train_lm.py``: the same arguments reach
``repro_torch.launch.train.main``.  It runs on the GPU unless ``--device
cpu`` is given.  Run it again on the same ``--ckpt-dir`` and it resumes
from the last checkpoint.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    """Train; returns ``repro_torch.launch.train.main``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_100m_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    steps, batch, seq, every = (30, 4, 128, 25) if args.quick else (300, 8, 256, 100)
    run = ["--arch", "repro-100m", "--steps", str(steps), "--batch", str(batch),
           "--seq", str(seq), "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(every)]
    if args.device is not None:
        run += ["--device", args.device]
    return train_main(run)


if __name__ == "__main__":
    main()
