"""End-to-end index reconstruction (paper §5, Figure 7) — thin wrappers.

The pipeline — scan → compressed-key extract → parallel sort → bottom-up
build → DS-metadata refresh, with per-stage timings (Figure 9) — lives in
``repro_torch.core.pipeline.ReconstructionPipeline``; these are the stable
convenience entry points.  Both run on CUDA unless ``device`` names
another device.
"""

from __future__ import annotations

from .btree import BTreeConfig
from .keyformat import KeySet
from .metadata import DSMeta
from .pipeline import ReconstructionPipeline, ReconstructionResult

__all__ = ["ReconstructionResult", "reconstruct_index", "full_key_reconstruct"]


def reconstruct_index(
    keyset: KeySet,
    meta: DSMeta | None = None,
    config: BTreeConfig = BTreeConfig(),
    backend: str = "cuda",
    device=None,
) -> ReconstructionResult:
    """The compressed key sort pipeline of Figure 1 (bottom flow)."""
    pipe = ReconstructionPipeline(backend=backend, config=config, device=device)
    return pipe.run(keyset, meta=meta)


def full_key_reconstruct(
    keyset: KeySet,
    config: BTreeConfig = BTreeConfig(),
    backend: str = "cuda",
    device=None,
) -> ReconstructionResult:
    """Baseline (Figure 1 top flow): full key sort, then build.

    Identity metadata — every bit position is a distinction bit — so the
    same build path runs uncompressed, on any backend.
    """
    pipe = ReconstructionPipeline(backend=backend, config=config, device=device)
    return pipe.run(keyset, full_keys=True)
