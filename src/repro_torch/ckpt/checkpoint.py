"""Checkpointing with reconstructable manifest index (fault tolerance).

The port of the reference's ``ckpt/checkpoint.py``: the same directory
layout, file names, manifest keys and DS-metadata, so a checkpoint
written by either package restores in the other.

Layout of a checkpoint directory:

  step_<N>/                          — a FULL (base) step
    manifest.npz       — the TABLE: rows of (key, file, shape, dtype)
                         where key = fnv1a(param path) || shard coords
    dsmeta.npz         — DS-metadata of the manifest keys (D-bitmap etc.)
    <leaf files>.npy   — one array per leaf (full array)
    DONE               — commit marker (atomic-rename protocol)

  step_<M>/                          — a DELTA step (base step + log)
    delta_log.npz      — a ``repro_torch.replication.ChangeLog`` (LSN-stamped
                         insert/delete entries over manifest keys) plus the
                         delta file names and the base step number
    dsmeta.npz         — base DS-metadata advanced by the §4.3 insert rule
    <changed leaves>.npy — only leaves that changed vs the base
    DONE

Exactly as in the paper's main-memory DBMS setting, the *search index* over
the manifest is never serialized — only the DS-metadata is — and restore
begins by RECONSTRUCTING the key index with the compressed key sort
(``repro_torch.core.pipeline``).  Delta steps push the same premise one
step further: restore replays the log onto the base manifest and rebuilds
through ``ReconstructionPipeline.run_incremental`` — unchanged D-bitmap ⇒
only the changed rows are sorted and merged into the base run.  Unchanged
leaf payloads are read from the base step's directory (manifest file
entries are step-relative paths), so a delta step stores only what moved.

A tree is nested dicts, lists, tuples and named tuples of arrays; it is
flattened as the reference flattens a pytree: dict keys in sorted order
(an ``OrderedDict`` in its own order), a leaf named by its path joined
with ``/`` — a dict key as ``str(key)``, a sequence index as ``[i]``, a
named tuple's field as ``.name`` — and ``None`` holding no leaf.  Leaf
``i`` of the flattening is stored as ``leaf_{i:06d}.npy``.  A leaf may be
a numpy array or a tensor on any device and of any dtype: it is saved as
the reference saves the array of the same dtype, so a bfloat16 leaf is
stored as its raw two-byte words (numpy's ``V2``) and restores as ``V2``
in either package; ``restore_checkpoint(device=...)`` turns such a leaf
back into a bfloat16 tensor.

Fault-tolerance properties:
  * atomic commit (DONE marker written last; partial checkpoints ignored);
  * ``latest_step`` scans for the newest committed step -> crash-restart;
  * arrays are saved whole: a tree of DTensors (a sharded train state) is
    gathered leaf by leaf (``full_tensor``, on every rank) and rank 0
    writes it, so the files are byte for byte an unsharded save's;
    ``restore_checkpoint(device=...)`` places each leaf on the restoring
    device, and ``restore_checkpoint(shardings=...)`` re-places it on a
    mesh — any mesh, not the one it was saved from (elastic restore);
  * delta chains: a delta step's base may itself be a delta step — restore
    folds the chain recursively.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.keyformat import KeySet
from repro_torch.core.metadata import DSMeta
from repro_torch.core.pipeline import ReconstructionPipeline, ReconstructionResult
from repro_torch.core.u32 import resolve_device, to_carrier

__all__ = [
    "save_checkpoint",
    "save_checkpoint_delta",
    "restore_checkpoint",
    "latest_step",
    "step_manifest",
    "CheckpointIndex",
]


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for c in s.encode():
        h = ((h ^ c) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _children(node) -> list[tuple[str, object]] | None:
    """A tree node's (path part, child) pairs in flattening order; ``None``
    for a leaf."""
    if isinstance(node, OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _leaves(node, path: tuple = ()):
    """(path parts, leaf) of every leaf, in flattening order."""
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield path, node
        return
    for part, child in kids:
        yield from _leaves(child, path + (part,))


def _leaf_array(leaf) -> np.ndarray:
    """A leaf as the array the reference would save for it: a tensor comes
    to the host; bfloat16 (which numpy lacks) as its raw ``V2`` words."""
    if isinstance(leaf, DTensor):  # every rank gathers; a collective
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _names(tree) -> list[str]:
    return ["/".join(path) for path, _ in _leaves(tree)]


def _iter_flat(tree):
    """(name, array) of every leaf, each brought to the host only as the
    iteration reaches it."""
    return (("/".join(path), _leaf_array(leaf)) for path, leaf in _leaves(tree))


def _flatten(tree) -> list[tuple[str, np.ndarray]]:
    return list(_iter_flat(tree))


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, OrderedDict):
        return OrderedDict((k, _unflatten(v, leaves)) for k, v in like.items())
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    values = [_unflatten(v, leaves) for _, v in kids]
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _manifest_key(name: str, shard: int = 0) -> np.ndarray:
    """96-bit manifest key: 64-bit path hash || 32-bit shard coord."""
    h = _fnv1a(name)
    return np.asarray([h >> 32, h & 0xFFFFFFFF, shard], dtype=np.uint32)


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, tree,
                    extra_meta: dict | None = None, device=None) -> Path:
    """Write a full (base) checkpoint step and commit it atomically.

    Persists every tree leaf as its own file, the manifest table
    (hashed-path keys → files), and ONLY the DS-metadata of the manifest
    keys — the search index is reconstructed on restore, never stored.
    The DS-metadata is derived on ``device`` (CUDA unless named).
    ``extra_meta`` lands in the step's ``meta.json``.  Returns the
    committed step directory.
    """
    from repro_torch.core.metadata import meta_from_keys

    device = resolve_device(device)  # before any file is written
    if any(isinstance(leaf, DTensor) for _, leaf in _leaves(tree)) and dist.get_rank() != 0:
        for _ in _iter_flat(tree):  # the gathers rank 0 writes from
            pass
        dist.barrier()
        return Path(ckpt_dir) / f"step_{step:08d}"
    root = Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    rows_keys, rows_files, rows_names = [], [], []
    for i, (name, arr) in enumerate(_iter_flat(tree)):
        fn = f"leaf_{i:06d}.npy"
        np.save(tmp / fn, arr)
        rows_keys.append(_manifest_key(name))
        rows_files.append(fn)
        rows_names.append(name)

    keys = np.stack(rows_keys)  # (n, 3) uint32
    np.savez(
        tmp / "manifest.npz",
        keys=keys,
        files=np.asarray(rows_files),
        names=np.asarray(rows_names),
    )
    # persist ONLY the DS-metadata of the manifest keys — the index itself
    # is reconstructed on restore (the paper's premise)
    meta = meta_from_keys(keys, device)
    np.savez(tmp / "dsmeta.npz", **meta.to_npz_dict())
    (tmp / "meta.json").write_text(json.dumps({"step": step, **(extra_meta or {})}))
    (tmp / "DONE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    if any(isinstance(leaf, DTensor) for _, leaf in _leaves(tree)):
        dist.barrier()  # the other ranks return once the step is committed
    return final


def _manifest_view(root: Path, step: int):
    """The folded manifest of a step, host-side — no index reconstruction.

    Returns ``(live_keys (n, 3), live_rids (n,), files_slots, names_slots)``
    with file paths relative to the step's own directory.  Rids are *slot*
    indices into the (append-only) files/names lists; delta chains fold
    recursively through their logs.  This is the cheap manifest read the
    save path uses; restores go through ``CheckpointIndex``, which also
    rebuilds the search index.
    """
    from repro_torch.core.pipeline import fold_keyset
    from repro_torch.replication import ChangeLog

    step_dir = root / f"step_{step:08d}"
    if (step_dir / "manifest.npz").exists():
        m = np.load(step_dir / "manifest.npz")
        files = [str(x) for x in m["files"]]
        names = [str(x) for x in m["names"]]
        keys = m["keys"].astype(np.uint32)
        return keys, np.arange(len(files), dtype=np.uint32), files, names
    with np.load(step_dir / "delta_log.npz") as z:
        d = dict(z)
    base_step = int(d["base_step"])
    bkeys, brids, bfiles, bnames = _manifest_view(root, base_step)
    log = ChangeLog.from_npz_dict(d)
    keep, ins_words, ins_lengths, ins_rids = log.fold(brids)
    # fold through the pipeline's shared keyset fold — the same vectorized
    # mask+append every incremental call site uses
    base_ks = KeySet(
        words=bkeys,
        lengths=np.full(bkeys.shape[0], bkeys.shape[1] * 4, np.int32),
        rids=brids,
    )
    delta_ks = (
        KeySet(
            words=np.asarray(ins_words, np.uint32),
            lengths=np.asarray(ins_lengths, np.int32),
            rids=np.asarray(ins_rids, np.uint32),
        )
        if len(ins_rids)
        else None
    )
    folded = fold_keyset(base_ks, keep_rows=keep, delta=delta_ks)
    keys = np.asarray(folded.words, np.uint32)
    rids = np.asarray(folded.rids, np.uint32)
    rel = f"../step_{base_step:08d}/"
    files = [rel + f for f in bfiles] + [str(x) for x in d["files"]]
    names = list(bnames) + [str(x) for x in d["names"]]
    return keys, rids, files, names


def save_checkpoint_delta(ckpt_dir: str | os.PathLike, step: int, tree,
                          base_step: int, extra_meta: dict | None = None) -> Path:
    """Delta checkpoint: the change log vs ``base_step`` plus changed leaves.

    Only leaves whose payload differs from the base are written; unchanged
    leaves stay referenced in the base step's directory.  Manifest changes
    are recorded as an LSN-stamped ``ChangeLog``: a changed leaf is a
    DELETE of its base manifest row + an INSERT of the same key with a new
    slot; new/removed leaves are plain INSERTs/DELETEs.  The step's
    DS-metadata is the base metadata advanced by the §4.3 insert rule, so a
    restore that sees no new distinction bits replays the log through the
    *incremental* reconstruction path.  All of it is host-side work.
    """
    import bisect

    from repro_torch.core.metadata import meta_on_insert
    from repro_torch.replication import ChangeLog

    root = Path(ckpt_dir)
    base_dir = root / f"step_{base_step:08d}"
    if not (base_dir / "DONE").exists():
        raise FileNotFoundError(f"no committed base checkpoint at {base_dir}")
    # host-side manifest read — the save path never rebuilds the index
    base_keys, base_rids, base_files, base_names = _manifest_view(root, base_step)
    base_meta = DSMeta.from_npz_dict(dict(np.load(base_dir / "dsmeta.npz")))

    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    live = {base_names[int(r)]: int(r) for r in base_rids}
    n_slots = len(base_files)
    log = ChangeLog(n_words=3)
    delta_files: list[str] = []
    delta_names: list[str] = []
    inserted_keys: list[np.ndarray] = []
    seen: set[str] = set()
    for name, arr in _iter_flat(tree):
        seen.add(name)
        if name in live:
            old = np.load(base_dir / base_files[live[name]])
            if (old.shape == arr.shape and old.dtype == arr.dtype
                    and np.array_equal(old, arr)):
                continue  # unchanged: stays a base reference
            log.append_deletes([live[name]])
        fn = f"leaf_{len(delta_files):06d}.npy"
        np.save(tmp / fn, arr)
        key = _manifest_key(name)
        log.append_inserts(key[None, :], [n_slots + len(delta_files)])
        delta_files.append(fn)
        delta_names.append(name)
        inserted_keys.append(key)
    for name, rid in live.items():
        if name not in seen:
            log.append_deletes([rid])

    # DS-metadata: base + insert rule per inserted manifest key (host-side
    # scalar work, as everywhere in the metadata layer)
    skeys = sorted(tuple(int(x) for x in row) for row in base_keys)
    meta = base_meta
    for key in inserted_keys:
        kt = tuple(int(x) for x in key)
        i = bisect.bisect_left(skeys, kt)
        a = np.asarray(skeys[i - 1], np.uint32) if i > 0 else None
        b = np.asarray(skeys[i], np.uint32) if i < len(skeys) else None
        meta = meta_on_insert(meta, a, key, b)
        bisect.insort(skeys, kt)

    np.savez(
        tmp / "delta_log.npz",
        **log.to_npz_dict(),
        files=np.asarray(delta_files),
        names=np.asarray(delta_names),
        base_step=np.asarray(base_step, np.int64),
    )
    np.savez(tmp / "dsmeta.npz", **meta.to_npz_dict())
    (tmp / "meta.json").write_text(
        json.dumps({"step": step, "base_step": base_step, **(extra_meta or {})})
    )
    (tmp / "DONE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    if any(isinstance(leaf, DTensor) for _, leaf in _leaves(tree)):
        dist.barrier()  # the other ranks return once the step is committed
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """Newest *committed* step number in ``ckpt_dir`` (None when empty).

    Only steps whose DONE marker exists count — a crash mid-save leaves a
    ``.tmp_step_*`` directory that is never considered.
    """
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.name.startswith("step_") and (p / "DONE").exists()
    ]
    return max(steps) if steps else None


def step_manifest(ckpt_dir: str | os.PathLike, step: int) -> dict:
    """Describe a committed step for publication on a replication stream.

    Returns ``{"ckpt_dir", "step", "base_step", "delta", "meta"}`` — what a
    catch-up consumer needs to locate (and fold, if it is a delta chain)
    the checkpoint: the directory, the step number, the base step a delta
    step folds onto (``None`` for a full step), and the step's
    ``meta.json`` contents.  Raises ``FileNotFoundError`` for uncommitted
    steps, so a manifest can never point at a torn checkpoint.
    """
    root = Path(ckpt_dir)
    step_dir = root / f"step_{step:08d}"
    if not (step_dir / "DONE").exists():
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    meta = json.loads((step_dir / "meta.json").read_text())
    delta = (step_dir / "delta_log.npz").exists()
    base = None
    if delta:
        with np.load(step_dir / "delta_log.npz") as z:
            base = int(z["base_step"])
    return {
        "ckpt_dir": str(root),
        "step": int(step),
        "base_step": base,
        "delta": delta,
        "meta": meta,
    }


class CheckpointIndex:
    """The reconstructed manifest index: hashed-path point lookups.

    For a delta step the base manifest is folded through the persisted
    change log and the index is rebuilt *incrementally* (base run merged
    with the changed rows) whenever the persisted D-bitmap still matches
    the base extraction — ``result.stats["incremental"]`` records which
    path ran.  ``files``/``names`` are slot lists: record ids index into
    them, and entries of a delta step refer into the base step's directory
    by relative path.

    The reconstruction runs on ``backend`` on ``device`` (CUDA unless
    named) and is frozen into an epoch-stamped
    ``repro_torch.core.snapshot.IndexSnapshot`` (the epoch round-trips
    through the step's ``meta.json`` — a stream-checkpointing primary
    stores its cell's epoch there and a restore resumes it); lookups probe
    the snapshot with the backend's ``lookup`` op, on ``"cuda"`` the probe
    kernel's leaf stage.
    """

    def __init__(self, step_dir: Path, backend: str = "cuda", device=None):
        from repro_torch.core.snapshot import IndexSnapshot

        self.dir = Path(step_dir)
        self.backend = backend
        self._pipe = ReconstructionPipeline(backend=backend, device=device)
        self.device = self._pipe.device
        meta = DSMeta.from_npz_dict(dict(np.load(self.dir / "dsmeta.npz")))
        step_meta = json.loads((self.dir / "meta.json").read_text())
        self.snapshot_epoch = int(step_meta.get("snapshot_epoch", 0))
        if (self.dir / "delta_log.npz").exists():
            self._init_delta(meta)
        else:
            m = np.load(self.dir / "manifest.npz")
            self.keys = m["keys"].astype(np.uint32)
            self.files = [str(x) for x in m["files"]]
            self.names = [str(x) for x in m["names"]]
            ks = KeySet(
                words=self.keys,
                lengths=np.full(len(self.files), 12, np.int32),
                rids=np.arange(len(self.files), dtype=np.uint32),
            )
            # THE paper pipeline: extract by persisted D-bitmap -> sort -> build
            self.result: ReconstructionResult = self._pipe.run(ks, meta=meta)
            self._keyset = ks
        self.snapshot = IndexSnapshot.from_result(
            self.result, epoch=self.snapshot_epoch
        )

    def _init_delta(self, meta: DSMeta) -> None:
        """Replay-on-restore: fold the base manifest through the log and
        rebuild via the incremental pipeline path (full-path fallback when
        the persisted bitmap grew past the base extraction)."""
        from repro_torch.replication import ChangeLog

        with np.load(self.dir / "delta_log.npz") as z:
            d = dict(z)
        base_step = int(d["base_step"])
        base = CheckpointIndex(
            self.dir.parent / f"step_{base_step:08d}", backend=self.backend,
            device=self.device,
        )
        log = ChangeLog.from_npz_dict(d)
        keep_rows, delta = log.fold_keyset(base._keyset)
        self.result, self._keyset = self._pipe.run_incremental(
            base.result, base._keyset, delta, keep_rows=keep_rows, meta=meta
        )
        rel = f"../step_{base_step:08d}/"
        self.files = [rel + f for f in base.files] + [str(x) for x in d["files"]]
        self.names = list(base.names) + [str(x) for x in d["names"]]
        self.keys = np.asarray(self._keyset.words, np.uint32)

    def lookup(self, name: str) -> str:
        """Point lookup: leaf path → leaf file (tree search, not a scan).

        Probes the frozen snapshot through the backend's ``lookup`` op.
        Raises ``KeyError`` when the path is not in the manifest.
        """
        q = to_carrier(_manifest_key(name)[None, :], self.device)
        found, rid = self.snapshot.lookup(self._pipe.backend, q)
        if not bool(found[0]):
            raise KeyError(name)
        return self.files[int(rid[0])]


def _place(arr: np.ndarray, device) -> torch.Tensor:
    """A restored leaf as a tensor on ``device``; ``uint32`` leaves become
    the port's int64 carriers (``repro_torch.core.u32``), ``V2`` leaves
    (bfloat16 words) bfloat16 tensors."""
    if arr.dtype == np.uint32:
        return to_carrier(arr, device)
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(arr).to(device)


def restore_checkpoint(ckpt_dir: str | os.PathLike, step: int, like_tree,
                       device=None, backend: str = "cuda",
                       index_device=None, shardings=None) -> tuple[dict, dict]:
    """Restore a tree shaped like ``like_tree``; elastic re-placement under
    ``shardings`` if given.

    Every leaf is fetched through the reconstructed manifest index (point
    lookup by hashed path) — the restore path exercises the paper's index,
    not a linear scan.  ``backend`` and ``index_device`` (CUDA unless
    named) select where the manifest index is reconstructed.  Leaves come
    back as numpy arrays, or as tensors on ``device`` when one is named.
    ``shardings`` (a tree of ``distributed.sharding.NamedSharding`` like
    ``like_tree``, e.g. ``launch.shardings.params_shardings``) makes each
    leaf a DTensor on its mesh (on the mesh's device type unless
    ``device`` names one): every rank rebuilds the index and reads the
    leaf, and keeps its own block, with no communication.
    Delta steps replay their change log onto the base step transparently.
    Returns ``(tree, stats)``.
    """
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    if not (step_dir / "DONE").exists():
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    idx = CheckpointIndex(step_dir, backend=backend, device=index_device)

    sh = None if shardings is None else [s for _, s in _leaves(shardings)]
    if sh is not None and device is None:
        device = resolve_device(sh[0].mesh.device_type)
    out = []
    for i, name in enumerate(_names(like_tree)):
        arr = np.load(step_dir / idx.lookup(name))
        leaf = arr if device is None else _place(arr, device)
        if sh is not None:
            leaf = distribute_tensor(leaf, sh[i].mesh, sh[i].placements(leaf.dim()),
                                     src_data_rank=None)
        out.append(leaf)
    tree = _unflatten(like_tree, iter(out))
    stats = {
        "n_leaves": len(out),
        "index_height": idx.result.tree.height,
        "compression_ratio": idx.result.stats["compression_ratio"],
        "index_rebuild_s": idx.result.timings["total"],
        "index_backend": idx.result.stats["backend"],
        "incremental": bool(idx.result.stats.get("incremental", False)),
        "snapshot_epoch": idx.snapshot.epoch,
        "meta": json.loads((step_dir / "meta.json").read_text()),
    }
    return tree, stats
