"""Dry run: trace every (arch x shape x mesh) cell on a fake mesh.

For each cell this driver builds the real step (the train step's
microbatch and update, ``LM.prefill`` or ``LM.decode_step``) on DTensors
placed by ``launch/shardings.py``, and runs it from rank 0's view of a
256-rank (``pod1``: (16, 16) ("data", "model")) or 512-rank (``pod2``:
(2, 16, 16) ("pod", "data", "model")) mesh, in ONE process:

  * ``torch.distributed``'s fake process group stands for the other
    ranks: every collective returns at once, with its result's shape;
  * ``FakeTensorMode`` gives every tensor its shape, dtype and device and
    no storage, so nothing is allocated and nothing is computed;
  * ``MemTracker`` records rank 0's peak (split into parameters,
    optimizer state and the rest) — the proof that the cell fits a
    device;
  * ``launch/opcount.py`` counts rank 0's matmul FLOPs and each kind of
    collective's bytes, for ``launch/roofline.py``.

A train cell traces ONE microbatch's forward and backward (with the f32
gradient accumulator held, as the step holds it) and the AdamW update
once; the record's ``op_summary`` multiplies the microbatch by
``accum``.  Prefill and decode cells run under ``torch.no_grad`` on
serving parameters (compute-dtype matrices) and the caches placed by
``cache_shardings``; a decode cell attends over the whole cache.  Every
cell runs under ``distributed.ctx.use_mesh``, so the attention's
sharding constraints apply.  A cell that raises is recorded with status
``"error"`` and its traceback: each is a gap to close.

Records go to ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``
(cells already on disk are skipped unless ``--force``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both] \
      [--jobs 8 --cell-timeout 600]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      --mesh 2x2 --override n_layers=4 --batch 4 --seq 512 --accum 2 --out-suffix __small
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, shape_applies
from repro_torch.distributed.ctx import use_mesh
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models.lm import LM, input_specs
from repro_torch.train.optim import OptConfig, adamw_init, adamw_update, tree_leaves, tree_map
from repro_torch.train.trainstep import make_train_step

from .mesh import PRODUCTION, data_axes, make_production_mesh
from .opcount import OpCounter, scale_step, unobserved_meta_propagation
from .shardings import batch_shardings, cache_shardings, params_shardings

__all__ = ["trace_cell", "run_cell", "fake_mesh", "main"]

OUT_ROOT = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

def mesh_layout(name: str) -> tuple[tuple, tuple]:
    """``pod1``, ``pod2`` (``launch/mesh.py``'s production meshes), or
    ``DxM`` (a small ("data", "model") mesh)."""
    if name in ("pod1", "pod2"):
        return PRODUCTION[name == "pod2"]
    d, m = (int(x) for x in name.split("x"))
    return (d, m), ("data", "model")


@contextlib.contextmanager
def fake_mesh(name: str):
    """The mesh :func:`mesh_layout` names, on the fake process group of its
    size, seen from rank 0; the group is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process without a process group")
    shape, axes = mesh_layout(name)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        if name in ("pod1", "pod2"):
            yield make_production_mesh(multi_pod=name == "pod2", device_type="cpu")
        else:
            yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_offsets_outside_fake():
    """DTensor works out a strided shard's offsets (a head dim split over
    two mesh axes, after attention's batch dims are flattened) by building
    an index tensor and reading it with ``tolist()``, which a fake tensor
    refuses; the offsets depend on shapes alone, so they are computed
    with real tensors while the trace runs."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.local_shard_size_and_offset

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _apply_overrides(cfg, overrides: dict | None):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True", True)
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _empty_placed(struct: dict, shardings):
    """DTensors of ``struct``'s shapes and dtypes under ``shardings``, each
    rank making only its own block (uninitialised; fake in a dry run)."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, s: NamedSharding):
        placements = s.placements(t.dim())
        local = list(t.shape)
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard):
                local[pl.dim] //= s.mesh.size(i)
        x = torch.empty(local, dtype=t.dtype, device=s.mesh.device_type)
        return DTensor.from_local(x, s.mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    if isinstance(struct, dict):
        return {k: _empty_placed(v, shardings[k]) for k, v in struct.items()}
    return one(struct, shardings)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tree_leaves(tree))


def trace_cell(cfg, shape, mesh, *, serve_tp_only: bool = False) -> dict:
    """Trace one cell on ``mesh`` (a fake mesh: :func:`fake_mesh`): rank
    0's memory and op counts, as the record's fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    model = LM(cfg, device=mesh.device_type)
    out: dict = {}
    # the shapes, as meta tensors, before the tracker starts: they hold
    # no memory on the mesh's device
    if shape.kind == "train":
        struct = model.param_struct()
        mb_struct = input_specs(cfg, dataclasses.replace(
            shape, global_batch=shape.global_batch // shape.accum))
    else:
        struct = model.param_struct(model.compute_dtype)
        cache_struct = model.cache_struct(shape.global_batch, shape.seq_len)
        b_struct = input_specs(cfg, shape)
    with _strided_offsets_outside_fake(), unobserved_meta_propagation(), FakeTensorMode(), \
            use_mesh(mesh, data_axes=data_axes(mesh)):
        mt = MemTracker()
        with mt:
            if shape.kind == "train":
                p_sh = params_shardings(mesh, struct)
                params = _empty_placed(struct, p_sh)
                opt = adamw_init(params)
                mb = _empty_placed(mb_struct, batch_shardings(mesh, mb_struct))
                step = make_train_step(model, OptConfig(), accum=shape.accum, param_shardings=p_sh)
                # the step's f32 accumulator, held through the microbatch
                acc = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
                       if shape.accum > 1 else None)
                with OpCounter() as micro:
                    _, _, grads = step.grad_fn(params, mb)
                    if acc is not None:
                        for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                            a.add_(g.to(torch.float32))
                        grads = acc
                with OpCounter() as update:
                    if shape.accum > 1:
                        for g in tree_leaves(grads):
                            g.div_(shape.accum)
                    adamw_update(OptConfig(), params, grads, opt)
                out["op_summary"] = scale_step(micro.summary(), update.summary(), shape.accum)
                out["op_micro"] = micro.summary()
                out["op_update"] = update.summary()
                param_bytes = _local_bytes(params)
                opt_bytes = _local_bytes({"m": opt["m"], "v": opt["v"]})
            else:
                params = _empty_placed(struct, params_shardings(mesh, struct,
                                                                serve_tp_only=serve_tp_only))
                cache = _empty_placed(cache_struct, cache_shardings(mesh, cfg, cache_struct))
                batch = _empty_placed(b_struct, batch_shardings(mesh, b_struct))
                with torch.no_grad(), OpCounter() as run:
                    if shape.kind == "prefill":
                        model.prefill(params, batch, cache)
                    else:  # attend over the whole cache
                        batch["pos"] = shape.seq_len - 1
                        model.decode_step(params, cache, batch)
                out["op_summary"] = run.summary()
                param_bytes = _local_bytes(params)
                opt_bytes = 0
                out["cache_bytes"] = _local_bytes(cache)
        peak = mt.get_tracker_snapshot("peak").get(torch.device(mesh.device_type), {}).get("Total", 0)
    out["memory"] = {"peak_bytes": int(peak), "param_bytes": int(param_bytes),
                     "opt_bytes": int(opt_bytes),
                     "other_bytes": int(peak - param_bytes - opt_bytes)}
    return out


def run_cell(arch_name: str, shape_name: str, mesh_name: str, force: bool = False,
             overrides: dict | None = None, suffix: str = "", serve_tp_only: bool = False,
             shape_overrides: dict | None = None, out_root: Path | None = None,
             reduced: bool = False) -> dict:
    out_dir = Path(out_root or OUT_ROOT) / mesh_name
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{arch_name}__{shape_name}{suffix}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())

    cfg = get_arch(arch_name)
    cfg = _apply_overrides(cfg.reduced() if reduced else cfg, overrides)
    shape = dataclasses.replace(get_shape(shape_name), **(shape_overrides or {}))
    ok, why = shape_applies(cfg, shape)
    if not ok:
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": why}
        out_file.write_text(json.dumps(rec, indent=1))
        return rec

    mesh_shape, axes = mesh_layout(mesh_name)
    t0 = time.time()
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "n_devices": math.prod(mesh_shape), "mesh_shape": list(mesh_shape),
           "mesh_axes": list(axes), "reduced": reduced, "overrides": overrides or {},
           "shape_overrides": shape_overrides or {}}
    try:
        with fake_mesh(mesh_name) as mesh:
            traced = trace_cell(cfg, shape, mesh,
                                serve_tp_only=serve_tp_only and shape.kind != "train")
        rec.update(
            status="ok",
            t_trace_s=round(time.time() - t0, 2),
            **traced,
            params_total=cfg.total_params(),
            params_active=cfg.active_params(),
            tokens_per_step=shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1),
            kind=shape.kind,
            # the step's loop structure: the op counts above already
            # multiply the microbatch by accum; the superblock loop runs
            # eagerly, so it is counted whole
            scan_trips={
                "accum": shape.accum if shape.kind == "train" else 1,
                "n_superblocks": cfg.n_superblocks,
                "pattern": list(map(list, cfg.pattern)),
            },
        )
    except Exception as e:  # record failures — they are gaps to close
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-4000:])
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def _cell_process(cell: tuple, flags: list, timeout: float | None, kw: dict) -> dict:
    """Trace one cell in a child process running this module with the
    parent's flags narrowed to the cell; a child stopped at ``timeout``
    leaves an error record."""
    a, s, m = cell
    keep, skip = [], {"--arch", "--shape", "--mesh", "--jobs", "--cell-timeout"}
    it = iter(flags)
    for f in it:
        if f in skip:
            next(it, None)
        elif f != "--all":
            keep.append(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
           "--mesh", m] + keep
    out_file = Path(kw["out_root"] or OUT_ROOT) / m / f"{a}__{s}{kw['suffix']}.json"
    try:
        subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
               "error": f"TimeoutError: the trace passed its {timeout:.0f} s (--cell-timeout)"}
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(rec, indent=1))
        return rec
    if not out_file.exists():
        return {"arch": a, "shape": s, "mesh": m, "status": "error",
                "error": "the cell's process wrote no record"}
    return json.loads(out_file.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1",
                    help="pod1, pod2, both, or DxM for a small (data, model) mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced (test-size) config")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig override key=value (repeatable)")
    ap.add_argument("--batch", type=int, default=None, help="the shape's global batch")
    ap.add_argument("--seq", type=int, default=None, help="the shape's sequence length")
    ap.add_argument("--accum", type=int, default=None, help="the shape's microbatches")
    ap.add_argument("--out-suffix", default="",
                    help="record filename suffix (keeps baselines intact)")
    ap.add_argument("--serve-tp-only", action="store_true",
                    help="serving cells: params TP-sharded only (no FSDP dim)")
    ap.add_argument("--out-root", default=None,
                    help=f"where the records go (default {OUT_ROOT})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="with --jobs: seconds a cell's process may run before it is "
                    "stopped and the cell recorded as an error")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)
    shape_overrides = {k: v for k, v in (("global_batch", args.batch), ("seq_len", args.seq),
                                         ("accum", args.accum)) if v is not None}

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    kw = dict(force=args.force, overrides=overrides, suffix=args.out_suffix,
              serve_tp_only=args.serve_tp_only, shape_overrides=shape_overrides,
              out_root=args.out_root, reduced=args.reduced)
    n_ok = n_skip = n_err = 0
    if args.jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        # each cell in a process of its own (one fake group a process),
        # these flags passed on; the deepest models first, so that the
        # slowest cells start early
        flags = list(argv if argv is not None else sys.argv[1:])
        pool = ThreadPoolExecutor(args.jobs)
        order = sorted(cells, key=lambda c: -get_arch(c[0]).n_layers)
        futures = [(c, time.time(), pool.submit(_cell_process, c, flags, args.cell_timeout, kw))
                   for c in order]
        results = ((c, t0, f.result()) for c, t0, f in futures)
    else:
        pool = None
        results = ((c, time.time(), run_cell(*c, **kw)) for c in cells)
    for (a, s, mesh_name), t0, rec in results:
        dt = rec.get("t_trace_s", time.time() - t0)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
        extra = ""
        if st == "ok":
            mem, ops = rec["memory"], rec["op_summary"]
            extra = (f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                     f"params={mem['param_bytes'] / 2**30:.2f}GiB "
                     f"opt={mem['opt_bytes'] / 2**30:.2f}GiB "
                     f"dot_flops={ops['dot_flops']:.3e} "
                     f"coll={sum(ops['collective_bytes'].values()):.3e}B")
        elif st == "error":
            extra = rec.get("error", "")[:200]
        print(f"[{mesh_name}] {a:28s} {s:12s} {st:8s} {dt:7.1f}s {extra}", flush=True)
    if pool is not None:
        pool.shutdown()
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
