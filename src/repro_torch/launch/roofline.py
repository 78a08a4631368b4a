"""Roofline analysis over the dry-run records, at H100 peaks.

Per (arch x shape x mesh) cell, three terms in *seconds per step*:

  compute    = dot_FLOPs_per_device / 989e12   (dense bf16 peak, H100 SXM)
  memory     = analytic HBM bytes per device / 3.35e12  (model below)
  collective = collective bytes per device / 450e9  (NVLink, one direction)

``dot_flops`` and ``collective_bytes`` come from the record's
``op_summary`` (``launch/opcount.py``: one rank's local matmuls and
DTensor's collectives, the microbatch multiplied by ``accum``); a record
of the JAX package's dry run, which holds the same two fields under
``hlo_summary``, is read the same way.  So the compute term reflects the
FLOPs *actually executed* per device — replicated attention math shows
up here, which is the point.

The peaks are the H100 SXM data sheet's at 700 W: 989 TFLOP/s of dense
bf16 tensor-core math, 3.35 TB/s of HBM3, and 450 GB/s each way over
NVLink 4 (900 GB/s both ways).  The collective term assumes every rank
talks over NVLink inside one host: across hosts the network is slower,
so a 256- or 512-rank cell's collective term is a floor.

Memory term model (the JAX package's, term for term):
  train:   accum * (3*Wb + act) + 20*N/chips
           Wb  = 2*N_total/chips      (bf16 weights read fwd+bwd+grad write)
           act = tokens_mb/chips * L * d * 18B   (fwd write, bwd read, remat)
  prefill: 2*Wb + act + kv_write
  decode:  Wb (all weights stream per token — the MoE decode wall)
           + kv_read (+state for SSM archs)

MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference); the ratio
MODEL_FLOPS / (dot_FLOPs * chips) is the "useful fraction" — remat,
sharding replication and dispatch overheads push it below 1.

Roofline fraction =
  [MODEL_FLOPS / (chips*989e12)] / max(compute, memory, collective)
i.e. the MFU bound this program shape admits on the target fabric.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --mesh both [--json-out F]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import get_arch, get_shape

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per H100 SXM
HBM_BW = 3.35e12  # B/s per H100 SXM (HBM3)
LINK_BW = 450e9  # B/s NVLink 4, one direction, per GPU

OUT_ROOT = Path(__file__).resolve().parents[3] / "experiments"
DRYRUN = OUT_ROOT / "dryrun_torch"


def _attn_layers(cfg) -> int:
    per = sum(1 for m, _ in cfg.pattern if m in ("attn", "xattn"))
    return per * cfg.n_superblocks


def workload_model(cfg, shape, chips: int) -> dict:
    """Analytic per-device HBM bytes + useful FLOPs."""
    N_tot, N_act = cfg.total_params(), cfg.active_params()
    B, S = shape.global_batch, shape.seq_len
    L, d = cfg.n_layers, cfg.d_model
    La = _attn_layers(cfg)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * 2  # K+V bytes per token per layer

    if shape.kind == "train":
        D = B * S
        model_flops = 6.0 * N_act * D
        tokens_mb = D // shape.accum
        Wb = 2.0 * N_tot / chips
        act = tokens_mb / chips * L * d * 18.0
        hbm = shape.accum * (3 * Wb + act) + 20.0 * N_tot / chips
    elif shape.kind == "prefill":
        D = B * S
        model_flops = 2.0 * N_act * D
        Wb = 2.0 * N_tot / chips
        act = D / chips * L * d * 6.0
        kv_write = D / chips * La * kv_row
        hbm = 2 * Wb + act + kv_write
    else:  # decode
        D = B
        model_flops = 2.0 * N_act * D
        Wb = 2.0 * N_tot / chips
        kv_read = B * S * La * kv_row / chips
        state = 0.0
        for m, _ in cfg.pattern:
            if m == "mamba":
                state += cfg.ssm_expand * d * cfg.ssm_state * 4 * 2
            elif m == "mlstm":
                di = cfg.xlstm_expand * d
                state += (di // cfg.xlstm_heads) * di * 4 * 2
            elif m == "slstm":
                state += 4 * d * 4 * 2
        state *= cfg.n_superblocks * B / chips
        hbm = Wb + kv_read + state
    return {"model_flops": model_flops, "hbm_bytes_dev": hbm, "tokens": D}


def _summary(rec: dict) -> dict:
    return rec.get("op_summary") or rec.get("hlo_summary") or {}


def analyze_cell(rec: dict, cfg=None, shape=None) -> dict | None:
    """The roofline row of one ``ok`` record; ``cfg`` and ``shape`` stand
    for the named ones where the record's cell was resized."""
    if rec.get("status") != "ok":
        return None
    cfg = cfg or get_arch(rec["arch"])
    shape = shape or get_shape(rec["shape"])
    chips = rec["n_devices"]
    wm = workload_model(cfg, shape, chips)
    hs = _summary(rec)
    dot_flops_dev = hs.get("dot_flops", 0.0)
    coll_dev = sum(hs.get("collective_bytes", {}).values())

    t_compute = dot_flops_dev / PEAK_FLOPS
    t_memory = wm["hbm_bytes_dev"] / HBM_BW
    t_coll = coll_dev / LINK_BW
    bound = max(t_compute, t_memory, t_coll, 1e-12)
    dom = {t_compute: "compute", t_memory: "memory", t_coll: "collective"}[bound]
    t_useful = wm["model_flops"] / (chips * PEAK_FLOPS)
    useful_frac = (
        wm["model_flops"] / (dot_flops_dev * chips) if dot_flops_dev else 0.0
    )
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dom,
        "model_flops": wm["model_flops"],
        "hlo_flops_x_chips": dot_flops_dev * chips,
        "useful_flop_frac": useful_frac,
        "roofline_frac": t_useful / bound,
        "collective_bytes_dev": coll_dev,
        "hbm_bytes_dev": wm["hbm_bytes_dev"],
    }


_FIX_HINTS = {
    ("compute", True): "shard the attention blocks over the model axis "
    "(replicated head math inflates executed FLOPs)",
    ("compute", False): "already matmul-bound; raise arithmetic intensity "
    "(larger microbatch) or accept — near roofline",
    ("memory", True): "decode streams all weights per token: quantize "
    "weights (int8) or batch wider to amortize",
    ("memory", False): "cut activation traffic: fewer remat rewrites, fuse "
    "norms, bf16 master-weight reads",
    ("collective", True): "overlap EP all-to-all with expert GEMMs; "
    "compress dispatch payloads",
    ("collective", False): "overlap FSDP all-gathers with layer compute; "
    "reduce-scatter gradients",
}


def hint(row: dict, cfg) -> str:
    if row["dominant"] == "compute":
        return _FIX_HINTS[("compute", row["useful_flop_frac"] < 0.5)]
    if row["dominant"] == "memory":
        return _FIX_HINTS[("memory", row["shape"].startswith(("decode", "long")))]
    return _FIX_HINTS[("collective", bool(cfg.n_experts))]


def render_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | dom | compute s | memory s | collective s | "
           "MODEL_FLOPS | useful frac | roofline frac | next move |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in sorted(rows, key=lambda x: (x["shape"], x["arch"])):
        cfg = get_arch(r["arch"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['dominant'][:4]} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['model_flops']:.2e} "
            f"| {r['useful_flop_frac']:.2f} | {r['roofline_frac']:.3f} "
            f"| {hint(r, cfg)} |"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--root", default=str(DRYRUN),
                    help="the dry run's records (its --out-root)")
    args = ap.parse_args(argv)
    root = Path(args.root)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    all_rows = []
    for mesh in meshes:
        rows, opt_rows = [], []
        for f in sorted((root / mesh).glob("*.json")):
            rec = json.loads(f.read_text())
            row = analyze_cell(rec)
            if not row:
                continue
            # arch__shape.json = baseline; arch__shape__<tag>.json = variant
            if f.stem.count("__") > 1:
                row["variant"] = f.stem.split("__", 2)[2]
                opt_rows.append(row)
            else:
                rows.append(row)
        print(f"\n## Roofline at H100 peaks — {mesh} "
              f"({rows[0]['chips'] if rows else '?'} ranks)\n")
        print(render_table(rows))
        (root / f"roofline_{mesh}.md").write_text(render_table(rows) + "\n")
        if opt_rows:
            print(f"\n## Variants — {mesh}\n")
            print(render_table(opt_rows))
        all_rows += rows
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(all_rows, indent=1))
    pod1 = [r for r in all_rows if r["mesh"] == "pod1"]
    if pod1:
        worst = min(pod1, key=lambda r: r["roofline_frac"])
        coll = max(pod1, key=lambda r: r["t_collective_s"] / max(r["t_compute_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline_frac']:.3f})")
        print(f"most collective-bound:   {coll['arch']}/{coll['shape']} "
              f"(coll/compute = {coll['t_collective_s']/max(coll['t_compute_s'],1e-12):.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
