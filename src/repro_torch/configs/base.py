"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig`` whose ``pattern`` is the
per-superblock sublayer cycle: a tuple of (mixer, ffn) kind pairs, cycled
``n_layers / len(pattern)`` times.  The port's model keeps each
parameter stacked over superblocks and loops over the superblock index.

mixer kinds: attn | mamba | mlstm | slstm | xattn
ffn kinds:   dense | moe | none
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applies"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    pattern: tuple = ((("attn", "dense")),)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    dispatch_mode: str = "einsum"  # or "sort" (compressed-key-sort dispatch)
    # --- SSM (Mamba) ---
    ssm_expand: int = 2
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_dt_rank: int = 0  # 0 -> d_model // 16
    # --- xLSTM ---
    xlstm_heads: int = 4
    xlstm_expand: int = 2
    # --- VLM ---
    n_img_tokens: int = 0
    # --- frontend stub ---
    embed_input: bool = True  # False: input_specs provides frame embeddings
    # --- misc ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    qk_norm: bool = False
    tie_embeddings: bool = False
    # attention chunking (activation-memory control)
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    ssm_chunk: int = 256
    # §Perf knob: repeat KV to the full head count before attention so the
    # head dim shards cleanly over "model" (GQA group dim G < mesh axis
    # otherwise replicates the pair-scan math; see EXPERIMENTS.md §Perf)
    attn_repeat_kv: bool = False
    source: str = ""  # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            self.name, self.n_layers, len(self.pattern))
        return self.n_layers // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    def active_params(self) -> int:
        """Approximate active parameter count (MoE: routed top_k only)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=len(self.pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_d_ff=64 if self.n_experts else 0,
            n_img_tokens=16 if self.n_img_tokens else 0,
            ssm_dt_rank=8,
            q_chunk=16,
            kv_chunk=16,
            loss_chunk=16,
            ssm_chunk=8,
            xlstm_heads=min(self.xlstm_heads, 4),
        )


def _param_count(c: ArchConfig, active_only: bool) -> int:
    d, hd = c.d_model, c.hd
    total = c.vocab_size * d * (1 if c.tie_embeddings else 2) if c.embed_input else c.vocab_size * d
    per_pattern = 0
    for mixer, ffn in c.pattern:
        if mixer in ("attn", "xattn"):
            per_pattern += d * hd * (c.n_heads + 2 * c.n_kv_heads) + c.n_heads * hd * d
        elif mixer == "mamba":
            di = c.ssm_expand * d
            per_pattern += d * 2 * di + di * (c.dt_rank + 2 * c.ssm_state)
            per_pattern += c.dt_rank * di + di * c.ssm_conv + di * d + 2 * di
        elif mixer == "mlstm":
            di = c.xlstm_expand * d
            per_pattern += d * 2 * di + 3 * di * di + 2 * di * c.xlstm_heads + di * d
        elif mixer == "slstm":
            dh = d // c.xlstm_heads
            per_pattern += 4 * d * d + 4 * c.xlstm_heads * dh * dh
        if ffn == "dense":
            per_pattern += 3 * d * c.d_ff
        elif ffn == "moe":
            e = c.top_k if active_only else c.n_experts
            per_pattern += 3 * d * c.moe_d_ff * e + d * c.n_experts
            if c.shared_expert:
                per_pattern += 3 * d * c.d_ff
    return total + per_pattern * c.n_superblocks


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    accum: int = 1  # gradient-accumulation microbatches (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256, accum=8),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applies(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rule: long_500k needs sub-quadratic sequence mixing —
    runs for SSM/hybrid, skipped (with note) for pure full-attention archs."""
    if shape.name == "long_500k" and arch.family not in ("ssm", "hybrid"):
        return False, (
            "skipped: pure full-attention arch; 500k decode requires "
            "sub-quadratic mixing (DESIGN.md §Arch-applicability)"
        )
    return True, ""
