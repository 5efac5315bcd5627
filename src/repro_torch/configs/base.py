"""Architecture and shape configuration for the assigned workload matrix.

A copy of the reference package's ``configs/base.py`` (pure data; the port
imports nothing of the reference).  Every architecture is expressed as a
*layer pattern*: an optional unrolled prefix (e.g. DeepSeek's first dense
layer) followed by ``n_superblocks`` repetitions of a per-superblock kind
tuple.  The reference scans the superblocks; the port's ``models/lm.py``
loops over them and keeps the same stacked ``[n_superblocks, ...]``
parameter and cache leaves.

Layer kinds of ``models/blocks.py`` (the reference's and the port's):
  dense    GQA attention + (Ge/Swi)GLU MLP
  local    like dense but sliding-window attention (cfg.window)
  global   explicit full attention (used inside mixed patterns)
  moe      GQA attention + (shared + routed top-k) MoE FFN
  mlstm    xLSTM matrix-LSTM block (chunked gated linear attention)
  slstm    xLSTM scalar-LSTM block (sequential recurrence)
  hymba    parallel attention + SSM heads in one layer (hybrid)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    num_heads: int = 8
    head_dim: int = 64        # SSM channel dim per head
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer stacking
    prefix_pattern: Tuple[str, ...] = ()
    pattern: Tuple[str, ...] = ("dense",)
    # derived: n_superblocks = (num_layers - len(prefix)) // len(pattern)

    # attention
    rope_theta: float = 10_000.0
    window: int = 0                   # sliding-window size for 'local' kind
    mlp_type: str = "swiglu"          # swiglu | geglu
    scale_embed: bool = False         # gemma-style sqrt(d_model) embed scale
    tie_embeddings: bool = True

    # mixtures / ssm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality stubs
    modality: str = "text"            # text | vision_stub | audio_stub
    prefix_tokens: int = 0            # precomputed patch/frame/meta embeddings
    meta_tokens: int = 0              # hymba-style learned meta tokens

    # capability flags for the shape matrix
    sub_quadratic: bool = False       # eligible for long_500k
    notes: str = ""

    @property
    def n_superblocks(self) -> int:
        rem = self.num_layers - len(self.prefix_pattern)
        assert rem % len(self.pattern) == 0, (
            f"{self.name}: {rem} layers not divisible by pattern "
            f"{self.pattern}"
        )
        return rem // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The brief's applicability rule: long_500k only for sub-quadratic
    archs (SSM / hybrid / mostly-local attention); decoders run all else."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full-attention; long_500k requires "
            "sub-quadratic attention (see DESIGN.md)"
        )
    return True, ""


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests: same layer pattern
    and code paths, small dims."""
    pat_len = len(cfg.pattern)
    n_sb_red = 2 if pat_len <= 4 else 1
    small = dict(
        num_layers=len(cfg.prefix_pattern) + n_sb_red * pat_len,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        prefix_tokens=min(cfg.prefix_tokens, 4),
        meta_tokens=min(cfg.meta_tokens, 4),
        window=min(cfg.window, 16) if cfg.window else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            capacity_factor=4.0,  # ~dropless: keeps smoke tests deterministic
        )
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(state_dim=8, num_heads=2, head_dim=16, chunk=16)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


def param_count(cfg: ArchConfig) -> Dict[str, float]:
    """Closed-form parameter estimate (used by roofline MODEL_FLOPS and
    checked against the real init in tests)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    per_layer: Dict[str, float] = {}

    def attn_params() -> float:
        return D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D

    def mlp_params(width=None) -> float:
        f = width or F
        mats = 2 if cfg.mlp_type == "gelu" else 3  # gated: gate+up+down
        return mats * D * f

    kinds = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    total = float(emb)
    for kind in kinds:
        if kind in ("dense", "local", "global"):
            p = attn_params() + mlp_params() + 2 * D
        elif kind == "moe":
            m = cfg.moe
            p = attn_params() + 2 * D
            p += m.num_experts * mlp_params() + D * m.num_experts  # routed + router
            p += mlp_params(F * max(m.num_shared, 0)) if m.num_shared else 0
        elif kind == "mlstm":
            dh = 2 * D  # proj factor 2
            p = 2 * D * dh + dh * D + 3 * dh * dh // 4 + 4 * dh + 2 * D
        elif kind == "slstm":
            p = 4 * D * D + 4 * D + (D * int(4 * D / 3) * 2) + 2 * D
        elif kind in ("hymba", "hymba_g"):
            s = cfg.ssm
            ssm_inner = s.num_heads * s.head_dim
            p = attn_params() + 2 * D
            p += D * ssm_inner * 2 + ssm_inner * D          # in/out proj
            p += ssm_inner * (2 * s.state_dim + 2)          # B,C,dt,A
            p += mlp_params()
        else:
            raise ValueError(kind)
        per_layer[kind] = per_layer.get(kind, 0.0) + p
        total += p
    # active params (MoE: only top_k + shared experts count)
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(1 for k in kinds if k == "moe")
        inactive = n_moe * (m.num_experts - m.top_k) * 3 * D * F
        active = total - inactive
    return {"total": total, "active": active, "embedding": float(emb)}
