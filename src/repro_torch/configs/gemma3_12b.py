"""gemma3-12b [hf:google/gemma-3 family; unverified tier]: 48L d3840 16H
GQA(kv=8) head_dim 256 d_ff 15360 vocab 262144; 5:1 local:global
attention pattern (window 1024), 128k context.

Eligible for long_500k: only 1/6 of layers see the full context; local
layers keep an O(window) ring cache (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    mlp_type="geglu",
    scale_embed=True,
    tie_embeddings=True,
    sub_quadratic=True,
    notes="5:1 local:global; long_500k runs (mostly-local attention)",
)
