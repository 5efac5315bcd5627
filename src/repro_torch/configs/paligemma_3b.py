"""paligemma-3b [arXiv:2407.07726]: SigLIP vision frontend (STUB — the
dry-run feeds precomputed patch embeddings per the brief) + gemma-2b
text backbone: 18L d2048 8H MQA(kv=1) head_dim 256 d_ff 16384 GeGLU
vocab 257216.  Prefix-LM masking: image patches attend bidirectionally.
"""

from repro_torch.configs.base import ArchConfig

NUM_PATCHES = 256  # 224x224 / 14px SigLIP stub

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    pattern=("dense",),
    mlp_type="geglu",
    scale_embed=True,
    tie_embeddings=True,
    modality="vision_stub",
    prefix_tokens=NUM_PATCHES,
    sub_quadratic=False,
    notes="SigLIP frontend stubbed: input_specs provides patch embeddings",
)
