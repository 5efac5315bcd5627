"""gemma-2b [arXiv:2403.08295]: 18L d2048 8H MQA(kv=1) head_dim 256
d_ff 16384 GeGLU vocab 256000; sqrt(d)-scaled tied embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    pattern=("dense",),
    mlp_type="geglu",
    scale_embed=True,
    tie_embeddings=True,
    sub_quadratic=False,
)
