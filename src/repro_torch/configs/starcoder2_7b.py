"""starcoder2-7b [arXiv:2402.19173]: 32L d4608 36H GQA(kv=4) head_dim 128
d_ff 18432 vocab 49152; non-gated GELU FFN, RoPE."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    pattern=("dense",),
    mlp_type="gelu",
    tie_embeddings=False,
    sub_quadratic=False,
)
