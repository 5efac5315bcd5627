"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d4096 32H GQA(kv=2) head_dim 128
d_ff 13696 vocab 151552; SwiGLU, RoPE."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=151_552,
    pattern=("dense",),
    mlp_type="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
)
