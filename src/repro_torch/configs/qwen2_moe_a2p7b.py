"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H(MHA)
d_ff 1408 vocab 151936; 4 shared + 60 routed experts, top-4."""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    pattern=("moe",),
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4),
    mlp_type="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
)
