"""deepseek-moe-16b [arXiv:2401.06066]: 28L d2048 16H(MHA) d_ff 1408
vocab 102400; fine-grained MoE: 2 shared + 64 routed experts, top-6.

Layer pattern: DeepSeek-MoE keeps its first layer dense (d_ff-sized here
per the assigned config) and all remaining 27 layers MoE.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    prefix_pattern=("dense",),
    pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2),
    mlp_type="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,
    notes="fine-grained MoE; first layer dense (prefix)",
)
