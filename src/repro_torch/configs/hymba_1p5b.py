"""hymba-1.5b [arXiv:2411.13676]: 32L d1600 25H GQA(kv=5) head_dim 64
d_ff 5504 vocab 32001, ssm_state 16; parallel attention + mamba heads in
every layer, 128 learned meta tokens, sliding-window attention with
periodic global layers (here: layer 0 of each 8-layer superblock, i.e.
layers 0/8/16/24 -- an 8-layer scan body also keeps the remat working
set bounded; see EXPERIMENTS.md §Perf).

Hybrid constant-state + windowed attention => eligible for long_500k.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    pattern=("hymba_g",) + ("hymba",) * 7,
    window=1024,
    ssm=SSMConfig(state_dim=16, num_heads=25, head_dim=128, chunk=256),
    mlp_type="swiglu",
    meta_tokens=128,
    tie_embeddings=True,
    sub_quadratic=True,
    notes="global attention at layers 0/8/16/24; rest sliding-window 1024",
)
