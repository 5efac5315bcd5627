"""xlstm-1.3b [arXiv:2405.04517; unverified tier]: 48 blocks d2048,
4 mLSTM heads, no separate FFN (d_ff=0 — the mLSTM block carries a
projection factor 2), vocab 50304; sLSTM blocks interleaved 7:1.

mLSTM runs as chunked gated linear attention (matrix state per head);
sLSTM is the sequential scalar recurrence (not parallelizable by design).
Constant-size state => eligible for long_500k.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,          # nominal; mLSTM uses inner=2*d, dh=inner/heads
    d_ff=0,
    vocab_size=50_304,
    pattern=("mlstm",) * 7 + ("slstm",),
    ssm=SSMConfig(state_dim=16, num_heads=4, head_dim=1024, chunk=256),
    tie_embeddings=True,
    sub_quadratic=True,
    notes="7:1 mLSTM:sLSTM; O(1) state per layer",
)
