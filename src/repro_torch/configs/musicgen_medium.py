"""musicgen-medium [arXiv:2306.05284]: 48L d1536 24H(MHA) head_dim 64
d_ff 6144 vocab 2048; decoder-only over EnCodec tokens.

The EnCodec tokenizer/decoder (the audio modality frontend) is a STUB per
the brief: input_specs provides the token stream (and training batches are
synthetic codes); the text-conditioning cross-attention of the original is
simplified away (documented in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pattern=("dense",),
    mlp_type="gelu",
    tie_embeddings=False,
    modality="audio_stub",
    sub_quadratic=False,
)
