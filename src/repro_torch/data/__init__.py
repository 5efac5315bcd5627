"""Data pipelines: the synthetic token stream of the training path and
image preprocessing on Pixie."""

from repro_torch.data.imaging import PixiePreprocessor, patch_embed_stub, synthetic_images
from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline", "PixiePreprocessor", "patch_embed_stub", "synthetic_images"]
