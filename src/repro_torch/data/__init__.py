"""Data pipelines around the overlay: image preprocessing on Pixie."""

from repro_torch.data.imaging import PixiePreprocessor, patch_embed_stub, synthetic_images

__all__ = ["PixiePreprocessor", "patch_embed_stub", "synthetic_images"]
