"""Image pipeline with Pixie-overlay preprocessing.

Twin of the reference package's ``data/imaging.py``.  The preprocessing
chain of a vision pipeline (edge maps, blur, threshold, ...) is expressed
as Pixie dataflow graphs, mapped once onto one overlay, and re-targeted per
dataset/augmentation policy by a settings swap -- nothing is rebuilt (the
overlay's raison d'etre).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import applications as apps
from repro_torch.core.grid import GridSpec, rectangular
from repro_torch.core.interpreter import check_device, pack_inputs
from repro_torch.core.pixie import map_app
from repro_torch.core.place import level_demand
from repro_torch.core.plan import OverlayPlan, compile_plan
from repro_torch.core.tiling import pad_channels


def synthetic_images(batch: int, hw, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-images [batch, H, W] float32 in [0, 256)."""
    H, W = hw
    rng = np.random.default_rng(seed)
    base = rng.random((batch, H, W)).astype(np.float32) * 255.0
    yy, xx = np.mgrid[0:H, 0:W]
    pattern = 64 * np.sin(yy / 7.0)[None] + 64 * np.cos(xx / 11.0)[None]
    return (base * 0.5 + pattern + 96).astype(np.float32)


@dataclasses.dataclass
class PixiePreprocessor:
    """One overlay hosting a switchable preprocessing filter, on ``device``
    through ``backend`` ("hopper": B1 for the fused path, B2 otherwise)."""

    filters: Sequence[str] = ("sobel_mag", "gauss3", "sharpen", "laplace")
    float_pe: bool = True
    backend: str = "hopper"
    device: object = "cuda"

    def __post_init__(self):
        self.device = check_device(self.device)
        dfgs = {name: apps.ALL_APPS[name]() for name in self.filters}
        # One grid large enough for every filter => one overlay executable.
        demands = [level_demand(g) for g in dfgs.values()]
        depth = max(len(d) for d in demands)
        width = max(max(d) for d in demands)
        n_in = max(len(g.inputs) for g in dfgs.values())
        self.grid: GridSpec = rectangular(
            "preproc", n_in, depth, width, num_outputs=1, float_pe=self.float_pe
        )
        # Fused ingest: tap bank, channel select and dispatch in one plan;
        # reconfigure swaps settings (config + ingest tensors) only.  The
        # unfused overlay serves apps without an ingest plan.
        self.overlay = compile_plan(OverlayPlan(grid=self.grid, backend=self.backend))
        self.fused_overlay = compile_plan(
            OverlayPlan(grid=self.grid, fused=True, radius=1, backend=self.backend)
        )
        self.configs = {name: map_app(g, self.grid) for name, g in dfgs.items()}
        self.active = self.filters[0]

    def reconfigure(self, name: str) -> None:
        """Settings swap -- never rebuilds anything."""
        if name not in self.configs:
            raise KeyError(f"unknown filter {name!r}")
        self.active = name

    def __call__(self, image) -> torch.Tensor:
        """[H, W] -> [H, W] filtered, through the overlay."""
        image = torch.as_tensor(image, device=self.device)
        cfg = self.configs[self.active]
        if cfg.ingest is not None and cfg.ingest.radius == 1:
            y = self.fused_overlay(
                cfg.to_torch(device=self.device),
                cfg.ingest.to_torch(self.grid.dtype, device=self.device), image,
            )
            return y[0].reshape(image.shape)
        taps = apps.stencil_inputs(image)
        feed = {k: v for k, v in taps.items() if k in cfg.input_order}
        # Padded to the memory-VC width: every app runs the same overlay.
        x = pad_channels(pack_inputs(cfg, feed, self.grid.dtype, device=self.device),
                         self.grid.num_inputs)
        y = self.overlay(cfg.to_torch(device=self.device), x)
        return y[0].reshape(image.shape)

    def batch(self, images) -> torch.Tensor:
        """[B, H, W] -> [B, H, W], one frame at a time."""
        return torch.stack([self(img) for img in torch.as_tensor(images, device=self.device)])


def patch_embed_stub(images: np.ndarray, num_patches: int, d_model: int) -> np.ndarray:
    """SigLIP-stub: filtered image -> [B, num_patches, d_model] embeddings
    via patch-mean pooling + fixed random projection (deterministic)."""
    B, H, W = images.shape
    side = int(np.sqrt(num_patches))
    ph, pw = H // side, W // side
    pooled = images[:, : side * ph, : side * pw]
    pooled = pooled.reshape(B, side, ph, side, pw).mean(axis=(2, 4))
    pooled = pooled.reshape(B, side * side, 1)
    rng = np.random.default_rng(42)
    proj = rng.standard_normal((1, d_model)).astype(np.float32) * 0.02
    return (pooled / 255.0) @ proj
