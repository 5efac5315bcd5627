"""Plain reference of the Pixie image apps and their chains.

Written from the apps' definitions alone (the paper's Algorithm 1, a
zero-padded 3 x 3 stencil ``sum k[j+1][i+1] * image[y+j, x+i]``, and the
library's threshold and identity), in plain PyTorch on exact 64-bit
integers.  It imports nothing of the port and takes nothing it made.

A chain runs its stages one after another, each on the whole of the
previous stage's [H, W] output with zeros past the frame's edge, as a
request that chains apps asks for.  For integer grids a normalised kernel
divides with the floor.  Over 16-bit samples no intermediate of these apps
leaves the int32 range (a sum of products stays within 8 * 65535 in
magnitude, a Gaussian within [0, 65535]), so exact integers are what an
int32 grid has to give.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: App -> (3 x 3 kernel, divisor).
KERNELS = {
    "sobel_x": (((-1, 0, 1), (-2, 0, 2), (-1, 0, 1)), 1),
    "sobel_y": (((-1, -2, -1), (0, 0, 0), (1, 2, 1)), 1),
    "sharpen": (((0, -1, 0), (-1, 5, -1), (0, -1, 0)), 1),
    "laplace": (((0, 1, 0), (1, -4, 1), (0, 1, 0)), 1),
    "gauss3": (((1, 2, 1), (2, 4, 2), (1, 2, 1)), 16),
    "box3": (((1, 1, 1), (1, 1, 1), (1, 1, 1)), 9),
}
#: ``threshold`` answers 1 where a sample exceeds this, else 0.
THRESHOLD = 128


def conv3x3(x: torch.Tensor, kernel, divisor: int) -> torch.Tensor:
    H, W = x.shape
    pad = torch.zeros((H + 2, W + 2), dtype=torch.int64, device=x.device)
    pad[1:H + 1, 1:W + 1] = x
    acc = torch.zeros((H, W), dtype=torch.int64, device=x.device)
    for r in range(3):
        for c in range(3):
            if kernel[r][c]:
                acc += kernel[r][c] * pad[r:r + H, c:c + W]
    if divisor != 1:
        acc = torch.div(acc, divisor, rounding_mode="floor")
    return acc


def stage(app: str, x: torch.Tensor) -> torch.Tensor:
    if app in KERNELS:
        return conv3x3(x, *KERNELS[app])
    if app == "sobel_mag":
        return (conv3x3(x, *KERNELS["sobel_x"]).abs()
                + conv3x3(x, *KERNELS["sobel_y"]).abs())
    if app == "threshold":
        return (x > THRESHOLD).to(torch.int64)
    if app == "identity":
        return x.clone()
    raise KeyError(app)


def run(stages: Sequence[str], frame: torch.Tensor) -> torch.Tensor:
    """One request's answer: ``stages`` (one app, or a chain) over the
    [H, W] ``frame``, as int64 on the frame's device."""
    x = frame.to(torch.int64)
    for app in stages:
        x = stage(app, x)
    return x
