"""Pixie application library: image-processing task graphs.

The paper demonstrates a 3x3 Sobel convolution (Fig. 4: blue pixel nodes,
red coefficient nodes, gray op nodes, green output; Fig. 5: mapped on a
45-PE / 4-VC grid).  This module builds that graph and a family of other
stencil/math applications, plus the memory-interface helpers that feed a
stencil's shifted pixel views into the top VC (the line-buffer analogue).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dfg import DFG, Ref

# 3x3 kernels -----------------------------------------------------------------

SOBEL_X = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
SOBEL_Y = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))
GAUSS3 = ((1, 2, 1), (2, 4, 2), (1, 2, 1))       # / 16
SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
LAPLACE = ((0, 1, 0), (1, -4, 1), (0, 1, 0))
BOX3 = ((1, 1, 1), (1, 1, 1), (1, 1, 1))         # / 9


def tap_name(dj: int, di: int) -> str:
    """Pixel-tap input name for offset (dj, di) relative to the setpoint."""
    return f"p{dj + 1}{di + 1}"


def _sum_tree(g: DFG, terms: List[Ref]) -> Ref:
    """Left-paired adder tree with the odd element carried: reproduces the
    paper's mapping where 'the weighted pixel value of the multiplication
    on the right border of the array is buffered in every stage of the
    array until it is used in the last addition' (the mapper inserts the
    BUF carriers)."""
    while len(terms) > 1:
        nxt: List[Ref] = []
        for i in range(0, len(terms) - 1, 2):
            nxt.append(g.add(terms[i], terms[i + 1]))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def conv3x3(
    name: str,
    kernel: Sequence[Sequence[float]],
    skip_zero: bool = False,
    divisor: float | None = None,
) -> DFG:
    """The paper's inner-loop task graph (Algorithm 1 / Fig. 4):
    sum_{j,i} sobel[c+j][c+i] * pixel[pos-j][pos-i].

    With ``skip_zero`` the zero-coefficient taps are not instantiated (an
    application-level optimization the paper's rectangular grid leaves to
    NONE PEs).  ``divisor`` appends a final DIV by a constant (for
    normalized kernels such as the Gaussian).
    """
    g = DFG(name)
    taps = {}
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            taps[(dj, di)] = g.input(tap_name(dj, di))
    prods: List[Ref] = []
    for r, dj in enumerate((-1, 0, 1)):
        for c, di in enumerate((-1, 0, 1)):
            kval = float(kernel[r][c])
            if skip_zero and kval == 0.0:
                continue
            k = g.const(f"k{r}{c}", kval)
            prods.append(g.mul(taps[(dj, di)], k))
    acc = _sum_tree(g, prods)
    if divisor is not None:
        acc = g.div(acc, g.const("norm", float(divisor)))
    g.output(acc)
    return g


def sobel_x(**kw) -> DFG:
    return conv3x3("sobel_x", SOBEL_X, **kw)


def sobel_y(**kw) -> DFG:
    return conv3x3("sobel_y", SOBEL_Y, **kw)


def gaussian_blur(**kw) -> DFG:
    return conv3x3("gauss3", GAUSS3, divisor=16.0, **kw)


def sharpen(**kw) -> DFG:
    return conv3x3("sharpen", SHARPEN, **kw)


def laplace(**kw) -> DFG:
    return conv3x3("laplace", LAPLACE, **kw)


def box_blur(**kw) -> DFG:
    return conv3x3("box3", BOX3, divisor=9.0, **kw)


def sobel_magnitude() -> DFG:
    """|Gx| + |Gy| on a single grid: two convolution trees joined at the
    bottom -- our demonstration that 'multiple instances of the same graph
    can be implemented' if the grid is big enough (paper Sec. III)."""
    g = DFG("sobel_mag")
    taps = {}
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            taps[(dj, di)] = g.input(tap_name(dj, di))

    def tree(kernel, tag) -> Ref:
        prods: List[Ref] = []
        for r, dj in enumerate((-1, 0, 1)):
            for c, di in enumerate((-1, 0, 1)):
                k = g.const(f"{tag}{r}{c}", float(kernel[r][c]))
                prods.append(g.mul(taps[(dj, di)], k))
        return _sum_tree(g, prods)

    gx = tree(SOBEL_X, "kx")
    gy = tree(SOBEL_Y, "ky")
    g.output(g.add(g.absolute(gx), g.absolute(gy)))
    return g


def threshold(t: float = 128.0) -> DFG:
    """Binary threshold: 1 if pixel > t else 0 (uses the GT comparator PE)."""
    g = DFG("threshold")
    p = g.input(tap_name(0, 0))
    g.output(g.gt(p, g.const("t", t)))
    return g


def identity() -> DFG:
    g = DFG("identity")
    g.output(g.buf(g.input(tap_name(0, 0))))
    return g


ALL_APPS = {
    "sobel_x": sobel_x,
    "sobel_y": sobel_y,
    "sobel_mag": sobel_magnitude,
    "gauss3": gaussian_blur,
    "sharpen": sharpen,
    "laplace": laplace,
    "box3": box_blur,
    "threshold": threshold,
    "identity": identity,
}


# Memory-interface helpers ----------------------------------------------------


def stencil_inputs(image: torch.Tensor, radius: int = 1) -> Dict[str, torch.Tensor]:
    """Produce the shifted pixel views feeding the top memory VC.

    The hardware would stream these from line buffers; here it is a
    zero-padded shift per tap.  ``image``: [H, W] -> each tap: [H*W]
    flattened, tap (dj, di) holding image[y+dj, x+di].

    This path is the *oracle* for the fused ingest (``core/ingest.py`` +
    ``interpreter.form_tap_bank``), which forms the same taps inside the
    overlay dispatch.  Production paths should prefer the fused one.
    """
    img = torch.as_tensor(image)
    H, W = img.shape
    pad = F.pad(img[None], (radius,) * 4)[0]
    out: Dict[str, torch.Tensor] = {}
    for dj in range(-radius, radius + 1):
        for di in range(-radius, radius + 1):
            view = pad[radius + dj : radius + dj + H, radius + di : radius + di + W]
            out[tap_name(dj, di)] = view.reshape(-1)
    return out


def conv2d_reference(
    image: np.ndarray, kernel: Sequence[Sequence[float]], divisor: float = 1.0
) -> np.ndarray:
    """Pure-numpy oracle of Algorithm 1: zero-padded 3x3 convolution in the
    tap convention ``sum kernel[j+1][i+1] * image[y+j, x+i]`` used
    consistently by this oracle and the DFG builder (for the paper's
    symmetric kernels this equals correlation with the flipped kernel)."""
    img = np.asarray(image)
    H, W = img.shape
    pad = np.pad(img, 1)
    kq = np.asarray(kernel, dtype=img.dtype)
    acc = np.zeros((H, W), dtype=np.result_type(img.dtype, kq.dtype))
    for r, dj in enumerate((-1, 0, 1)):
        for c, di in enumerate((-1, 0, 1)):
            acc = acc + kq[r, c] * pad[1 + dj : 1 + dj + H, 1 + di : 1 + di + W]
    if divisor != 1.0:
        if np.issubdtype(acc.dtype, np.integer):
            acc = acc // int(divisor)
        else:
            acc = acc / divisor
    return acc


def sobel_magnitude_reference(image: np.ndarray) -> np.ndarray:
    gx = conv2d_reference(image, SOBEL_X)
    gy = conv2d_reference(image, SOBEL_Y)
    return np.abs(gx) + np.abs(gy)
