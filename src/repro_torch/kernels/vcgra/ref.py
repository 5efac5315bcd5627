"""Plain PyTorch versions of the Hopper VCGRA kernels, and ``vcgra_ref``.

Same operands and results as the kernels (dense settings banks, see
``ops.pack_settings_batched``), written independently of
``core/interpreter.py`` so the two oracles check each other: the
interpreter gathers through flat offset banks and muxes every unit per
lane, while these loop over apps and PE slots and apply each slot's one
configured unit (``core.ops.apply_op``).  The specialized kernel's plain
version runs the same slot loop with every dead slot idle and, with
``bake_consts``, the coefficient rows replaced by their baked values.  The
kernel wrappers take these only for tensors on the CPU; on the card the
tests and ``chip_smoke.py`` hold each kernel against them.

``vcgra_ref`` is the twin of the reference's oracle: the eager
interpreter (``overlay_step``) over one app's settings.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.interpreter import overlay_step
from repro_torch.core.ops import Op, apply_op
from repro_torch.core.specialize import _live_slots, baked_consts, const_value

DenseSettings = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


#: Opcodes with a functional unit; every other code (NONE, MAC, unknown)
#: makes its PE output 0, as the reference's mux chain does.
_UNIT_OPS = frozenset(int(o) for o in Op if o not in (Op.NONE, Op.MAC))


def _pe(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One PE slot: its configured unit, or zeros."""
    if op in _UNIT_OPS:
        return apply_op(Op(op), a, b)
    return torch.zeros_like(a)


def _levels(grid: GridSpec, ops: list, sel: list, out_sel: list,
            x: torch.Tensor) -> torch.Tensor:
    """One app's level pipeline: ``x [C, P] -> [K, P]`` (settings as
    host lists: ops [L][max_w], sel [L][max_w][2], out_sel [K])."""
    for lvl, width in enumerate(grid.pes_per_level):
        x = torch.stack([
            _pe(ops[lvl][s], x[sel[lvl][s][0]], x[sel[lvl][s][1]])
            for s in range(width)
        ])
    return torch.stack([x[k] for k in out_sel])


def vcgra_ref(grid: GridSpec, config: VCGRAConfig, x: torch.Tensor) -> torch.Tensor:
    """``x: [num_inputs, batch] -> y: [num_outputs, batch]`` through the
    eager interpreter."""
    return overlay_step(grid, config.to_torch(device=x.device), x)


def vcgra_conventional_ref(grid: GridSpec, settings: DenseSettings,
                           x: torch.Tensor) -> torch.Tensor:
    """One app's dense settings ``(ops [L, max_w], sel [L, max_w, 2],
    out_sel [K])`` over channel-major ``x [C, N]`` -> ``[K, N]``."""
    ops, sel, out_sel = (t.tolist() for t in settings)
    return _levels(grid, ops, sel, out_sel, x)


def vcgra_specialized_ref(grid: GridSpec, config: VCGRAConfig, x: torch.Tensor,
                          bake_consts: bool = False) -> torch.Tensor:
    """One app with its settings fixed, over ``x [C, N]`` -> ``[K, N]``:
    only live slots compute (dead ones idle), and with ``bake_consts``
    each coefficient channel holds its baked value whatever ``x`` has."""
    live = _live_slots(grid, config)
    ops = [[int(o) if s in live[lvl] else int(Op.NONE) for s, o in enumerate(config.opcodes[lvl])]
           for lvl in range(grid.num_levels)]
    sel = [s.tolist() for s in config.selects]
    consts = baked_consts(config) if bake_consts else {}
    if consts:
        x = x.clone()
        for i, value in consts.items():
            x[i] = const_value(value, x.dtype, x.device)
    return _levels(grid, ops, sel, [int(s) for s in config.out_sel], x)


def vcgra_batched_ref(grid: GridSpec, settings: DenseSettings,
                      xs: torch.Tensor) -> torch.Tensor:
    """Pre-packed channels ``[N, C, B]`` -> ``[N, K, B]``."""
    ops, sel, out_sel = (t.tolist() for t in settings)
    return torch.stack([
        _levels(grid, ops[i], sel[i], out_sel[i], xs[i]) for i in range(xs.shape[0])
    ])


def vcgra_fused_batched_ref(grid: GridSpec, radius: int, settings: DenseSettings,
                            ingests: Tuple[torch.Tensor, torch.Tensor],
                            images: torch.Tensor) -> torch.Tensor:
    """Raw frames ``[N, H, W]`` -> ``[N, K, H*W]``: each channel is a tap
    of the zero-padded frame or its const value, then the level pipeline."""
    ops, sel, out_sel = (t.tolist() for t in settings)
    tap_sel = ingests[0].tolist()
    consts = ingests[1]
    frames = images.to(grid.dtype)
    n, H, W = frames.shape
    r = int(radius)
    side = 2 * r + 1
    padded = F.pad(frames, (r, r, r, r))
    outs = []
    for i in range(n):
        chans = []
        for c, t in enumerate(tap_sel[i]):
            if t == side * side:
                chans.append(consts[i, c].expand(H * W))
            elif 0 <= t < side * side:
                dj, di = divmod(t, side)
                chans.append(padded[i, dj: dj + H, di: di + W].reshape(H * W))
            else:
                chans.append(frames.new_zeros(H * W))
        outs.append(_levels(grid, ops[i], sel[i], out_sel[i], torch.stack(chans)))
    return torch.stack(outs)


def vcgra_pipeline_batched_ref(grid: GridSpec, radii, settings: DenseSettings,
                               ingests: Tuple[torch.Tensor, torch.Tensor],
                               out_chs: torch.Tensor, hw: torch.Tensor,
                               frames: torch.Tensor, forward: bool = False) -> torch.Tensor:
    """A depth-S chain on raw frames ``[N, H, W]`` -> the last stage's
    ``[N, K, H*W]``, with B3's stage-stacked operands (settings
    ``[S, N, ...]``, ingests ``[S, N, C]``, ``out_chs [S, N]``,
    ``hw [N, 2]``).  Each stage runs over the whole frame; between stages
    app i forwards its output ``ys[i, out_chs[s, i]]`` (the output mux's
    pick, not the raw PE slot) with every pixel outside its true
    ``hw[i]`` region set to zero.  With ``forward`` (a segment of a longer
    chain) the last stage forwards too: the result is that masked
    ``[N, H, W]`` frame, the next segment's input."""
    x = frames.to(grid.dtype)
    n, H, W = x.shape
    h, w = hw[:, 0].tolist(), hw[:, 1].tolist()
    chans = out_chs.tolist()
    ys = None
    for s, r in enumerate(radii):
        ys = vcgra_fused_batched_ref(
            grid, r, tuple(t[s] for t in settings), (ingests[0][s], ingests[1][s]), x)
        if s < len(radii) - 1 or forward:
            x = torch.zeros_like(x)
            for i in range(n):
                y = ys[i, chans[s][i]].reshape(H, W)
                x[i, : h[i], : w[i]] = y[: h[i], : w[i]]
    return x if forward else ys
