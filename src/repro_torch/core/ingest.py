"""IngestPlan: how each memory-VC channel is *produced* from a raw frame,
and the ingest pipelining modes of a dispatch.

Twin of the reference package's ``core/ingest.py``.  At map time every
channel of an application gets a production rule:

  tap (dj, di)   gathered from the raw image by a shifted read
                 (the line-buffer read)
  const          a burned-in coefficient value
  zero           an unused (padding) channel of the grid's memory VC

The rules are *runtime settings arrays*: the fused dispatch forms one tap
bank per frame and each channel selects its producer from it, exactly
like a VC mux select, so every app mapped on a grid shares one executable.

:data:`INGEST_MODES` and :class:`ReadinessProbe` serve the fleet's async
ingest: the probe is a ``torch.cuda.Event`` recorded after a dispatch and
polled with ``query()``, where the reference parks a watcher thread on a
JAX value.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: Ingest pipelining modes of a fleet (and its front-ends).  "sync" packs,
#: dispatches and copies outputs back in strict order; "async"
#: double-buffers: frames are embedded into a pool of two pinned canvases
#: per shape and copied to the card on a side stream, outputs come back
#: with one copy per dispatch into a pool of two pinned buffers per size
#: and are read lazily, so packing of flush k+1 overlaps the device work of
#: flush k.  Both modes run the same executables and are bitwise-identical.
INGEST_MODES = ("sync", "async")


def check_ingest(mode: str) -> str:
    """Validate (and return) an ingest mode; shared by the fleet and its
    front-ends."""
    if mode not in INGEST_MODES:
        raise ValueError(
            f"unknown ingest mode {mode!r}; expected one of {INGEST_MODES}"
        )
    return mode


class ReadinessProbe:
    """Zero-timeout readiness check for work queued on ``device``.

    On a CUDA device the probe records a ``torch.cuda.Event`` on ``stream``
    (default: the current one) when it is made; :meth:`ready` is the
    event's ``query()``, a poll that never synchronizes the device, and
    :meth:`wait` blocks on that event alone.  PyTorch runs CPU work
    synchronously, so on the CPU the work is complete when the probe is
    made: the probe is always ready and :attr:`on_device` is False.
    """

    def __init__(self, device, stream: Optional["torch.cuda.Stream"] = None):
        dev = torch.device(device)
        self._event = None
        if dev.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(stream if stream is not None
                               else torch.cuda.current_stream(dev))

    @property
    def on_device(self) -> bool:
        """Does the probe watch a CUDA event (False: always ready)?"""
        return self._event is not None

    def ready(self) -> bool:
        """Zero-timeout poll: has the work completed?"""
        return self._event is None or self._event.query()

    def block(self, stream: "torch.cuda.Stream") -> None:
        """Make ``stream`` wait for the probed work (device side; the host
        does not block).  A no-op on the CPU."""
        if self._event is not None:
            stream.wait_event(self._event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block (at most ``timeout`` seconds) until the work completes;
        returns whether it completed within the wait."""
        if self._event is None:
            return True
        if timeout is None:
            self._event.synchronize()
            return True
        deadline = time.perf_counter() + timeout
        while not self._event.query():
            if time.perf_counter() >= deadline:
                return False
            time.sleep(5e-5)
        return True


def tap_offsets(radius: int) -> Tuple[Tuple[int, int], ...]:
    """Canonical tap-bank layout for a stencil radius: all (dj, di) offsets
    in row-major order.  Every plan built for the same radius indexes the
    same bank, which is what lets N different apps stack into one fused
    dispatch."""
    r = int(radius)
    return tuple(
        (dj, di) for dj in range(-r, r + 1) for di in range(-r, r + 1)
    )


def _tap_lookup(radius: int) -> Dict[str, int]:
    # Inverse of applications.tap_name without importing it.
    return {
        f"p{dj + 1}{di + 1}": t
        for t, (dj, di) in enumerate(tap_offsets(radius))
    }


class IngestError(ValueError):
    """A channel cannot be produced from a raw image (not a tap, not a
    const) -- the app needs the unfused named-channel path."""


@dataclasses.dataclass
class IngestPlan:
    """Channel-production settings for one app on one grid.

    ``tap_sel[c]``: index into the fused tap bank for channel ``c``.  The
    bank holds ``num_taps`` shifted views plus one trailing zero row;
    channels selecting the zero row take ``const_vals[c]`` verbatim (0 for
    grid-padding channels).  Both arrays span the *grid's* full memory-VC
    width, so the fused path needs no separate ``pad_channels`` step.
    """

    radius: int
    tap_sel: np.ndarray      # int32 [num_inputs]
    const_vals: np.ndarray   # float64 [num_inputs]; cast to grid dtype at use
    channel_names: Tuple[str, ...] = ()

    @property
    def num_taps(self) -> int:
        return (2 * self.radius + 1) ** 2

    @property
    def zero_row(self) -> int:
        return self.num_taps

    def to_torch(self, dtype: torch.dtype, device=None):
        """``(tap_sel int32 [C], const_vals [C] in dtype)`` on ``device``."""
        return (
            torch.as_tensor(self.tap_sel, dtype=torch.int32, device=device),
            torch.as_tensor(self.const_vals, dtype=torch.float64,
                            device=device).to(dtype),
        )

    @staticmethod
    def stack(plans: Sequence["IngestPlan"], dtype: torch.dtype, device=None):
        """Stack N same-radius plans into batched settings tensors
        ``(tap_sel: int32 [N, C], const_vals: [N, C] in dtype)`` -- the
        ingest analogue of ``VCGRAConfig.stack``.  Built on the host and
        copied to ``device`` once, so a cached bank costs no per-flush
        conversion."""
        if not plans:
            raise ValueError("cannot stack an empty plan list")
        r0, w0 = plans[0].radius, plans[0].tap_sel.shape[0]
        for p in plans[1:]:
            if p.radius != r0 or p.tap_sel.shape[0] != w0:
                raise ValueError(
                    f"ingest plan (radius={p.radius}, width={p.tap_sel.shape[0]}) "
                    f"does not match the stack's (radius={r0}, width={w0})"
                )
        tap_sel = np.stack([np.asarray(p.tap_sel, np.int32) for p in plans])
        consts = np.stack([np.asarray(p.const_vals, np.float64) for p in plans])
        return (
            torch.as_tensor(tap_sel, device=device),
            torch.as_tensor(consts, device=device).to(dtype),
        )

    def at_radius(self, radius: int) -> "IngestPlan":
        """Re-plan the same channel production rules against a different
        tap-bank radius.  Each tap channel is translated by its *(dj, di)*
        offset into the new bank's row-major layout; const and zero
        channels are radius-independent.  Raises :class:`IngestError` when
        a channel reads a tap out of the new radius's reach."""
        r = int(radius)
        if r == self.radius:
            return self
        offsets = tap_offsets(self.radius)
        lookup = {off: t for t, off in enumerate(tap_offsets(r))}
        zero = len(lookup)
        tap_sel = np.full((self.tap_sel.shape[0],), zero, dtype=np.int32)
        for c, t in enumerate(self.tap_sel):
            if int(t) == self.zero_row:
                continue
            off = offsets[int(t)]
            if off not in lookup:
                name = (
                    self.channel_names[c]
                    if c < len(self.channel_names) else f"#{c}"
                )
                raise IngestError(
                    f"channel {name!r} reads tap {off}, out of reach of a "
                    f"radius-{r} bank"
                )
            tap_sel[c] = lookup[off]
        return IngestPlan(
            radius=r, tap_sel=tap_sel, const_vals=self.const_vals.copy(),
            channel_names=self.channel_names,
        )

    # -- (de)serialization (rides along inside VCGRAConfig.to_json) ---------

    def to_dict(self) -> dict:
        return {
            "radius": self.radius,
            "tap_sel": self.tap_sel.tolist(),
            "const_vals": self.const_vals.tolist(),
            "channel_names": list(self.channel_names),
        }

    @staticmethod
    def from_dict(d: dict) -> "IngestPlan":
        return IngestPlan(
            radius=int(d["radius"]),
            tap_sel=np.asarray(d["tap_sel"], dtype=np.int32),
            const_vals=np.asarray(d["const_vals"], dtype=np.float64),
            channel_names=tuple(d.get("channel_names", ())),
        )


def plan_for(
    input_order: Sequence[str],
    const_values: Dict[str, float],
    num_inputs: int,
    radius: int = 1,
) -> IngestPlan:
    """Build the production plan for an image-fed application.

    Mirrors ``pack_inputs``'s precedence exactly: a name that is a stencil
    tap is fed from the image (even if it also has a const default), a name
    with a const default is burned in, anything else raises
    :class:`IngestError` (the app needs named channels, not a frame).
    Channels beyond ``len(input_order)`` up to the grid's memory-VC width
    are zero rows.
    """
    if len(input_order) > num_inputs:
        raise ValueError(
            f"app uses {len(input_order)} input channels, grid has {num_inputs}"
        )
    lookup = _tap_lookup(radius)
    zero = len(lookup)
    tap_sel = np.full((num_inputs,), zero, dtype=np.int32)
    const_vals = np.zeros((num_inputs,), dtype=np.float64)
    for c, name in enumerate(input_order):
        if name in lookup:
            tap_sel[c] = lookup[name]
        elif name in const_values:
            const_vals[c] = float(const_values[name])
        else:
            raise IngestError(
                f"channel {name!r} is neither a radius-{radius} stencil tap "
                f"nor a const; it cannot be produced from a raw image"
            )
    names = tuple(input_order) + ("<pad>",) * (num_inputs - len(input_order))
    return IngestPlan(
        radius=radius, tap_sel=tap_sel, const_vals=const_vals,
        channel_names=names,
    )

