"""Device meshes: the LM's sharding constraints and the overlay's
placement of a batched dispatch.

Twin of the reference package's ``parallel/axes.py``.

**The LM mesh** is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``("data", "model")`` or ``("pod", "data",
"model")``), one process per card.  :func:`lm_mesh` makes one ambient, as
the reference's ``with mesh:`` does; then ``constrain(x, "batch", None,
"model")`` redistributes a DTensor ``x`` to the placements those logical
axes name (``"batch"`` is ``("pod", "data")``), the twin of
``with_sharding_constraint``.  Off-mesh, or on a plain tensor, it is the
identity, so model code can sprinkle constraints freely.

**The overlay mesh** (:class:`MeshSpec`, :class:`Mesh`) places the shards
of a batched image dispatch.  :class:`MeshSpec` is the device-placement
axis of an ``OverlayPlan``: ``app`` shards the leading app (N) axis of a
batched dispatch, ``rows`` shards the pixel rows of fused frames into
contiguous bands whose ``radius``-wide seam halos come from the neighbour
band (:func:`halo_exchange_rows`), so one frame can span devices.

The reference runs its overlay mesh as one SPMD program (``shard_map``) in
one process.  The port keeps the single controller: one process and one
host thread issue every shard's launches, each shard inside
``torch.cuda.device(d)`` on that device's current stream.  An operand
chunk or a neighbour's edge rows reach another card by a peer copy
(``Tensor.to(d, non_blocking=True)``), which PyTorch orders against the
current streams of both devices; between two shards of one device it is
no copy at all.

:func:`local_devices` is the one place an overlay mesh learns what the
host has.  Tests replace it by ``[cpu] * 4`` (and the chip smoke by
``[cuda:0] * 4``) to run a *logical* mesh of several shards on one device,
the twin of the reference CI's forced host device count.  ``build_mesh``
returns ``None`` when the host has fewer devices than the spec asks for:
callers fall back to the single-device path, which is bitwise identical.

Every sharded result is bitwise equal to the single-device run: the
per-app work is independent along N, a ``band + 2r``-row slab whose
border rows are the neighbours' edge rows (zeros at the frame border)
reads exactly like the frame around the band, and the executors' output
does not depend on the frame's height.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# -- the LM mesh: ambient mesh, spec placements, logical-axis constraints -------

_AMBIENT = threading.local()


@contextlib.contextmanager
def lm_mesh(mesh):
    """``mesh`` (a ``DeviceMesh``) ambient for the calling thread, as the
    reference's ``with mesh:``; nests."""
    stack = _AMBIENT.__dict__.setdefault("meshes", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The innermost :func:`lm_mesh` of the calling thread, or None off-mesh."""
    stack = getattr(_AMBIENT, "meshes", None)
    return stack[-1] if stack else None


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` (``mesh_dim_names`` and a
    shape tuple) or of a shape-only mesh (``axis_names`` and a shape
    dict, as the reference's ``Mesh`` has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def placements(spec: Sequence, mesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh`` (a ``DeviceMesh`` with
    axis names): ``Shard(d)`` on every mesh dim that tensor dim ``d``
    names, ``Replicate()`` on the others.  A dim named by several mesh
    dims is split over them major first, as ``PartitionSpec`` splits it,
    so their order in the spec must be the mesh's.  A mesh dim of size 1
    holds the whole tensor, so it replicates (DTensor's view rules cannot
    keep a shard on a size-1 tensor dim, which such a mesh dim allows)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    named = set()
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        order = [names.index(a) for a in axes if a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names mesh axes {axes} out of the mesh's "
                             f"order {names}")
        for i in order:
            if i in named:
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} named twice")
            named.add(i)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _resolve(logical: Optional[str], names: Sequence[str]):
    if logical is None:
        return None
    if logical == "batch":
        axes = tuple(a for a in ("pod", "data") if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    return logical if logical in names else None


def batch_divides(n: int) -> bool:
    """Whether a batch of ``n`` splits evenly over the ambient mesh's batch
    axes (``("pod", "data")``); True off-mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        return True
    sizes = axis_sizes(mesh)
    total = 1
    for a in ("pod", "data"):
        total *= sizes.get(a, 1)
    return n % total == 0


def _redistribute(x: DTensor, spec) -> DTensor:
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain(x, *logical_axes: Optional[str]):
    """``x`` laid out as the logical axes say, one per dim (None:
    replicated): the twin of ``with_sharding_constraint``, except that a
    dim the named axes do not divide stays whole (an uneven split is never
    asked for).  The identity off-mesh and for a plain tensor."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"spec {logical_axes} vs rank {x.ndim}")
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    spec = []
    for n, a in zip(x.shape, logical_axes):
        axes = _resolve(a, names)
        width = 1
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            width *= sizes.get(ax, 1) if ax is not None else 1
        spec.append(axes if n % width == 0 else None)
    return _redistribute(x, tuple(spec))


def batch_only(x):
    """A DTensor ``x`` whole but along a split of its leading (batch) dim:
    every other split gathered, partial sums reduced; anything else
    itself.  Always a redistribution (free where ``x`` is laid out so
    already), so the gradient flowing back through it takes that layout as
    well: a reshape of ``x`` before it never meets a split in backward."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def redistribute_like(x, ref):
    """``x`` laid out as ``ref`` is (whole where ``ref`` holds partial
    sums), where ``ref`` is a DTensor (an in-place update keeps its
    target's layout, so the operand must take it first); otherwise ``x``
    itself."""
    if isinstance(ref, DTensor) and isinstance(x, DTensor):
        want = tuple(Replicate() if p.is_partial() else p for p in ref.placements)
        if tuple(x.placements) != want:
            return x.redistribute(ref.device_mesh, want)
    return x


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    strides, n = [], 1
    for d in reversed(tuple(shape)):
        strides.append(n)
        n *= int(d)
    return tuple(reversed(strides))


def local_block(shape: Sequence[int], mesh, layout: Sequence) -> Tuple[Tuple[int, ...],
                                                                    Tuple[int, ...]]:
    """``(shape, offset)`` of this rank's block of a global ``shape`` laid
    out by the DTensor placements ``layout`` over ``mesh``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, tuple(layout))
    return tuple(local), tuple(offset)


def from_block(local: torch.Tensor, mesh, layout: Sequence, shape: Sequence[int]) -> DTensor:
    """The DTensor of global ``shape`` whose block on this rank is
    ``local``, laid out by ``layout``: no communication."""
    return DTensor.from_local(local, mesh, tuple(layout), run_check=False, shape=tuple(shape),
                              stride=contiguous_strides(shape))


def ragged_share(n: int, mesh, dims: Sequence[int]) -> Tuple[int, int, int]:
    """``(first, count, index)`` of this rank's share of ``n`` items split
    over the mesh dims ``dims`` as a ``Shard`` over them splits a dim of
    ``n`` (``torch.chunk``'s shares, as XLA pads an uneven split: the last
    shares may be short or empty); ``index`` is the rank's place among
    their ranks, whose shares follow each other in that order."""
    over = [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)]
    parts = 1
    for i in dims:
        parts *= mesh.shape[i]
    (count,), (first,) = local_block((n,), mesh, over)
    return first, count, local_block((parts,), mesh, over)[1][0]


def model_block(w):
    """This rank's block of weight ``w`` and its split over 'model': a
    DTensor gathered over every mesh dim but 'model' (FSDP's split); a
    plain tensor is the whole weight, unsplit."""
    if not isinstance(w, DTensor):
        return w, Replicate(), None
    mesh = w.device_mesh
    model = mesh.mesh_dim_names.index("model")
    split = w.placements[model]
    split = split if isinstance(split, Shard) else Replicate()
    keep = tuple(split if i == model else Replicate() for i in range(mesh.ndim))
    if tuple(w.placements) != keep:
        w = w.redistribute(mesh, keep)
    return w, split, model


def whole_local(w, x):
    """The whole of a DTensor weight ``w`` on this rank (gathered where the
    plan splits it, e.g. FSDP over 'data'), as a plain tensor for a product
    with the rank's block of the DTensor activation ``x``: its grad is a
    partial sum over the mesh dims that split ``x`` and whole over the
    others.  A plain ``w`` is itself."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    if any(not p.is_replicate() for p in w.placements):
        w = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return w.to_local(grad_placements=tuple(Partial() if isinstance(p, Shard) else Replicate()
                                            for p in x.placements))


def map_block(fn: Callable, x, shape: Sequence[int]):
    """``fn`` on ``x``'s block: a DTensor of global ``shape`` laid out as
    ``x`` is (``fn`` keeps the sizes of ``x``'s sharded dims); ``fn(x)``
    for a plain tensor."""
    if not isinstance(x, DTensor):
        return fn(x)
    return from_block(fn(x.to_local()), x.device_mesh, x.placements, shape)


def constrain_time_mixer(x):
    """Batch-split a recurrent mixer's input over EVERY divisible mesh axis.

    Recurrent scans (sLSTM steps, GLA chunks) cannot parallelise over
    'model', so the model axis would sit idle computing replicas; instead
    the batch dim absorbs it as extra data parallelism where divisibility
    allows."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    axes = []
    prod = 1
    for a in ("pod", "data", "model"):
        if a in sizes and x.shape[0] % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    if not axes:
        return x
    return _redistribute(x, (tuple(axes) if len(axes) > 1 else axes[0],
                             *([None] * (x.ndim - 1))))


# -- the overlay mesh -----------------------------------------------------------

APP_AXIS = "app"
ROW_AXIS = "rows"

#: Cross-shard halo copies since the last :func:`reset_copy_counts`: one
#: per neighbour slab a band receives (a radius-0 exchange makes none).
halo_copies = 0
#: Settings-bank chunks copied to another device (:func:`replica`).
replica_copies = 0


def reset_copy_counts() -> None:
    global halo_copies, replica_copies
    halo_copies = 0
    replica_copies = 0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The device-placement axis of an ``OverlayPlan``, as structured data.

    ``app``  how many ways the leading app (N) axis of a batched dispatch
             is sharded;
    ``rows`` how many contiguous pixel-row bands a fused frame is split
             into across devices -- each shard owns ``band = H / rows``
             output rows and receives its neighbours' ``radius`` edge rows
             (:func:`halo_exchange_rows`) before running the *unchanged*
             per-shard executor.

    Frozen and hashable: the spec lives inside the plan, so it is part of
    the cache key.  ``MeshSpec()`` is the single-device identity.
    """

    app: int = 1
    rows: int = 1

    def __post_init__(self):
        for name in ("app", "rows"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"MeshSpec.{name} must be an int >= 1, got {v!r}")

    @property
    def size(self) -> int:
        """Total devices the spec asks for (``app * rows``)."""
        return self.app * self.rows

    def app_only(self) -> "MeshSpec":
        """The 1-D projection of this spec: the same app-axis width, no row
        sharding.  Unfused dispatches use it (pre-packed channels carry no
        row structure to band-shard)."""
        return MeshSpec(app=self.app)

    def shape(self) -> Tuple[int, int]:
        """``(app, rows)`` -- the stats stamp of the spec."""
        return (self.app, self.rows)

    def __str__(self) -> str:
        return f"{self.app}x{self.rows}"


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices of ``kind`` this process can use: every visible card
    for ``"cuda"`` (none without one), the one CPU device for ``"cpu"``."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unknown device kind {kind!r}")


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, so a mesh,
    its stream table and its settings replicas compare devices reliably."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A granted mesh: its devices as an ``[app]`` or ``[app, rows]`` grid.

    ``devices[i][j]`` runs app shard ``i``'s row band ``j`` (a 1-D mesh
    has one band per app shard).  Row neighbours are adjacent devices, so
    seam copies stay between nearby cards.  The same device may appear
    more than once: that is a logical mesh, whose shards run one after
    another on one card."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...]

    @property
    def app(self) -> int:
        return len(self.devices)

    @property
    def rows(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.app, self.rows)))

    @property
    def first(self) -> torch.device:
        """The device the sharded executors return their output on."""
        return self.devices[0][0]

    def device_list(self) -> List[torch.device]:
        """Every shard's device, app-major."""
        return [d for row in self.devices for d in row]


def build_mesh(spec: MeshSpec, kind: str = "cuda") -> Optional[Mesh]:
    """Realize a :class:`MeshSpec` against :func:`local_devices` of
    ``kind``: a 1-D ``("app",)`` mesh for ``rows == 1``, else a 2-D
    ``("app", "rows")`` mesh whose consecutive devices form one app shard's
    row bands.  ``None`` when the spec is the single-device identity or
    the host has fewer devices than ``spec.size`` -- callers fall back to
    the single-device path, and the fleet stamps the degradation."""
    if spec.size <= 1:
        return None
    avail = local_devices(kind)
    if len(avail) < spec.size:
        return None
    devs = tuple(canonical(d) for d in avail[: spec.size])
    grid = tuple(devs[i * spec.rows:(i + 1) * spec.rows] for i in range(spec.app))
    return Mesh(grid, (APP_AXIS,) if spec.rows == 1 else (APP_AXIS, ROW_AXIS))


def app_mesh(devices: int, kind: str = "cuda") -> Optional[Mesh]:
    """A 1-D mesh over the first ``devices`` local devices of ``kind``, or
    ``None`` for ``devices <= 1`` or a host with fewer devices."""
    if int(devices) <= 1:
        return None
    return build_mesh(MeshSpec(app=int(devices)), kind)


@dataclasses.dataclass(frozen=True)
class ShardedFrames:
    """A fused frame canvas ``[N, H, W]`` already split into its
    ``(app, row-band)`` blocks, block ``[i][j]`` on ``mesh.devices[i][j]``
    (:func:`repro_torch.parallel.sharding.frame_sharding`): the fleet's
    sharded async ship path hands it to a mesh executable in place of one
    canvas tensor, so no block is copied twice."""

    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    shape: Tuple[int, int, int]


def on_device(device: torch.device):
    """``device`` made current for the calling thread, on its current
    stream (the shard's stream); a no-op for the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(torch.cuda.current_stream(device)))
    return stack


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, contiguous: a peer copy between cards, nothing
    between two shards of one device."""
    if t.device != device:
        t = t.to(device, non_blocking=True)
    return t.contiguous()


#: Replicas of settings tensors on other devices, by source tensor:
#: ``id(src) -> {(src._version, device, lo, hi): replica}``.  An entry
#: lives as long as its source (the fleet's bank cache holds those).
_REPLICAS: Dict[int, Dict[Tuple, torch.Tensor]] = {}


def replica(t: torch.Tensor, device: torch.device, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of the settings tensor ``t`` on ``device``.  A copy
    to another device is made once per source tensor and device and reused
    while ``t`` lives unmodified, so a repeat flush of a cached bank copies
    nothing."""
    global replica_copies
    part = t[lo:hi]
    if part.device == device:
        return part
    key = (t._version, device, lo, hi)
    cache = _REPLICAS.get(id(t))
    if cache is None:
        cache = _REPLICAS[id(t)] = {}
        weakref.finalize(t, _REPLICAS.pop, id(t), None)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = part.to(device, non_blocking=True)
        replica_copies += 1
    return hit


def _tree_map(fn: Callable, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _check_split(n: int, H: int, mesh: Mesh, radius: int) -> Tuple[int, int]:
    if n % mesh.app or H % mesh.rows:
        raise ValueError(
            f"a [{n}, {H}, W] canvas does not split over a {mesh.app}x{mesh.rows} mesh; "
            "pad it first (plan._with_mesh_padding)")
    chunk, band = n // mesh.app, H // mesh.rows
    if mesh.rows > 1 and band < radius:
        raise ValueError(f"row band {band} is shallower than the radius {radius}: "
                         "the seam exchange would need two hops")
    return chunk, band


def _block(images, mesh: Mesh, i: int, j: int, chunk: int, band: int) -> torch.Tensor:
    """App shard ``i``'s row band ``j`` of a canvas (of a packed channel
    stack on a 1-D mesh: ``band`` its whole second axis), on its device."""
    if isinstance(images, ShardedFrames):
        return images.blocks[i][j]
    return _to(images[i * chunk:(i + 1) * chunk, j * band:(j + 1) * band], mesh.devices[i][j])


def _gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int) -> torch.Tensor:
    return torch.cat([_to(p, device) for p in parts], dim=dim)


def shard_apps(fn: Callable, mesh: Mesh, num_args: int) -> Callable:
    """``fn`` run once per app shard of ``mesh``: every operand (nested
    tuples of tensors, each leading with N) is split into ``mesh.app``
    chunks along N, each chunk runs ``fn`` on its device, and the outputs
    come back as one tensor on the mesh's first device.  The per-app work
    of the batched executors is independent along N, so the result is
    bitwise the single-device one.  Callers pad N to a multiple of the
    mesh width first (``plan._with_app_padding``).  Settings operands (all
    but the last) reach other devices through :func:`replica`."""

    def sharded(*args):
        if len(args) != num_args:
            raise TypeError(f"expected {num_args} operands, got {len(args)}")
        images = args[-1]
        n = images.shape[0]
        if n % mesh.app:
            raise ValueError(f"{n} apps do not split over {mesh.app} shards; pad them first "
                             "(plan._with_app_padding)")
        chunk = n // mesh.app
        outs = []
        for i, row in enumerate(mesh.devices):
            d, lo, hi = row[0], i * chunk, (i + 1) * chunk
            with on_device(d):
                settings = _tree_map(lambda t: replica(t, d, lo, hi), args[:-1])
                outs.append(fn(*settings, _block(images, mesh, i, 0, chunk, images.shape[1])))
        return _gather(outs, mesh.first, 0)

    return sharded


def halo_exchange_rows(bands: Sequence[torch.Tensor], radius: int) -> List[torch.Tensor]:
    """The seam halos of one app shard's row bands ``[n, band, W]``.

    Returns each band as ``[n, band + 2r, W]``: the ``r`` rows above it are
    the previous band's last ``r`` rows, the ``r`` rows below it the next
    band's first ``r`` rows, and at the frame's top and bottom border they
    are zeros (``form_tap_bank``'s zero-pad semantics).  A neighbour's rows
    come over by a peer copy to the band's device (no copy on a logical
    mesh), each counted in :data:`halo_copies`.  Radius 0 returns the bands
    themselves and copies nothing."""
    global halo_copies
    r = int(radius)
    if r <= 0:
        return list(bands)
    out = []
    last = len(bands) - 1
    for j, band in enumerate(bands):
        n, h, W = band.shape
        if h < r:
            raise ValueError(f"row band of {h} rows is shallower than the radius {r}")
        zeros = band.new_zeros((n, r, W))
        above = zeros if j == 0 else _to(bands[j - 1][:, h - r:, :], band.device)
        below = zeros if j == last else _to(bands[j + 1][:, :r, :], band.device)
        halo_copies += (j > 0) + (j < last)
        out.append(torch.cat([above, band, below], dim=1))
    return out


def _crop(ys: torch.Tensor, chunk: int, band: int, r: int, W: int) -> torch.Tensor:
    """The middle ``band`` rows of a haloed band's ``[n, K, (band+2r)*W]``
    output: the dropped rows read the slab's synthetic border."""
    K = ys.shape[1]
    return ys.reshape(chunk, K, band + 2 * r, W)[:, :, r:r + band, :].reshape(chunk, K, band * W)


def shard_apps_rows(fn: Callable, mesh: Mesh, radius: int) -> Callable:
    """A batched *fused* executor ``fn(configs, ingests, images)`` over a
    2-D ``(app, rows)`` mesh: apps shard N as in :func:`shard_apps`, rows
    shard the frame into contiguous bands.  Each shard runs the UNCHANGED
    executor on its haloed band (a ``[n, band + 2r, W]`` short frame) and
    keeps the middle ``band`` output rows; the output's flat pixel axis is
    row-major, so the bands concatenate back into ``[N, K, H * W]``.
    Callers pad H to ``band * rows`` with ``band >= radius`` first
    (``plan._with_mesh_padding``), so one single-hop exchange suffices.
    The settings banks go to every shard's device as plain copies (the
    reference's partitioner workaround has no counterpart here)."""
    r = int(radius)

    def sharded(configs, ingests, images):
        n, H, W = images.shape
        chunk, band = _check_split(n, H, mesh, r)
        outs = []
        for i, row in enumerate(mesh.devices):
            lo, hi = i * chunk, (i + 1) * chunk
            haloed = halo_exchange_rows(
                [_block(images, mesh, i, j, chunk, band) for j in range(len(row))], r)
            ys = []
            for d, slab in zip(row, haloed):
                with on_device(d):
                    cfg, ing = _tree_map(lambda t: replica(t, d, lo, hi), (configs, ingests))
                    ys.append(_crop(fn(cfg, ing, slab), chunk, band, r, W))
            outs.append(_gather(ys, mesh.first, 2))
        return torch.cat(outs, dim=0)

    return sharded


def _band_mask(hw: torch.Tensor, row0: int, band: int, W: int) -> torch.Tensor:
    """``[n, band, W]``: which pixels of a band (global rows ``row0 +
    arange(band)``) lie inside each app's true frame ``hw``."""
    rows = row0 + torch.arange(band, dtype=torch.int32, device=hw.device)
    cols = torch.arange(W, dtype=torch.int32, device=hw.device)
    return (rows[None, :, None] < hw[:, 0][:, None, None]) & \
        (cols[None, None, :] < hw[:, 1][:, None, None])


def shard_pipeline_rows(stage_fn: Callable, mesh: Mesh, radii) -> Callable:
    """Row-band sharding of a depth-S chain ``fn(stage_settings, hw,
    images)``: the 2-D twin of :func:`shard_apps_rows` with a halo
    exchange at each stage's own radius, so a chain's intermediates never
    leave their shard.  ``stage_fn(radius, configs, ingests, x)`` runs one
    stage on a haloed band; after every stage but the last the band's
    forwarded channel is masked by each app's true frame ``hw`` at the
    band's GLOBAL rows (``j * band + arange(band)``) and columns -- without
    the mask, outputs on canvas padding would reach the next stage's
    border, which the single-device chain reads as zeros.  Callers pad H
    to ``band * rows`` with ``band >= max(radii)`` first
    (``plan._with_mesh_padding``)."""
    from repro_torch.core.interpreter import forward_stage_output

    radii = tuple(int(r) for r in radii)
    depth = len(radii)

    def sharded(stage_settings, hw, images):
        n, H, W = images.shape
        chunk, band = _check_split(n, H, mesh, max(radii))
        outs = []
        for i, row in enumerate(mesh.devices):
            lo, hi = i * chunk, (i + 1) * chunk
            settings, valid = [], []
            for j, d in enumerate(row):
                with on_device(d):
                    settings.append(_tree_map(lambda t: replica(t, d, lo, hi), stage_settings))
                    valid.append(_band_mask(replica(hw, d, lo, hi), j * band, band, W))
            x = [_block(images, mesh, i, j, chunk, band) for j in range(len(row))]
            ys = []
            for si, r in enumerate(radii):
                haloed = halo_exchange_rows(x, r)
                ys, nxt = [], []
                for j, (d, slab) in enumerate(zip(row, haloed)):
                    with on_device(d):
                        configs, ingests, out_ch = settings[j][si]
                        y = _crop(stage_fn(r, configs, ingests, slab), chunk, band, r, W)
                        ys.append(y)
                        if si < depth - 1:
                            nxt.append(forward_stage_output(y, out_ch, valid[j]))
                x = nxt
            outs.append(_gather(ys, mesh.first, 2))
        return torch.cat(outs, dim=0)

    return sharded
