"""Sharding plans: the LM's over a ``torch.distributed`` device mesh, and
the overlay's frame operand.

Twin of the reference package's ``parallel/sharding.py``.  LM mesh axes:
``("data", "model")`` single-pod (16 x 16) or ``("pod", "data",
"model")`` multi-pod (2 x 16 x 16).  Roles:

  batch          -> ("pod", "data")   pure DP across pods + within pod
  tensor/TP      -> "model"           heads, mlp hidden, vocab, experts (EP)
  KV seq (serve) -> "model"           long caches sequence-sharded
  ZeRO-1         -> optimizer moments additionally sharded over "data"

Attention TP picks per arch (divisibility against |model|):
  * head-sharding (Megatron) when q AND kv head counts divide,
  * query-head sharding when the queries of a group divide,
  * sequence-parallel attention (train) / head_dim-sharding (decode)
    otherwise, replicate as last resort.

The plan is computed from the *abstract* parameter tree (path + shape
rules, ``LM.abstract_params()`` on ``meta``) and reads only
``mesh.shape`` and ``mesh.axis_names``, so a shape-only mesh plans a
256-card world without a process group.  A spec is a :class:`P`, a tuple
of axis names (None, a name, or a tuple of names per tensor dim) that
compares equal to the reference's ``PartitionSpec`` entry by entry;
:func:`placements` turns one into DTensor placements over a real
``DeviceMesh``.

:func:`frame_sharding` is the overlay's part: which device holds which
``(app, row-band)`` block of a fused dispatch's frame canvas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.axes import (
    Mesh, ShardedFrames, axis_sizes, from_block, local_block, placements,
)
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten_like

MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: per tensor dim, None (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, major first).
    A tuple, so ``P("model", None) == ("model", None)``; the trees of
    specs treat it as a leaf (:func:`is_spec`)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def model_size(mesh) -> int:
    return axis_sizes(mesh)[MODEL_AXIS]


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _dtotal(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def _pathstr(path) -> str:
    return "/".join(str(k) for k in path)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh``: where a tensor's blocks live."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def place(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` laid out by ``sharding``.  A plain tensor is the full value,
    the same on every rank (a seeded init, a checkpoint, a deterministic
    batch): each rank keeps its own block, with no communication.  A
    DTensor is redistributed."""
    want = sharding.placements
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == want else t.redistribute(sharding.mesh, want)
    return distribute_tensor(t.detach(), sharding.mesh, want, src_data_rank=None)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed (:func:`place`) by its
    :class:`NamedSharding` in ``shardings`` (a tree of the same structure)."""
    return unflatten_like(tree, [place(t, s) for t, s in
                                 zip(leaves(tree), leaves(shardings, is_leaf=is_sharding))])


def abstract_placed(tree, shardings):
    """``tree``'s shapes and dtypes as DTensors on ``meta`` laid out by
    ``shardings``, each built from this rank's block alone (no global
    tensor, nothing allocated): the operands of a dry run."""
    def one(t: torch.Tensor, s: NamedSharding) -> DTensor:
        layout = s.placements
        shape, _ = local_block(t.shape, s.mesh, layout)
        return from_block(torch.empty(shape, dtype=t.dtype, device="meta"), s.mesh, layout,
                          t.shape)

    return unflatten_like(tree, [one(t, s) for t, s in
                                 zip(leaves(tree), leaves(shardings, is_leaf=is_sharding))])


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    cfg: ArchConfig
    mesh: object             # a DeviceMesh, or anything with .shape and .axis_names
    attn_mode: str           # heads | qheads | seq | head_dim | replicate
    zero1: bool = True
    fsdp: bool = True        # shard otherwise-replicated big weights over
    #                          'data' (ZeRO-3-lite: gathered at use)
    fsdp_min_size: int = 65536

    # -- parameter specs ----------------------------------------------------

    def _rule(self, pathstr: str, shape: Tuple[int, ...]) -> P:
        m = model_size(self.mesh)
        cfg = self.cfg

        def mdl(n: int):
            return MODEL_AXIS if _div(n, m) else None

        # embeddings -----------------------------------------------------
        if pathstr.endswith("embed/table"):
            return P(mdl(shape[0]), None)
        if pathstr.endswith("embed/unembed"):
            return P(None, mdl(shape[1]))
        if pathstr.endswith("meta"):
            return P(None, None)

        # attention (3D/4D weights) ---------------------------------------
        if "/attn/" in pathstr:
            name = pathstr.rsplit("/", 1)[-1]
            if self.attn_mode == "heads":
                if name == "wq":   # [D, G, Hg, hd]
                    return P(None, MODEL_AXIS, None, None)
                if name in ("wk", "wv"):  # [D, G, hd]
                    return P(None, MODEL_AXIS, None)
                if name == "wo":   # [G, Hg, hd, D]
                    return P(MODEL_AXIS, None, None, None)
            if self.attn_mode == "qheads":
                # Megatron on query heads only; tiny K/V projs replicated
                if name == "wq":
                    return P(None, None, MODEL_AXIS, None)
                if name == "wo":
                    return P(None, MODEL_AXIS, None, None)
                return P(*([None] * len(shape)))
            if self.attn_mode == "head_dim":
                if name == "wq":
                    return P(None, None, None, MODEL_AXIS)
                if name in ("wk", "wv"):
                    return P(None, None, MODEL_AXIS)
                if name == "wo":
                    return P(None, None, MODEL_AXIS, None)
            # 'seq' / 'replicate': weights replicated (seq mode parallelises
            # over the sequence via activation constraints instead)
            return P(*([None] * len(shape)))

        # MoE ---------------------------------------------------------------
        if "/moe/" in pathstr and "/shared/" not in pathstr:
            name = pathstr.rsplit("/", 1)[-1]
            E = cfg.moe.num_experts
            if name == "router":
                return P(None, None)
            if name in ("w_gate", "w_up") and len(shape) == 3:  # [E, D, F]
                return P(mdl(E), None, None if _div(E, m) else mdl(shape[2]))
            if name == "w_down" and len(shape) == 3:            # [E, F, D]
                return P(mdl(E), None if _div(E, m) else mdl(shape[1]), None)
        # shared-expert MLP falls through to the dense mlp rules below

        # dense MLP (also shared experts) -----------------------------------
        name = pathstr.rsplit("/", 1)[-1]
        if name in ("w_gate", "w_up") and len(shape) == 2:  # [D, F]
            return P(None, mdl(shape[1]))
        if name == "w_down" and len(shape) == 2:            # [F, D]
            return P(mdl(shape[0]), None)

        # xLSTM / hymba recurrent mixers: column TP fights their head-grouped
        # reshapes, so they are replicated over 'model' (the FSDP fallback
        # shards them over 'data'); the model axis becomes extra batch
        # parallelism inside the mixers (axes.constrain_time_mixer).
        if ":mlstm/" in pathstr or ":slstm/" in pathstr:
            return P(*([None] * len(shape)))
        if name in ("ssm_in", "ssm_out"):
            return P(None, None)

        return P(*([None] * len(shape)))

    def _fsdp_fallback(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Large fully-replicated weights -> shard one dim over 'data'."""
        if not self.fsdp or any(a is not None for a in spec):
            return spec
        if math.prod(shape) < self.fsdp_min_size or len(shape) < 2:
            return spec
        dsize = _dtotal(self.mesh)
        daxes = data_axes(self.mesh)
        parts = list(spec)
        for i, dim in enumerate(shape):
            if _div(dim, dsize):
                parts[i] = daxes if len(daxes) > 1 else daxes[0]
                return P(*parts)
        return spec

    def param_specs(self, abstract_params):
        """A tree of :class:`P` in the parameters' structure."""
        def spec(path, leaf) -> P:
            pathstr = _pathstr(path)
            shape = tuple(leaf.shape)
            if "blocks/" in pathstr:  # stacked: leading n_superblocks dim
                body = shape[1:]
                return P(None, *self._fsdp_fallback(self._rule(pathstr, body), body))
            return self._fsdp_fallback(self._rule(pathstr, shape), shape)

        return unflatten_like(abstract_params, [spec(path, leaf) for path, leaf
                                                in flatten_with_path(abstract_params)])

    def param_shardings(self, abstract_params):
        return tree_map(lambda s: NamedSharding(self.mesh, s),
                        self.param_specs(abstract_params), is_leaf=is_spec)

    # -- optimizer (ZeRO-1): moments get an extra 'data' dim where free ------

    def opt_specs(self, abstract_params):
        pspecs = self.param_specs(abstract_params)
        dsize = _dtotal(self.mesh)
        daxes = data_axes(self.mesh)

        def zero1(leaf, ps: P) -> P:
            if not self.zero1:
                return ps
            parts = list(ps) + [None] * (len(leaf.shape) - len(ps))
            # 'data' may appear at most once in a spec (FSDP may have used it)
            used = {ax for a in parts for ax in (a if isinstance(a, tuple) else (a,))
                    if ax is not None}
            if set(daxes) & used:
                return P(*parts)
            for i, (dim, cur) in enumerate(zip(leaf.shape, parts)):
                if cur is None and _div(dim, dsize) and dim >= dsize:
                    parts[i] = daxes if len(daxes) > 1 else daxes[0]
                    break
            return P(*parts)

        moment = unflatten_like(abstract_params, [
            zero1(leaf, ps) for (_, leaf), (_, ps) in
            zip(flatten_with_path(abstract_params),
                flatten_with_path(pspecs, is_leaf=is_spec))])
        return {"m": moment, "v": moment, "count": P()}

    def opt_shardings(self, abstract_params):
        return tree_map(lambda s: NamedSharding(self.mesh, s),
                        self.opt_specs(abstract_params), is_leaf=is_spec)

    # -- activations / inputs -------------------------------------------------

    def batch_spec(self, ndim: int) -> P:
        da = data_axes(self.mesh)
        lead = da if len(da) > 1 else da[0]
        return P(lead, *([None] * (ndim - 1)))

    def token_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.batch_spec(2))

    # -- decode cache ----------------------------------------------------------

    def cache_specs(self, abstract_cache, seq_shard_min: int = 8192):
        """KV caches: batch -> data, long sequence dims -> model;
        GLA/SSM states: batch -> data, state dv -> model where divisible."""
        m = model_size(self.mesh)
        da = data_axes(self.mesh)
        lead = da if len(da) > 1 else da[0]

        def spec(path, leaf) -> P:
            pathstr = _pathstr(path)
            shape = tuple(leaf.shape)
            stacked = "blocks/" in pathstr
            body = shape[1:] if stacked else shape
            name = pathstr.rsplit("/", 1)[-1]
            bspec = lead if body and body[0] % _dtotal(self.mesh) == 0 else None
            if name in ("k", "v"):        # [B, S, G, hd]
                S = body[1]
                sspec = MODEL_AXIS if (S >= seq_shard_min and _div(S, m)) else None
                inner = P(bspec, sspec, None, None)
            elif name == "S":             # [B, H, dk, dv]
                inner = P(bspec, None, None, MODEL_AXIS if _div(body[-1], m) else None)
            elif name in ("n", "c", "h"):  # [B, H, d]
                inner = P(bspec, None, None)
            elif name == "conv":          # [B, K-1, inner]
                inner = P(bspec, None, None)
            else:
                inner = P(*([None] * len(body)))
            return P(None, *inner) if stacked else inner

        return unflatten_like(abstract_cache, [spec(path, leaf) for path, leaf
                                               in flatten_with_path(abstract_cache)])

    def cache_shardings(self, abstract_cache, seq_shard_min: int = 8192):
        return tree_map(lambda s: NamedSharding(self.mesh, s),
                        self.cache_specs(abstract_cache, seq_shard_min), is_leaf=is_spec)


def choose_attn_mode(cfg: ArchConfig, mesh, kind: str = "train") -> str:
    """Per-arch attention TP selection:

    * heads     KV-head Megatron TP -- only when q AND kv heads divide;
    * qheads    query-head Megatron TP, K/V projections replicated --
                when queries-per-group divides (e.g. glm4 Hg=16);
    * seq       sequence-parallel attention (replicated weights, queries
                sharded along S) -- train/prefill fallback;
    * head_dim  contraction TP -- decode only (scores are [.., 1, S]);
    * replicate last resort.
    """
    m = model_size(mesh)
    if _div(cfg.num_heads, m) and _div(cfg.num_kv_heads, m):
        return "heads"
    if _div(cfg.num_heads // cfg.num_kv_heads, m):
        return "qheads"
    if kind == "decode":
        return "head_dim" if _div(cfg.head_dim, m) else "replicate"
    return "seq"


def make_plan(cfg: ArchConfig, mesh, zero1: bool = True,
              attn_mode: Optional[str] = None, kind: str = "train") -> ShardingPlan:
    return ShardingPlan(cfg, mesh, attn_mode or choose_attn_mode(cfg, mesh, kind), zero1=zero1)


# -- overlay-mesh operand shardings (the VCGRA dispatch pipeline) --------------


@dataclasses.dataclass(frozen=True)
class Block:
    """One block of a sharded canvas: app shard ``i``'s row band ``j``,
    the canvas slices it covers and the device that holds it."""

    i: int
    j: int
    device: torch.device
    apps: slice
    rows: slice


@dataclasses.dataclass(frozen=True)
class FrameSharding:
    """The layout of a fused canvas ``[N, H, W]`` on a mesh: app-sharded
    on a 1-D ``("app",)`` mesh, app x row-band sharded on a 2-D
    ``("app", "rows")`` mesh -- the split the mesh executables make, so a
    canvas shipped block by block reaches them with no further copy."""

    mesh: Mesh

    def blocks(self, n: int, H: int) -> Iterator[Block]:
        """The blocks of an ``[n, H, W]`` canvas, app-major.  ``n`` must be
        a multiple of the app width and ``H`` of the row width."""
        app, rows = self.mesh.app, self.mesh.rows
        if n % app or H % rows:
            raise ValueError(f"a [{n}, {H}, W] canvas does not split over a {app}x{rows} mesh")
        chunk, band = n // app, H // rows
        for i, row in enumerate(self.mesh.devices):
            for j, d in enumerate(row):
                yield Block(i, j, d, slice(i * chunk, (i + 1) * chunk),
                            slice(j * band, (j + 1) * band))

    def assemble(self, shape: Tuple[int, int, int],
                 tensors: Sequence[torch.Tensor]) -> ShardedFrames:
        """The canvas from its block tensors, given in :meth:`blocks` order."""
        rows = self.mesh.rows
        grid = tuple(tuple(tensors[i * rows:(i + 1) * rows]) for i in range(self.mesh.app))
        return ShardedFrames(grid, tuple(shape))


def frame_sharding(mesh: Mesh) -> FrameSharding:
    """The :class:`FrameSharding` of a fused dispatch's frame operand on
    ``mesh`` (``parallel.axes.build_mesh``)."""
    return FrameSharding(mesh)
