"""Wrapper of the Hopper flash decode kernel (B7).

``decode_attention`` keeps the reference's signature and layout
(``repro/kernels/flash_attention/ops.py``): q ``[B, H, D]`` over a k/v
cache ``[B, S, G, D]`` with per-sequence valid ``lengths``, returned as
``[B, H, D]`` in q's dtype.  Given CPU tensors it computes the plain
version (``ref.decode_ref``); for CUDA tensors it launches
``csrc/flash_decode.cu`` on PyTorch's current stream or raises, counting
each launch in :data:`LAUNCHES`.

``chunk`` is the reference's VMEM tile along S and keeps its contract
(``S % chunk == 0``).  The Hopper kernel cuts S into splits of its own,
one block each, sized from the shape so the card holds enough blocks
(:func:`split_length`); neither length changes the function, only the
float32 summation order.

Two bodies compute a split (``csrc/flash_decode.cu``), picked by
:func:`tensor_core_route` from the cache's dtype, the heads a group and
the head dim: the tensor-core body (a bf16 cache) or the CUDA-core body (a
float32 cache, or a head dim the tensor cores do not take).  The choice is
explicit; a launch failure of either raises.

B7 is a torch op, ``repro_torch::flash_decode``: the kernel on CUDA
tensors, ``ref.decode_ref`` on CPU tensors, an output of q's shape on
``meta`` and fake tensors (so a census or a dry run passes through it),
and a census formula (:func:`census_op_cost`, which
``roofline.hlo_analysis`` reads).  Its sequence-split entry,
``repro_torch::flash_decode_split`` (:func:`decode_attention_split`),
attends over one block of a cache whose rows are split over a mesh and
returns the float32 output with its log-sum-exp; :func:`merge_splits`
merges the ranks' blocks with functional collectives, ``ref.merge_ref``
merges a list of them.  Its v may be a column block of the cache's v (``Dv``
of its ``D`` columns, a divisor, as a view strided as k: no copy): the
scores run over k's whole head dim, the weighted sum and the output over
those columns, on the CUDA-core body (:func:`tensor_core_route`).  Plain
CUDA tensors, the serving path's, launch the kernel without the op's
dispatch (:func:`_direct`).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import ref

#: Launches of the kernel since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"flash_decode": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Rows per split never below this, so a block's warps have rows to share.
MIN_SPLIT = 64
#: Blocks to aim for on each SM of the card.
BLOCKS_PER_SM = 16
#: Rows of one ring stage of the tensor-core body (16 for each of its 4
#: warps); :data:`MIN_SPLIT` and every split are multiples of it.
TC_ROWS = 64
#: Head dims and most heads a group the tensor-core body takes.
TC_HEAD_DIMS = (16, 32, 64, 128, 256)
TC_MAX_HEADS = 16
#: Shared memory one block may take on the H100 (bytes).
MAX_SMEM_BYTES = 232_448


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q, k, v, lengths, chunk, columns: bool = False) -> Tuple[int, int, int, int, int]:
    """``(B, H, D, S, G)`` of a call; with ``columns`` v may hold ``Dv``
    columns of the cache's head dim, a divisor of ``D``."""
    if (q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]
            or not (v.shape[3] == k.shape[3] or columns and v.shape[3] >= 1
                    and k.shape[3] % v.shape[3] == 0)):
        want = "v [B, S, G, Dv], Dv dividing D" if columns else "v [B, S, G, D]"
        raise ValueError(f"q must be [B, H, D], k [B, S, G, D] and {want}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    _, S, G, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got {tuple(lengths.shape)}")
    if H % G:
        raise ValueError(f"{H} query heads not divisible into {G} KV groups")
    if S < 1:
        raise ValueError("the cache has no rows (S = 0)")
    if chunk < 1 or S % chunk:
        raise ValueError(f"cache len {S} not a multiple of chunk {chunk}")
    return B, H, D, S, G


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tensor_core_route(kv_dtype: torch.dtype, Hg: int, D: int, Dv: int = None) -> bool:
    """True where the tensor-core body computes the split: a bf16 cache,
    ``D`` in :data:`TC_HEAD_DIMS`, at most :data:`TC_MAX_HEADS` query heads
    a group and v's whole head dim (``Dv`` None or ``D``); else the
    CUDA-core body does, a column block of v included."""
    return (kv_dtype == torch.bfloat16 and D in TC_HEAD_DIMS and 1 <= Hg <= TC_MAX_HEADS
            and Dv in (None, D))


def tc_smem_bytes(q_dtype: torch.dtype, Hg: int, D: int) -> int:
    """Dynamic shared memory of one tensor-core block: a ring of 3 stages
    of :data:`TC_ROWS` k and v rows of ``D`` bf16, then q's mma fragments
    (three bf16 parts of a float32 q, one of a bf16 q, for each group of 8
    heads)."""
    q_parts = 3 if q_dtype == torch.float32 else 1
    head_tiles = -(-Hg // 8)
    return 3 * 2 * TC_ROWS * D * 2 + q_parts * head_tiles * (D // 16) * 32 * 8


def split_length(B: int, S: int, G: int, sm_count: int, max_splits: int) -> int:
    """Rows of S per block: a power of two, at least :data:`MIN_SPLIT`,
    small enough that ``B * G * ceil(S / split)`` fills
    :data:`BLOCKS_PER_SM` blocks per SM where the shape allows, and large
    enough for at most ``max_splits`` splits."""
    rows_per_block = -(-B * G * S // (BLOCKS_PER_SM * sm_count))
    split = MIN_SPLIT
    while (split < rows_per_block and split < S) or -(-S // split) > max_splits:
        split *= 2
    return split


def census_cost(B: int, H: int, G: int, D: int, rows: int, itemsize: int,
                Dv: int = None) -> Tuple[float, float]:
    """(operations, bytes) of one B7 call over ``rows`` cache rows in all,
    v's ``Dv`` columns (``D`` by default) read: q, those k rows, their v
    columns and the output moved once (in the cache's itemsize) and the
    int32 lengths, and 2 D operations (a multiply-add each) for the score
    and 2 Dv for the weighted sum per row and query head."""
    Dv = D if Dv is None else Dv
    return (2.0 * (D + Dv) * H * rows,
            float(B * H * (D + Dv) * itemsize + rows * G * (D + Dv) * itemsize + 4 * B))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
            split_entry: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7 on the card: ``(out, lse)``, out like q and lse None; with
    ``split_entry`` a float32 out ``[B, H, Dv]`` over v's ``Dv`` columns and
    the float32 log-sum-exp ``[B, H]``."""
    B, H, D = q.shape
    _, S, G, _ = k.shape
    Dv = v.shape[3]
    if {q.device, k.device, v.device, lengths.device} != {q.device} or q.device.type != "cuda":
        raise ValueError("the Hopper kernel runs on CUDA tensors on one device; got q "
                         f"{q.device}, k {k.device}, v {v.device}, lengths {lengths.device}")
    if (q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or v.dtype != k.dtype
            or (q.dtype == torch.bfloat16 and k.dtype != torch.bfloat16)):
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}; the kernel takes a float32 or "
                        "bfloat16 cache (k and v alike) with float32 q, or bfloat16 q over a "
                        "bfloat16 cache")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and lengths.is_contiguous()
            and (v.is_contiguous() if Dv == D else v.stride() == k.stride())):
        raise ValueError("q, k, v and lengths must be contiguous (v may be a column block of "
                         "a tensor strided as k)")
    vec = 1 if D <= 32 else D // 32
    if vec * 32 != max(D, 32) or vec not in (1, 2, 4, 8):
        raise ValueError(f"head dim {D}; the kernel takes D <= 32, 64, 128 or 256")
    Hg = H // G
    lib = load_library("flash_decode")
    tensor_cores = tensor_core_route(k.dtype, Hg, D, Dv)
    if not tensor_cores and not lib.flash_decode_supported(Hg, vec):
        raise ValueError(f"{Hg} query heads per KV group at D={D}: the kernel takes at most "
                         "16 heads a group, rounded up to a power of two, times D <= 2048")
    if B > 65535 or G > 65535:
        raise ValueError(f"B={B}, G={G}: the launch grid takes at most 65535 of each")
    align = 16 if tensor_cores else vec * k.element_size()
    v_align = align if Dv >= vec else k.element_size()  # fewer: element by element
    if k.data_ptr() % align or v.data_ptr() % v_align:
        raise ValueError(f"k and v must be {align}- and {v_align}-byte aligned for the "
                         "kernel's vector loads")
    out = q.new_empty((B, H, Dv), dtype=torch.float32 if split_entry else q.dtype)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if split_entry else None
    if out.numel() == 0:
        return out, lse
    split = split_length(B, S, G, _sm_count(q.device.index or 0),
                         lib.flash_decode_max_splits())
    n_splits = -(-S // split)
    part_m = torch.empty((B, G, n_splits, Hg), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, G, n_splits, Hg, Dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_decode(
            int(tensor_cores), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], vec, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), B, S, G, Hg, D, Dv, split, n_splits,
            float(D ** -0.5), int(split_entry), 0 if lse is None else lse.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {rc}")
    LAUNCHES["flash_decode"] += 1
    return out, lse


# -- the torch ops: the CPU plain version, the CUDA kernel, a meta shape ---------


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(), device_types="cpu")
def flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """B7 as a torch op: the plain version on the CPU (registered below: the
    kernel on CUDA, a shape on meta and fake tensors)."""
    return ref.decode_ref(q, k, v, lengths)


@flash_decode_op.register_kernel("cuda")
def _flash_decode_cuda(q, k, v, lengths):
    return _launch(q, k, v, lengths, split_entry=False)[0]


@flash_decode_op.register_fake
def _flash_decode_fake(q, k, v, lengths):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode_split", mutates_args=(), device_types="cpu")
def flash_decode_split_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, r0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's sequence-split entry as a torch op: k/v hold global rows ``r0 ..
    r0 + S - 1`` (v all of the head dim or a column block) and ``lengths``
    count global rows."""
    return ref.decode_partial_ref(q, k, v, lengths, r0)


@flash_decode_split_op.register_kernel("cuda")
def _flash_decode_split_cuda(q, k, v, lengths, r0):
    rows = (lengths - r0).clamp(0, k.shape[1]).to(torch.int32)
    return _launch(q, k, v, rows, split_entry=True)


@flash_decode_split_op.register_fake
def _flash_decode_split_fake(q, k, v, lengths, r0):
    return (q.new_empty((*q.shape[:2], v.shape[3]), dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def census_op_cost(q, k, v, lengths, r0=None) -> Tuple[float, float]:
    """(operations, bytes) of one call of either B7 op over all of its S
    rows and v's columns, as the reference's einsum decode reads them; the
    split entry also writes its float32 log-sum-exp."""
    B, H, D = q.shape
    ops, nbytes = census_cost(B, H, k.shape[2], D, B * k.shape[1], k.element_size(),
                              v.shape[3])
    return ops, nbytes + (0.0 if r0 is None else 4.0 * B * H)


def _direct(*tensors: torch.Tensor) -> bool:
    """Whether B7 may launch without the op's dispatch: plain CUDA tensors
    and no dispatch mode (a census) active.  The main serving path takes
    this route; meta, fake and CPU tensors and DTensors go through the op."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return (all(type(t) is torch.Tensor and t.is_cuda for t in tensors)
            and _get_current_dispatch_mode() is None)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """GQA decode attention: q ``[B, H, D]`` over cache k/v ``[B, S, G, D]``
    masked to each sequence's first ``lengths[b]`` rows."""
    _check(q, k, v, lengths, chunk)
    if _direct(q, k, v, lengths):
        return _launch(q, k, v, lengths, split_entry=False)[0]
    return flash_decode_op(q, k, v, lengths)


def decode_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, r0: int,
                           chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequence-split entry: q ``[B, H, D]`` over one block of a cache,
    k ``[B, S, G, D]`` and v ``[B, S, G, Dv]`` holding its global rows ``r0
    .. r0 + S - 1`` (v all of the head dim, ``Dv = D``, or a column block of
    it, ``Dv`` a divisor of ``D``, as a view strided as k), each sequence
    masked to ``clamp(lengths[b] - r0, 0, S)`` rows.  Returns the float32
    output ``[B, H, Dv]`` normalised over the block's rows and the
    float32 log-sum-exp ``[B, H]`` of the scaled scores over them (-inf,
    and an output of 0, where a sequence has none): what :func:`merge_splits`
    and ``ref.merge_ref`` merge."""
    _check(q, k, v, lengths, chunk, columns=True)
    if _direct(q, k, v, lengths):
        return _flash_decode_split_cuda(q, k, v, lengths, int(r0))
    return flash_decode_split_op(q, k, v, lengths, int(r0))


def merge_splits(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """This rank's block ``(out, lse)`` of :func:`decode_attention_split`
    merged with the other blocks of the process group ``group`` (a
    ``(DeviceMesh, dim)``): an all-gather of the lse, the weights
    ``exp(lse_i - max)``, and an all-reduce of the weighted outputs, all
    functional collectives.  Returns the float32 merged output."""
    import torch.distributed._functional_collectives as funcol

    lses = funcol.all_gather_tensor(lse, gather_dim=0, group=group)
    lses = lses.reshape(-1, *lse.shape)
    top = lses.amax(dim=0)
    w_all = _weights(lses, top)
    w = _weights(lse, top)
    num = funcol.all_reduce(out * w[..., None], "sum", group)
    return num / w_all.sum(dim=0).clamp_min(1e-30)[..., None]


def _weights(lse: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """exp(lse - top), 0 for a block with no valid row (lse = -inf)."""
    empty = torch.isneginf(lse)
    return torch.where(empty, 0.0, torch.exp(torch.where(empty, 0.0, lse - top)))
