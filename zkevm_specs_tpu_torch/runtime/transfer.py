"""The block verifier's transfer path: one upload of every input leaf, and
one gather of every verdict.

Counterpart of ``zkevm_specs_tpu/runtime/block.py:_ship_leaves`` (:61-115)
and of the verdict concatenation of ``make_combined`` (:514-519), with two
kernels:

* K9 ``leaf_unpack`` (``csrc/leaf_unpack.cu``): the leaves travel
  concatenated per source kind in a few pinned host buffers, one
  non-blocking copy each, and one launch writes every leaf, widened to its
  port type, into one device arena; the leaves are views of the arena;
* K10 ``verdict_pack`` (``csrc/verdict_pack.cu``): the fail vectors of a
  device pass gathered into one flat ``uint8`` buffer, each at a 16-byte
  aligned offset, by a device table of addresses, lengths, offsets and
  first blocks.

Narrowing follows ``_ship_leaves`` (:84-89) by one rule on the port type:
every leaf that lands as int64 (limbs and words, whether int64 tensors or
numpy ``uint32`` arrays, index orders, u64 fingerprints as their int64
bits) travels as u8 or u16 when its data lies in [0, 2^16), and comes back
as int64.  That covers the leaves the JAX package narrows (its ``uint32``
limbs and words) and, losslessly, the small index orders it ships wide.
Every other leaf keeps its port type, as ``convert.to_device`` gives it:
int32 as it is, bool and uint8 as one byte.  So ``upload(leaves)[i]``
equals ``to_device(leaves[i])`` element for element.
"""
from __future__ import annotations

import ctypes
from itertools import accumulate
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import limbs as L

# source buffers, by kind
SRC_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.int64)  # u16 staged as int16 bits
_SRC_NP = (np.uint8, np.uint16, np.int32, np.int64)
U8, U16, I32, I64 = range(4)
# destination kinds: int64, int32, one byte (bool or uint8)
DST_I64, DST_I32, DST_BYTE = range(3)
_DST_SIZE = (8, 4, 1)
ALIGN = 256          # byte alignment of each leaf in the arena (cudaMalloc's)
CHUNK = 4096         # elements a K9 block copies (csrc/leaf_unpack.cu)


class UploadPlan:
    """Where each leaf travels: the host staging buffers by source kind, the
    segment table (source kind, source offset, count, destination kind,
    destination byte offset) and each leaf's destination dtype and shape."""

    def __init__(self, leaves: Sequence[object]):
        parts: List[List[np.ndarray]] = [[] for _ in range(4)]
        sizes = [0, 0, 0, 0]
        segs, self.views = [], []
        dst_off = 0
        self.wide_bytes = 0   # what to_device would copy: every leaf at its port type
        for leaf in leaves:
            src, dst_kind, dtype = _classify(leaf)
            a = src.ravel()
            kind = _SRC_NP.index(a.dtype.type)
            segs.append((kind, sizes[kind], a.size, dst_kind, dst_off))
            self.views.append((dst_off, dtype, tuple(src.shape)))
            parts[kind].append(a)
            sizes[kind] += a.size
            nbytes = a.size * _DST_SIZE[dst_kind]
            self.wide_bytes += nbytes
            dst_off += (nbytes + ALIGN - 1) // ALIGN * ALIGN
        self.arena_bytes = max(dst_off, 1)
        self.host = [np.concatenate(p) if p else np.zeros(0, dt)
                     for p, dt in zip(parts, _SRC_NP)]
        self.segs = np.asarray(segs, dtype=np.int64).reshape(-1, 5)
        counts = (self.segs[:, 2] + CHUNK - 1) // CHUNK
        seg_of = np.repeat(np.arange(len(segs), dtype=np.int64), counts)
        first = np.repeat(np.cumsum(counts) - counts, counts)
        chunks = np.stack([seg_of, (np.arange(seg_of.size) - first) * CHUNK], axis=1)
        self.table = np.concatenate([self.segs.ravel(), chunks.ravel()]).astype(np.int64)
        self.n_chunks = int(seg_of.size)
        self.narrow_bytes = sum(h.nbytes for h in self.host) + self.table.nbytes


def _classify(leaf) -> Tuple[np.ndarray, int, torch.dtype]:
    """(host array as staged, destination kind, port dtype) of one leaf: a
    leaf that lands as int64 is staged as u8 or u16 when its data allows."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise ValueError("upload: leaves must lie on the host")
        leaf = leaf.contiguous().numpy()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype == np.int32:
        return arr, DST_I32, torch.int32
    if arr.dtype in (np.bool_, np.uint8):
        return arr.view(np.uint8), DST_BYTE, (torch.bool if arr.dtype == np.bool_ else torch.uint8)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    elif arr.dtype != np.int64:
        raise TypeError(f"upload: unsupported leaf dtype {arr.dtype}")
    if arr.size and arr.min() >= 0 and arr.max() < (1 << 16):
        return arr.astype(np.uint8 if arr.max() < (1 << 8) else np.uint16), DST_I64, torch.int64
    return arr, DST_I64, torch.int64


# ---------------------------------------------------------------------------
# K9: leaf_unpack
# ---------------------------------------------------------------------------

_DST_TORCH = (torch.int64, torch.int32, torch.uint8)


def leaf_unpack_plain(srcs: Sequence[torch.Tensor], table: torch.Tensor, n_seg: int,
                      arena_bytes: int) -> torch.Tensor:
    """Plain version of K9: per leaf, ``src[off:off+n].to(dtype)`` written
    at its place in the arena (the alignment gaps stay unwritten)."""
    arena = torch.empty(arena_bytes, dtype=torch.uint8, device=table.device)
    for kind, off, n, dst_kind, dst_off in table[:5 * n_seg].view(-1, 5).tolist():
        src = srcs[kind][off:off + n]
        if kind == U16:
            src = src.to(torch.int64) & 0xFFFF
        size = _DST_SIZE[dst_kind]
        arena[dst_off:dst_off + n * size].view(_DST_TORCH[dst_kind]).copy_(
            src.to(_DST_TORCH[dst_kind]))
    return arena


def leaf_unpack(srcs: Sequence[torch.Tensor], table: torch.Tensor, n_seg: int,
                arena_bytes: int) -> torch.Tensor:
    """K9 wrapper: the arena (uint8, ``arena_bytes``) holding every leaf of
    the segment table widened to its destination kind; the alignment gaps
    between leaves are not written.

    ``srcs``: the four staging buffers (u8, u16 as int16 bits, int32,
    int64), empty where a kind is unused; ``table``: int64, the ``n_seg``
    segments (5 each) followed by the chunk table (segment, first element)
    of ``UploadPlan.table``.  Replaces ``_ship_leaves``'s jitted unpacker
    (``runtime/block.py:99-115``)."""
    if len(srcs) != 4 or any(s.dtype != dt or s.dim() != 1 or not s.is_contiguous()
                             for s, dt in zip(srcs, SRC_DTYPES)):
        raise ValueError("leaf_unpack: srcs must be contiguous 1-D u8, int16, int32, int64 buffers")
    if table.dtype != torch.int64 or table.dim() != 1 or (table.numel() - 5 * n_seg) % 2:
        raise ValueError("leaf_unpack: table must be a 1-D int64 segment + chunk table")
    if L.on_cpu(*srcs, table):
        return leaf_unpack_plain(srcs, table, n_seg, arena_bytes)
    from . import cuda_build

    arena = torch.empty(arena_bytes, dtype=torch.uint8, device=table.device)
    n_chunks = (table.numel() - 5 * n_seg) // 2
    lib = cuda_build.library("leaf_unpack")
    err = lib.leaf_unpack_launch(*(s.data_ptr() if s.numel() else None for s in srcs),
                                 table.data_ptr(), table[5 * n_seg:].data_ptr(), n_chunks,
                                 arena.data_ptr(), L.cuda_stream())
    L.check_launch(err, "leaf_unpack")
    return arena


def leaf_views(arena: torch.Tensor, plan: UploadPlan) -> List[torch.Tensor]:
    """Each leaf as a view of the arena, at its port dtype and shape."""
    out = []
    for (off, dtype, shape), (_, _, n, dst_kind, _) in zip(plan.views, plan.segs.tolist()):
        flat = arena[off:off + n * _DST_SIZE[dst_kind]].view(_DST_TORCH[dst_kind])
        out.append(flat.view(dtype).view(shape))
    return out


def stage(plan: UploadPlan, device) -> List[torch.Tensor]:
    """The plan's four source buffers and its table on ``device``: on a
    CUDA device through pinned host buffers, one non-blocking copy each on
    the current stream (the caller synchronises before the pinned buffers
    are released)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    staged = []
    for host, dt in zip(plan.host + [plan.table], list(SRC_DTYPES) + [torch.int64]):
        buf = torch.empty(host.size, dtype=dt, pin_memory=pin)
        buf.numpy()[:] = host.view(buf.numpy().dtype)
        staged.append(buf.to(device, non_blocking=True) if pin else buf)
    return staged


def upload(leaves: Sequence[object], device) -> Tuple[List[torch.Tensor], UploadPlan]:
    """Every host leaf on ``device`` through one staging copy per source
    kind and one K9 launch; returns the leaves (views of one arena) and
    the plan (for its byte counts)."""
    plan = UploadPlan(leaves)
    staged = stage(plan, device)
    arena = leaf_unpack(staged[:4], staged[4], len(plan.segs), plan.arena_bytes)
    return leaf_views(arena, plan), plan


# ---------------------------------------------------------------------------
# K10: verdict_pack
# ---------------------------------------------------------------------------

VERDICT_ALIGN = 16                 # each vector's offset in the packed buffer
VERDICT_BLOCK_BYTES = 256 * 16     # the bytes one block of K10 writes (its BLOCK_BYTES)
VERDICT_MAX_VECTORS = 1024         # K10 stages its first-block column in shared memory


def verdict_offsets(lengths: Sequence[int]) -> List[int]:
    """Each vector's offset in the packed buffer, and the buffer's size
    last: the lengths rounded up to 16 bytes, summed in order."""
    return list(accumulate((-(-n // VERDICT_ALIGN) * VERDICT_ALIGN for n in lengths), initial=0))


def verdict_blocks(lengths: Sequence[int]) -> List[int]:
    """Each vector's first block in K10's grid, and the grid's size last."""
    return list(accumulate((-(-n // VERDICT_BLOCK_BYTES) for n in lengths), initial=0))


def verdict_table(fails: Sequence[torch.Tensor]) -> torch.Tensor:
    """The host int64 table K10 reads: addresses, lengths, output offsets,
    first blocks."""
    lens = [f.numel() for f in fails]
    return torch.tensor([f.data_ptr() for f in fails] + lens + verdict_offsets(lens)[:-1]
                        + verdict_blocks(lens)[:-1], dtype=torch.int64)


def verdict_unpack(flat: np.ndarray, lengths: Sequence[int]) -> List[np.ndarray]:
    """The vectors of a packed buffer, in order."""
    return [flat[o:o + n] for o, n in zip(verdict_offsets(lengths), lengths)]


def verdict_pack_plain(fails: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K10: the vectors as 0/1 bytes, each from a 16-byte
    aligned offset, zeros between."""
    offs = verdict_offsets([f.numel() for f in fails])
    out = torch.zeros(offs[-1], dtype=torch.uint8, device=fails[0].device)
    for f, o in zip(fails, offs):
        out[o:o + f.numel()] = f.ravel().to(torch.uint8)
    return out


def verdict_pack(fails: Sequence[torch.Tensor], table: torch.Tensor = None) -> torch.Tensor:
    """K10 wrapper: the bool fail vectors packed into one ``uint8`` buffer,
    each at its 16-byte aligned ``verdict_offsets`` offset (read back with
    ``verdict_unpack``).  ``table``: the device copy of
    ``verdict_table(fails)``; when None it is uploaded here.  A CUDA-graph
    capture passes a table it fills after the capture, when the captured
    vectors' addresses are fixed; the grid depends on the lengths alone.
    Replaces ``make_combined``'s ``jnp.concatenate``
    (``runtime/block.py:518``)."""
    if not fails or any(f.dtype != torch.bool or f.dim() != 1 or not f.is_contiguous()
                        for f in fails):
        raise ValueError("verdict_pack: fails must be contiguous 1-D bool tensors")
    if L.on_cpu(*fails):
        return verdict_pack_plain(fails)
    if len(fails) > VERDICT_MAX_VECTORS:
        raise ValueError(f"verdict_pack: at most {VERDICT_MAX_VECTORS} vectors on the card")
    from . import cuda_build

    dev = fails[0].device
    if table is None:
        table = verdict_table(fails).to(dev)
    if table.dtype != torch.int64 or table.shape != (4 * len(fails),) or table.device != dev:
        raise ValueError("verdict_pack: table must be an int64 [4 * len(fails)] tensor on "
                         "the fails' device")
    lens = [f.numel() for f in fails]
    out = torch.empty(verdict_offsets(lens)[-1], dtype=torch.uint8, device=dev)
    lib = cuda_build.library("verdict_pack")
    err = lib.verdict_pack_launch(table.data_ptr(), len(fails), verdict_blocks(lens)[-1],
                                  out.data_ptr(), L.cuda_stream())
    L.check_launch(err, "verdict_pack")
    return out
