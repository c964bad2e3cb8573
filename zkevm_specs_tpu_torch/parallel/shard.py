"""Rows over ranks: the mesh, the sharded EVM group and the sharded state
circuit, on ``torch.distributed``.

Counterpart of ``zkevm_specs_tpu/parallel/shard.py``.  Witness rows are
data-parallel except for (a) the sorted-adjacency checks, which read a
one-row halo from the neighbouring ranks, and (b) the per-lane verdicts,
which every rank gathers.  Where the JAX package lets XLA place rows over a
``jax.sharding.Mesh`` and insert the collectives, each rank here checks its
own contiguous share of the rows on its own device and the collectives are
explicit: ``all_gather`` for the halo rows and the verdicts, ``all_reduce``
for sums (``parallel/logup_shard.py``).  Tables are replicated.

The process group is the caller's: ``torch.distributed.init_process_group``
(NCCL on the card, one rank a device; gloo on the CPU) comes first, then
``make_mesh`` or ``make_mesh_2d``.  Every rank calls every function here
with the same arguments (SPMD).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.convert import to_device
from ..runtime.jit import _slice_lanes
from ..runtime.kernels import require_device


class Mesh:
    """The ranks of one verification, in mesh order (row-major over
    ``shape``), with this rank's place among them, its device and the
    process group of each axis that this rank lies on."""

    def __init__(self, shape: Dict[str, int], ranks: Sequence[int], group, axis_groups: dict,
                 device):
        self.shape = dict(shape)
        self.ranks = list(ranks)
        self.group = group
        self.axis_groups = axis_groups
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None
        self.size = len(self.ranks)
        self.device = device

    def size_of(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def share(self, n: int) -> Tuple[int, int, int]:
        """This rank's rows of ``n`` padded to a multiple of the mesh size:
        ``(lo, hi, size)``, the real rows ``[lo, hi)`` first in a share of
        ``size`` rows (the padding comes at the end of the last shares)."""
        size = -(-n // self.size)
        lo = min(n, self.rank * size)
        return lo, min(n, lo + size), size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) concatenated along
        dim 0 in mesh order; bool tensors travel as uint8."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        cat = torch.cat(out)
        return cat.bool() if t.dtype == torch.bool else cat

    def all_reduce_sum(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``t`` summed over the ranks of each axis in ``axes``, one
        ``all_reduce`` an axis (the JAX ``psum`` over each mesh axis)."""
        for a in axes:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.axis_groups[a])
        return t


def _device(device) -> torch.device:
    """The rank's device: ``cuda:<local rank>`` unless the caller passes
    one ("cpu" only where asked for)."""
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        n_cards = torch.cuda.device_count()
        device = f"cuda:{local % n_cards}" if n_cards else "cuda"
    dev = require_device(device, "make_mesh")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _group(ranks: List[int]):
    """The default group where ``ranks`` is all of it, else a new group
    (which every rank of the default group must create alike)."""
    return None if len(ranks) == dist.get_world_size() else dist.new_group(ranks)


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows", device=None) -> Mesh:
    """A 1-D mesh over the default process group, or over its first
    ``n_devices`` ranks as a subgroup (the JAX ``make_mesh``)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    assert n <= dist.get_world_size(), f"need {n} ranks, have {dist.get_world_size()}"
    ranks = list(range(n))
    group = _group(ranks)
    return Mesh({axis: n}, ranks, group, {axis: group}, _device(device))


def make_mesh_2d(n_hosts: int, n_chips: int, axes: Tuple[str, str] = ("hosts", "chips"),
                 device=None) -> Mesh:
    """A hosts x chips grid of ranks, rank ``h * n_chips + c`` at (h, c)
    (the JAX ``make_mesh_2d``'s layout): one group for each row (the chips
    of a host) and one for each column (a chip's place on every host)."""
    n = n_hosts * n_chips
    assert n <= dist.get_world_size(), f"need {n} ranks, have {dist.get_world_size()}"
    ranks = list(range(n))
    group = _group(ranks)
    me = dist.get_rank()
    axis_groups = {}
    for h in range(n_hosts):
        g = dist.new_group([h * n_chips + c for c in range(n_chips)])
        if me // n_chips == h:
            axis_groups[axes[1]] = g
    for c in range(n_chips):
        g = dist.new_group([h * n_chips + c for h in range(n_hosts)])
        if me % n_chips == c:
            axis_groups[axes[0]] = g
    return Mesh({axes[0]: n_hosts, axes[1]: n_chips}, ranks, group, axis_groups,
                _device(device))


def halo_rows(mesh: Mesh, tensors: List[torch.Tensor], before: int,
              after: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ``before`` rows that end the previous rank's share and the
    ``after`` rows that begin the next rank's share, of every tensor (each
    ``[m, ...]`` on the rank's device, the same trailing shape on every
    rank), cyclic over the mesh: one ``all_gather`` of every rank's
    boundary rows, carried as int64."""
    widths = [int(np.prod(t.shape[1:])) for t in tensors]
    heads = [t[:after].reshape(after, w).to(torch.int64) for t, w in zip(tensors, widths)]
    tails = [t[t.shape[0] - before:].reshape(before, w).to(torch.int64)
             for t, w in zip(tensors, widths)]
    flat = torch.cat([torch.cat(heads, 1).flatten(), torch.cat(tails, 1).flatten()])
    every = mesh.all_gather(flat[None])
    nxt, prev = every[(mesh.rank + 1) % mesh.size], every[(mesh.rank - 1) % mesh.size]
    head_n = after * sum(widths)
    next_rows = torch.split(nxt[:head_n].reshape(after, sum(widths)), widths, 1)
    prev_rows = torch.split(prev[head_n:].reshape(before, sum(widths)), widths, 1)
    return ([p.reshape((before,) + t.shape[1:]).to(t.dtype) for p, t in zip(prev_rows, tensors)],
            [q.reshape((after,) + t.shape[1:]).to(t.dtype) for q, t in zip(next_rows, tensors)])


def shard_evm_group(verifier, steps, next_steps, mesh: Mesh, tables_tree=None) -> torch.Tensor:
    """A ``CompiledGroupVerifier`` with the lanes split over the ranks: the
    lanes padded to a multiple of the mesh size by repeating lane 0, each
    rank replaying its contiguous share on its device (the tables
    replicated: ``tables_tree`` on the device where the caller has
    uploaded it, else uploaded here), the fail bits gathered.  Every rank
    returns the same ``[len(steps)]`` bool vector."""
    curr, nxt, tables, hints = verifier.host_inputs(steps, next_steps)
    lo, hi, size = mesh.share(len(steps))
    lanes = np.array(list(range(lo, hi)) + [0] * (size - (hi - lo)), dtype=np.int64)
    share = to_device((_slice_lanes(curr, lanes), _slice_lanes(nxt, lanes),
                       _slice_lanes(hints, lanes)), mesh.device)
    if tables_tree is None:
        tables_tree = to_device(tables, mesh.device)
    fail = verifier(share[0], share[1], tables_tree, share[2])
    return mesh.all_gather(fail)[:len(steps)]


def _agree_widths(mesh: Mesh, cols: Dict[str, torch.Tensor], meta) -> None:
    """Give every rank's state columns the bits and widths of the whole
    table (a malformed row widens its column on its own rank only): one
    ``all_reduce`` of the bits (MAX), then each column's limbs zero-padded
    to the agreed width, in place."""
    from ..dsl.value import width_for_bits

    names = sorted(meta["bits"])
    words = sorted(meta["wbits"])
    bits = torch.tensor([meta["bits"][n] for n in names]
                        + [b for n in words for b in meta["wbits"][n]], dtype=torch.int64,
                        device=mesh.device)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=mesh.group)
    agreed = bits.tolist()
    for i, n in enumerate(names):
        meta["bits"][n] = agreed[i]
    for j, n in enumerate(words):
        meta["wbits"][n] = (agreed[len(names) + 2 * j], agreed[len(names) + 2 * j + 1])
    want = {n: meta["bits"][n] for n in names}
    for n in words:
        want[n + "_lo"], want[n + "_hi"] = meta["wbits"][n]
    for name, b in want.items():
        pad = width_for_bits(b) - cols[name].shape[1]
        if pad > 0:
            cols[name] = torch.nn.functional.pad(cols[name], (0, pad))


def state_share(rows: List[dict], mpt_rows: List[dict], mesh: Mesh):
    """This rank's part of the sharded state circuit, made ready: the rows
    padded to a multiple of the mesh size with copies of row 0, this
    rank's share packed (the bits of every column agreed over the ranks),
    one row before it and one after it taken from its neighbours
    (``halo_rows``; cyclic, so rank 0's previous row is the last rank's
    last row, as the single-device check's ``shifted(-1)`` and
    ``shifted(1)`` read them) and the MPT table (replicated) uploaded.
    Returns ``check()``, which runs the port's state check (K5 and the
    rest, unchanged) on the share and its halo, drops the halo rows'
    verdicts and gathers the rest: the same ``[len(rows)]`` bool vector on
    every rank."""
    from ..circuits.state import make_state_check_fn, pack_state_inputs

    n = len(rows)
    lo, hi, size = mesh.share(n)
    own = list(rows[lo:hi]) + [dict(rows[0]) for _ in range(size - (hi - lo))]
    cols, mpt_tree, meta = pack_state_inputs(own, mpt_rows)
    _agree_widths(mesh, cols, meta)
    names = sorted(cols)
    own_dev = [cols[k].to(mesh.device) for k in names]
    prev, nxt = halo_rows(mesh, own_dev, 1, 1)
    ext = {k: torch.cat([p, t, q]) for k, p, t, q in zip(names, prev, own_dev, nxt)}
    meta["n"] = size + 2
    fn = make_state_check_fn(meta, device=mesh.device)
    mpt_dev = to_device(mpt_tree, mesh.device)

    def check() -> torch.Tensor:
        return mesh.all_gather(fn(ext, mpt_dev)[1:size + 1])[:n]

    return check


def sharded_state_circuit(rows: List[dict], mpt_rows: List[dict], mesh: Mesh) -> torch.Tensor:
    """The state circuit with its rows split over the ranks
    (``state_share``): the same ``[len(rows)]`` bool fail bits on every
    rank."""
    return state_share(rows, mpt_rows, mesh)()
