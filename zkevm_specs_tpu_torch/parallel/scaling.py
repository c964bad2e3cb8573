"""Weak-scaling harness of the sharded checks over ``torch.distributed``.

Counterpart of ``zkevm_specs_tpu/parallel/scaling.py``.  Measures weak
scaling (fixed rows a rank) of the two distributed checks:

  1. the sharded state circuit (the one-row halo of the sorted-adjacency
     checks, then the verdicts gathered; ``parallel/shard.py``), and
  2. the sharded logUp argument (table and queries split over the ranks,
     one ``all_reduce`` of the partial sums; ``parallel/logup_shard.py``),

at every world size from 1 up to the run's (the first n ranks as a
subgroup; the others wait), on a 1-D mesh, and the logUp check on a 2 x
n/2 grid from 4 ranks.  Run it with one process a card (NCCL):

    torchrun --nproc_per_node=N -m zkevm_specs_tpu_torch.parallel.scaling

It stops where no card is found.  On the CPU (gloo, a process a CPU share)
only when asked: ``... -m zkevm_specs_tpu_torch.parallel.scaling --device
cpu``.

Each line is JSON, printed by rank 0, with the backend and the device's
name beside the times.  On the card a check's time is
``runtime/timing.py:time_on_card_ms`` at world size 1; at larger sizes
every rank makes the same fixed number of calls between two CUDA events
(``time_on_card_ms`` repeats a call whose start event fired early, which
would take one rank into a collective the others never reach).  On the CPU
it is the wall clock of a fixed number of calls.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

ALPHA = 0xA1FA


def _iter_ms(fn, mesh, n_iters: int) -> float:
    """Milliseconds a call of ``fn`` (the same count on every rank)."""
    fn()
    if mesh.device.type == "cuda":
        if mesh.size == 1:
            from ..runtime.timing import time_on_card_ms

            return time_on_card_ms(fn, repeats=n_iters)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_iters
    t0 = time.perf_counter()
    for _ in range(n_iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n_iters


def _meshes(device_counts: Sequence[int], device, mesh_2d: bool):
    """(n, mesh) for each count the run has; ranks outside a mesh get
    None (every rank makes every group)."""
    from .shard import make_mesh, make_mesh_2d

    for n in device_counts:
        if n > dist.get_world_size():
            continue
        mesh = make_mesh_2d(2, n // 2, device=device) if mesh_2d else make_mesh(n, device=device)
        yield n, (mesh if mesh.rank is not None else None)


def _emit(results: List[Dict], row: Dict, t1: List[float], mesh) -> None:
    if not t1:
        t1.append(row["iter_ms"])
    row["backend"] = dist.get_backend()
    row["device"] = (torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda"
                     else "cpu")
    row["rows_per_s"] = row["rows"] / (row["iter_ms"] / 1e3)
    row["weak_efficiency"] = t1[0] / row["iter_ms"]
    results.append(row)
    if dist.get_rank() == 0:
        print(json.dumps(row), flush=True)


def measure_state_scaling(rows_per_device: int = 2048, device_counts: Sequence[int] = (1, 2, 4, 8),
                          n_iters: int = 10, device=None) -> List[Dict]:
    """Weak scaling of the sharded state circuit: the rows grow with the
    mesh, the rows a rank stay fixed; efficiency = t(1) / t(n)."""
    from .. import workloads
    from .shard import state_share

    results, t1 = [], []
    for n, mesh in _meshes(device_counts, device, False):
        if mesh is not None:
            rows, mpt_rows = workloads.build_state_memory_stack(n * rows_per_device)
            check = state_share(rows, mpt_rows, mesh)
            assert not check().any()
            _emit(results, {"kernel": "state_circuit", "devices": n, "rows": n * rows_per_device,
                            "iter_ms": _iter_ms(check, mesh, n_iters)}, t1, mesh)
        dist.barrier()
    return results


def measure_logup_scaling(rows_per_device: int = 8192, device_counts: Sequence[int] = (1, 2, 4, 8),
                          n_iters: int = 10, mesh_2d: bool = False, device=None) -> List[Dict]:
    """Weak scaling of the sharded logUp argument on seeded table
    fingerprints and a query multiset drawn from them, the verdict checked
    true."""
    from ..dsl.value import Ctx, F
    from ..ops import limbs as L
    from .logup_shard import logup_sums, query_share, table_share

    rng = np.random.RandomState(0)
    results, t1 = [], []
    for n, mesh in _meshes(device_counts, device, mesh_2d):
        n_rows = n * rows_per_device
        t_fps = rng.randint(0, 1 << 16, size=(n_rows, 16)).astype(np.int64)
        t_fps[:, 15] %= 0x3000                    # below p: a part of weight 1 is its own fingerprint
        t_fps = torch.from_numpy(t_fps)
        idx = rng.randint(0, n_rows, size=n_rows)
        counts = np.bincount(idx, minlength=n_rows)
        if mesh is not None:
            mult = F.from_ints(Ctx("cpu", n_rows), counts, 64).limbs
            q, en = query_share(mesh, t_fps[torch.from_numpy(idx)], torch.ones(n_rows, dtype=torch.bool))
            parts, m = table_share(mesh, [(1, t_fps)], mult)
            q, en, m = q.to(mesh.device), en.to(mesh.device), m.to(mesh.device)
            parts = [(w, c.to(mesh.device)) for w, c in parts]

            def check():
                lhs, rhs = logup_sums(q, en, parts, m, ALPHA, mesh.device, mesh)
                return L.eq(lhs, rhs)

            assert bool(check().item())
            _emit(results, {"kernel": "logup_lookup" + ("_2d" if mesh_2d else ""), "devices": n,
                            "rows": n_rows, "iter_ms": _iter_ms(check, mesh, n_iters)}, t1, mesh)
        dist.barrier()
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: NCCL, a card a rank (the default); cpu: gloo")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling: no CUDA device found (pass --device cpu for a CPU run)")
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    device = None if args.device == "cuda" else "cpu"
    try:
        measure_logup_scaling(device=device)
        if dist.get_world_size() >= 4:
            measure_logup_scaling(mesh_2d=True, device_counts=(4, 8), device=device)
        measure_state_scaling(device=device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
