#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``zkevm_specs_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It drives the port's main path, the compiled EVM group verifier, through
the entry points a user calls, and checks it.  Phases (JSON lines on
stdout; any failure raises and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the four kernels of ``zkevm_specs_tpu_torch/csrc``, one nvcc per
   source, all started together;
3. slice: the ADD and MUL groups at 131072 lanes (``bench.py``'s
   ``BENCH_STEPS``): host trace, upload, one replay on the card with every
   kernel launch count set to 0 just before it and read just after, every
   lane passing, then the replay timed, then a rebuild with one corrupted
   lane that must fail alone; plus the replay at 256 lanes held against
   the same replay on the CPU (the plain versions, which the CPU tests hold
   against the JAX package);
4. kernels: each kernel against its plain version on the card at a shape
   of the path (bit-exact: they are integer functions), with the median of
   25 timed launches, the plain version's time and the bound.

The last three lines are the kernels line, the card's nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing anything.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU")

from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.ops import fr  # noqa: E402
from zkevm_specs_tpu_torch.ops import limbs as L  # noqa: E402
from zkevm_specs_tpu_torch.runtime import cuda_build  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.tables import engine  # noqa: E402
from zkevm_specs_tpu_torch.tables.schemas import Target  # noqa: E402
from zkevm_specs_tpu_torch.workloads import build_add_workload, build_mul_workload  # noqa: E402

LANES = 131072          # bench.py's default BENCH_STEPS
SMALL_LANES = 256
CORRUPT_LANE = 77_777
REPLAY_REPEATS = 10
KERNEL_REPEATS = 25

# H100 SXM peaks used for the bounds: HBM3 3.35 TB/s (data sheet); int32
# ALU issue 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 1.673e13 op/s
# (Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

WRAPPERS = {
    "fr_mul": fr.fr_mul,
    "limb_mul": L.limb_mul,
    "limb_addsub": L.limb_addsub,
    "lookup_gather_eq": engine.lookup_gather_eq,
}
REPLACES = {
    "fr_mul": "zkevm_specs_tpu/ops/fr.py:97 (mul -> reduce_wide :43; retired Pallas "
              "fr_mul_pallas, ops/pallas_fr.py:146 before 8a07970)",
    "limb_mul": "zkevm_specs_tpu/ops/limbs.py:277 (mul, with carry_propagate :197)",
    "limb_addsub": "zkevm_specs_tpu/ops/limbs.py:228 (add/sub :228-252; fr.py:66-94 "
                   "add/sub/neg/reduce_once)",
    "lookup_gather_eq": "zkevm_specs_tpu/tables/engine.py:199 (Table.lookup hint replay, "
                        "_gather_rows :313)",
}
# kernels each path must launch
PATH_KERNELS = {"ADD": ("limb_addsub", "lookup_gather_eq"),
                "MUL": ("fr_mul", "limb_mul", "limb_addsub", "lookup_gather_eq")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_on_card_ms(fn, repeats=KERNEL_REPEATS, warmup=3):
    """Median device time of one call, from CUDA events around it.  A short
    sleep kernel is queued first so the start event fires after the host
    has enqueued the call, and the interval is the device's work alone
    (for a multi-launch plain version it includes its launch gaps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 3: the slice ---------------------------------------------------------

def run_group(name, state, build, card):
    out = {"phase": "slice", "group": name, "lanes": LANES, "card": card}
    t0 = time.perf_counter()
    tables, steps, nexts = build(LANES)
    t1 = time.perf_counter()
    verifier = CompiledGroupVerifier(tables, state, steps, nexts)        # device "cuda"
    t2 = time.perf_counter()
    inputs = verifier.prepare_inputs(steps, nexts)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    # the main path: counts set to 0 just before the replay, read just after
    reset_counts()
    fail = verifier(*inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    assert fail.device.type == "cuda" and fail.dtype == torch.bool and fail.shape == (LANES,)
    assert not bool(fail.any()), f"{name}: {int(fail.sum())} lanes failed on a valid witness"
    for k in PATH_KERNELS[name]:
        assert counts[k] > 0, f"{name}: kernel {k} was not launched on the main path"

    replay_ms = []
    for _ in range(REPLAY_REPEATS):
        r0 = time.perf_counter()
        verifier(*inputs)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - r0) * 1e3)
    med = statistics.median(replay_ms)
    out.update({
        "workload_build_s": t1 - t0, "host_trace_s": t2 - t1, "upload_s": t3 - t2,
        "n_constraints": verifier.n_constraints, "n_lookups": verifier.n_hints,
        "launches": counts, "replay_ms_median": med, "replay_ms_min": min(replay_ms),
        "steps_per_s": LANES / (med / 1e3),
        "constraint_evals_per_s": LANES * verifier.n_constraints / (med / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    keep = inputs if name == "MUL" else None
    del tables, steps, nexts, verifier, inputs, fail

    tables, steps, nexts = build(LANES, corrupt_lane=CORRUPT_LANE)
    verifier = CompiledGroupVerifier(tables, state, steps, nexts)
    fail = verifier(*verifier.prepare_inputs(steps, nexts))
    bad = torch.nonzero(fail).flatten().tolist()
    assert bad == [CORRUPT_LANE], f"{name}: corrupted lane {CORRUPT_LANE}, failing lanes {bad[:8]}"
    out["corrupt_lane_caught"] = CORRUPT_LANE
    del tables, steps, nexts, verifier, fail

    # the card's replay against the CPU replay (plain versions) at 256 lanes
    for corrupt in (None, 3):
        tables, steps, nexts = build(SMALL_LANES, seed=1, corrupt_lane=corrupt)
        on_card = CompiledGroupVerifier(tables, state, steps, nexts)
        on_cpu = CompiledGroupVerifier(tables, state, steps, nexts, device="cpu")
        f_card = on_card(*on_card.prepare_inputs(steps, nexts)).cpu()
        f_cpu = on_cpu(*on_cpu.prepare_inputs(steps, nexts))
        assert torch.equal(f_card, f_cpu), f"{name}: card and CPU replays disagree"
        assert torch.nonzero(f_card).flatten().tolist() == ([] if corrupt is None else [corrupt])
    out["small_replay_matches_cpu"] = True
    torch.cuda.empty_cache()
    emit(out)
    return counts, keep


# -- phase 4: the kernels against their plain versions ---------------------------

def seeded_limbs(rng, rows, n, bound_bits, device):
    """[rows, n] canonical limbs of random values below 2^bound_bits (and
    below p when bound_bits is 254)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % (1 << bound_bits) for _ in range(rows)]
    if bound_bits >= 254:
        vals = [v % fr.P for v in vals]
    return L.ints_to_limbs(vals, n).to(device)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, int_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel_fn, plain_fn, bytes_moved, int_ops, shape_note, launches):
    torch.cuda.synchronize()
    before = WRAPPERS[name].launches
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    assert WRAPPERS[name].launches == before + 1, f"{name}: the wrapper did not launch its kernel"
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    err = 0
    exact = True
    for g, w in zip(got, want):
        exact = exact and g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        if g.shape == w.shape:
            err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    assert exact, f"{name}: kernel disagrees with its plain version (max abs err {err})"
    ms = time_on_card_ms(kernel_fn)
    plain_ms = time_on_card_ms(plain_fn, repeats=5, warmup=1)
    b_ms, b_by = bound(bytes_moved, int_ops)
    return {"name": name, "route": "cuda", "source": f"zkevm_specs_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "shape": shape_note, "launches": launches,
            "exact": exact, "tolerance": 0, "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved, "int_ops": int_ops,
            "library_ms": None}


def kernel_phase(launches, mul_inputs):
    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    B = LANES
    rows = []

    # K1: the fdiv_const shape, [B, 16] x constant [1, 16]
    a = seeded_limbs(rng, B, 16, 254, dev)
    b = L.int_to_limbs(pow(8, fr.P - 2, fr.P), 16)[None, :].to(dev)
    products = 16 * 16 + 17 * 17 + 17 * 18 // 2
    ops = B * (2 * products + 3 * (32 + 34 + 17) + 3 * 17 * 3)
    rows.append(compare("fr_mul", lambda: fr.fr_mul(a, b), lambda: fr.fr_mul_plain(a, b),
                        nbytes(a, b) + B * 16 * 8, ops, "[B,16] x [1,16] -> [B,16]",
                        launches["fr_mul"]))

    # K2: the 64x64-bit products of _mul_512_terms, [B, 4] x [B, 4] -> 8
    a4 = seeded_limbs(rng, B, 4, 64, dev)
    b4 = seeded_limbs(rng, B, 4, 64, dev)
    rows.append(compare("limb_mul", lambda: L.limb_mul(a4, b4, 8), lambda: L.mul_plain(a4, b4, 8),
                        nbytes(a4, b4) + B * 8 * 8, B * (2 * 16 + 3 * 8),
                        "[B,4] x [B,4] -> [B,8]", launches["limb_mul"]))

    # K3: the Fr add of two full-width values (F.__add__ past 253 bits)
    x = seeded_limbs(rng, B, 16, 254, dev)
    y = seeded_limbs(rng, B, 16, 254, dev)
    rows.append(compare("limb_addsub", lambda: L.limb_addsub(x, y, L.FR_ADD),
                        lambda: L.addsub_plain(x, y, L.FR_ADD, 16),
                        nbytes(x, y) + B * 16 * 8, B * (3 * 17 + 3 * 17 + 16),
                        "FR_ADD [B,16] + [B,16] -> [B,16]", launches["limb_addsub"]))

    # K4: the first stack pop of the MUL replay on its own rw table (3B rows)
    # and hint stream: rw_counter, rw, tag, call id, stack pointer
    curr, _, tree, hints = mul_inputs
    cols = ("rw_counter", "rw", "key0", "id", "address")
    table = [tree["rw"]["cols"][c]["f"] for c in cols]
    query = [curr["rw_counter"], torch.zeros((1, 1), dtype=torch.int64, device=dev),
             torch.tensor([[int(Target.Stack)]], dtype=torch.int64, device=dev),
             curr["call_id"], curr["stack_pointer"]]
    idx = hints[1]["idx"]
    ok_k, _ = engine.lookup_gather_eq(table, query, idx)
    assert bool(ok_k.all()), "lookup_gather_eq: the path's own stack lookup did not match"
    gathered_bytes = B * 8 * sum(t.shape[1] for t in table)
    moved = nbytes(idx) + sum(nbytes(q) for q in query) + 2 * gathered_bytes + B
    compares = B * sum(max(t.shape[1], q.shape[1]) for t, q in zip(table, query))
    rows.append(compare(
        "lookup_gather_eq",
        lambda: (lambda ok_g: [ok_g[0], *ok_g[1]])(engine.lookup_gather_eq(table, query, idx)),
        lambda: (lambda ok_g: [ok_g[0], *ok_g[1]])(
            engine.lookup_gather_eq_plain(table, query, idx)),
        moved, 2 * compares, f"rw table {table[0].shape[0]} rows, 5 parts, B lanes",
        launches["lookup_gather_eq"]))
    return rows


def main():
    card = card_line()
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    per_kernel = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": per_kernel,
          "flags": cuda_build.NVCC_FLAGS})

    launches = {name: 0 for name in WRAPPERS}
    by_path = {}
    mul_inputs = None
    for name, state, build in (("ADD", ExecutionState.ADD, build_add_workload),
                               ("MUL", ExecutionState.MUL, build_mul_workload)):
        counts, keep = run_group(name, state, build, card)
        by_path[name] = counts
        for k, v in counts.items():
            launches[k] += v
        if keep is not None:
            mul_inputs = keep

    rows = kernel_phase(launches, mul_inputs)
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["card"] = card
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
