#!/usr/bin/env python3
"""Where the time goes on the card: one call of each of the port's paths
under torch.profiler; or the MUL group's replay in several checkouts.

    python3 profile_replay.py
    python3 profile_replay.py --compare ROOT_A ROOT_B [ROOT ...]

Paths, at the sizes ``chip_smoke.py`` runs them (``workloads.py``): the
compiled group verifier's replay on the ADD and MUL groups at 131072
lanes, the state check on both of ``bench.py``'s row mixes at 2^19 rows,
the bytecode check on the ALU-mix bytecodes at k = 20, the keccak check on
the ALU block's table and on 65536 short preimages, and the withdrawal
check at 16 rows; then the whole ALU block (``workloads.build_alu_block``)
and the arithmetic block (``workloads.build_arith_block``) through the
block verifier, each once as the per-kernel pass (``run_device``) and once
as the CUDA-graph replay (``run_device_combined``).  For each it prints one JSON line: the call's host wall
time, the device's busy time (union of kernel intervals) and idle share
within it, the number of device kernels, and the device time of the ten
costliest kernel names (the port's kernels and PyTorch's own).  Needs a
CUDA device; the kernels are built on first use.

With ``--horner``, for each checkout root in the order given (``.`` when
none), a fresh process times K8 (``circuits/keccak.py:horner_rlc``) at the
block verifier's keccak table ``[66001, 1]``, the ALU block's
``[66001, 8]``, the arithmetic block's ``[24162, 40]``, ``[1024, 1]`` and
the SHA3 mix's ``[300, 65536]``,
on seeded bytes with every step active, at ``HORNER_TARGET_ITEMS`` of
132 x 256 x {1, 2, 4}: the call's time from CUDA events (median of 10),
each of its two kernels' device time under torch.profiler (mean of 5
calls), and the chunk kernel's again with no step active (its staging,
power loads and tree without the scan's products).  One JSON line per
shape and target, with the schedule and the kernels' resident blocks an
SM; every target's output must equal the first's.

    python3 profile_replay.py --horner [ROOT ...]

With ``--logup``, for each checkout root in the order given (``.`` when
none; pass parent, change, change, parent to alternate), a fresh process
times K12 (``ops/fr.py:inv``) at one lane (the logUp total) and at 131072
lanes, and K13's partial sum (``tables/logup.py:logup_partial_sum``, K12
inside it) at every side of every logUp family of both blocks
(``workloads.LOGUP_SIDES``: the element counts and m widths
``chip_smoke.py``'s ``logup`` phases give it) on seeded canonical
elements, alpha 0xA1FA: the call's time from CUDA events (median of 10),
its device launches and each kernel's device time under torch.profiler (a
mean over 5 calls), and the sum's value, which must agree across roots.
A root whose ``tables/logup.py`` has ``logup_plan`` is run at each tile
of ``LOGUP_TILES`` (threads a block, elements a thread;
``csrc/logup_sum.cu`` is built once more with ``-DLOGUP_THREADS`` and
``-DLOGUP_RUN`` for each tile but the first, its own), with the plan and
the kernels' resident blocks an SM; one JSON line per shape and tile,
then the kernels' registers and spills from ptxas (of the first tile).

    python3 profile_replay.py --logup [ROOT ...]

With ``--sass NAME ...``, each named kernel library is built and its SASS
read with ``cuobjdump -sass``: one JSON line per kernel with its
instruction count, the count of each of its ten commonest opcodes, and
the instructions of each loop body (from a backward branch to its
target).

    python3 profile_replay.py --sass fr_inv logup_sum

With ``--compare``, for each checkout root in the order given (pass
parent, change, change, parent to alternate), a fresh process imports
``zkevm_specs_tpu_torch`` from that root, builds the MUL group at
``workloads.GROUP_LANES`` lanes, uploads it, counts each kernel's
launches over one replay and times ten more: the host wall of each replay
ending in a synchronise, and the card's time for it from CUDA events.  One
JSON line per root, then the card's name and power limit; each checkout
builds its kernels into its own ``build/kernels/``.
"""
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import bytecode, keccak, state, withdrawal
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier
from zkevm_specs_tpu_torch.workloads import build_add_workload, build_mul_workload


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_call(label, call, card, **info):
    """Profile one call of ``call`` (after three unprofiled warm-up calls)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        by_name[e.name][0] += 1
        by_name[e.name][1] += t - s
    busy = busy_us(intervals)
    span = (max(t for _, t in intervals) - min(s for s, _ in intervals)) if intervals else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    print(json.dumps({
        "path": label, **info, "card": card, "wall_ms": wall_us / 1e3,
        "device_kernels": len(kernels), "device_busy_ms": busy / 1e3,
        "device_span_ms": span / 1e3,
        "idle_share_of_wall": (1 - busy / wall_us) if kernels else None,
        "top_kernels": [{"name": n[:90], "count": c, "ms": us / 1e3} for n, (c, us) in top],
    }), flush=True)


COMPARE_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier

tables, steps, nexts = workloads.build_mul_workload(workloads.GROUP_LANES)
v = CompiledGroupVerifier(tables, ExecutionState.MUL, steps, nexts)
inputs = v.prepare_inputs(steps, nexts)
for _ in range(3):
    assert not bool(v(*inputs).any())
torch.cuda.synchronize()
L.LAUNCHES.clear()
v(*inputs)
torch.cuda.synchronize()
launches = {k: n for k, n in L.LAUNCHES.items() if n}
wall, card = [], []
for _ in range(10):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    v(*inputs)
    end.record()
    torch.cuda.synchronize()
    wall.append((time.perf_counter() - t0) * 1e3)
    card.append(start.elapsed_time(end))
print(json.dumps({"root": sys.argv[1], "lanes": workloads.GROUP_LANES, "launches": launches,
                  "replay_ms_median": statistics.median(wall), "replay_ms_min": min(wall),
                  "card_ms_median": statistics.median(card)}))
"""


HORNER_CHILD = r"""
import ctypes, json, statistics, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from zkevm_specs_tpu_torch.circuits import keccak
from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.runtime import cuda_build

lib, blocks = cuda_build.library("horner_rlc"), [ctypes.c_int(), ctypes.c_int()]
per_sm = None
if hasattr(lib, "horner_blocks_per_sm"):  # a checkout from before it has none
    assert lib.horner_blocks_per_sm(*map(ctypes.byref, blocks)) == 0
    per_sm = {"chunk": blocks[0].value, "combine": blocks[1].value}
rng = np.random.RandomState(0)
r = int.from_bytes(rng.bytes(32), "little") % fr.P


def events_ms(call):
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_us(call):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "horner" in e.name:
            key = "chunk_us" if "chunk" in e.name else "combine_us"
            out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 5
    return out


for T, n in ((66001, 1), (66001, 8), (24162, 40), (1024, 1), (300, 65536)):
    byte_cols = torch.from_numpy(rng.randint(0, 256, (T, n), dtype=np.uint8)).cuda()
    active = torch.ones((T, n), dtype=torch.bool, device="cuda")
    idle = torch.zeros_like(active)
    first = None
    for mult in (1, 2, 4):
        keccak.HORNER_TARGET_ITEMS = 132 * 256 * mult
        s = keccak.horner_schedule(T, n)
        call = lambda: keccak.horner_rlc(byte_cols, active, r)
        out = call()
        first = out if first is None else first
        assert torch.equal(out, first), (T, n, mult)
        ms = events_ms(call)
        split = kernels_us(call)
        idle_split = kernels_us(lambda: keccak.horner_rlc(byte_cols, idle, r))
        print(json.dumps({"root": sys.argv[1], "shape": [T, n], "target_items": 132 * 256 * mult,
                          "chunk": s.chunk, "chunks_per_row": s.chunks,
                          "rows_per_block": s.rows_per_block,
                          "chunks_per_block": s.chunks_per_block, "groups": s.groups,
                          "combine_threads": s.combine_threads,
                          "blocks_per_sm": per_sm,
                          "ms": ms, **split,
                          "chunk_us_no_step_active": idle_split.get("chunk_us")}), flush=True)
"""


# (threads, run) tiles of K13 swept at each shape; the first is the default
LOGUP_TILES = [(256, 4), (128, 8), (256, 8), (128, 4)]

LOGUP_CHILD = r"""
import ctypes, json, re, statistics, subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.runtime import cuda_build
from zkevm_specs_tpu_torch.tables import logup

shapes, tiles = json.loads(sys.argv[2]), json.loads(sys.argv[3])
planned = hasattr(logup, "logup_plan")   # a checkout from before it has none
rng = np.random.RandomState(0)


def elements(n, width=16, below=1 << 16):
    limbs = rng.randint(0, below, size=(n, width)).astype(np.int64)
    if width == 16:
        limbs[:, 15] %= fr.P >> 240
    return torch.from_numpy(limbs).cuda()


def events_ms(call):
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels(call, calls=5):
    # device launches a call and device us a call by kernel, over five
    # calls (the profiler may drop a session's first few kernels)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us = {}
    count = 0
    for e in prof.events():
        name = re.search(r"\w+_kernel(<\d+>)?", e.name) if e.device_type == DeviceType.CUDA else None
        if name:
            count += 1
            us[name.group()] = (us.get(name.group(), 0.0)
                                + (e.time_range.end - e.time_range.start) / calls)
    return round(count / calls), us


def emit(**kw):
    print(json.dumps({"root": sys.argv[1], **kw}), flush=True)


def tile_libraries():
    # K13 at each tile: the default library, and logup_sum.cu built with
    # -DLOGUP_THREADS and -DLOGUP_RUN for the others (one nvcc each, all
    # at once) into this process's own files
    src = cuda_build.CSRC / "logup_sum.cu"
    libs, procs = {tuple(tiles[0]): cuda_build.library("logup_sum")}, {}
    for threads, run in tiles[1:]:
        so = cuda_build.BUILD_DIR / f"liblogup_sum-tile{threads}x{run}.so"
        procs[threads, run] = so, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-DLOGUP_THREADS={threads}",
             f"-DLOGUP_RUN={run}", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for tile, (so, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        lib = libs[tile] = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_build.SIGNATURES["logup_sum"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    return libs


for lanes in (1, 131072):
    a = elements(lanes)
    call = lambda: fr.inv(a)
    got = call()
    assert fr.to_ints(got.cpu()[:4]) == [pow(v, fr.P - 2, fr.P) for v in fr.to_ints(a.cpu()[:4])]
    count, us = kernels(call)
    emit(kernel="fr_inv", lanes=lanes, ms=events_ms(call), device_launches=count, kernel_us=us)

alpha = L.int_to_limbs(0xA1FA, 16).cuda()
libs = tile_libraries() if planned else {(None, None): None}
for label, n, m_width in shapes:
    fps = elements(n)
    m = elements(n, m_width, 2 if m_width == 1 else 1 << 16)
    first = None
    for (threads, run), lib in libs.items():
        info = {}
        if planned:   # the wrapper plans at this tile and launches its library
            logup.LOGUP_THREADS, logup.LOGUP_RUN = threads, run
            cuda_build._LIBS["logup_sum"] = lib
            plan = logup.logup_plan(n)
            blocks = [ctypes.c_int(), ctypes.c_int()]
            assert lib.logup_blocks_per_sm(*map(ctypes.byref, blocks)) == 0
            info = {"threads": threads, "run": run, "levels": list(plan.levels),
                    "planned_launches": sum(plan.launches(True)) + 1,
                    "blocks_per_sm": [blocks[0].value, blocks[1].value]}
        call = lambda: logup.logup_partial_sum(fps, alpha, m)
        out = call()
        first = out if first is None else first
        assert torch.equal(out, first), (label, threads, run)
        count, us = kernels(call)
        emit(kernel="logup_sum", side=label, n=n, m_limbs=m_width, **info, ms=events_ms(call),
             device_launches=count, kernel_us=us, sum=hex(L.limbs_to_int(out.cpu())))
emit(resource_usage={k: cuda_build.resource_usage(k) for k in ("fr_inv", "logup_sum")})
"""


def run_roots(child, roots, card, *args):
    """``child`` in a fresh process for each checkout of ``roots``, its
    JSON lines printed as they are."""
    for root in roots:
        out = subprocess.run([sys.executable, "-c", child, root, *args],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"profile_replay: {root} failed:\n{out.stderr[-4000:]}")
        print("\n".join(l for l in out.stdout.splitlines() if l.startswith("{")), flush=True)
    print(card)


def sass_summary(name):
    """Per kernel of library ``name``: SASS instructions, the commonest
    opcodes, and the instructions of each loop body."""
    from zkevm_specs_tpu_torch.runtime import cuda_build

    cuda_build.build_all([name])
    cuobjdump = str(Path(cuda_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(cuda_build._so_path(name))],
                          capture_output=True, text=True, check=True).stdout
    kernels, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernels.setdefault(cuda_build._kernel_name(m.group(1)), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    for kernel, ins in kernels.items():
        loops = []
        for addr, op, rest in ins:
            target = re.match(r"\s+(0x[0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                loops.append((addr - int(target.group(1), 16)) // 16 + 1)
        ops = defaultdict(int)
        for _, op, _ in ins:
            ops[op.split(".")[0]] += 1
        print(json.dumps({"library": name, "kernel": kernel, "instructions": len(ins),
                          "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10]),
                          "loop_bodies": loops}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if sys.argv[1:2] == ["--compare"]:
        if len(sys.argv) < 4:
            raise SystemExit(__doc__)
        return run_roots(COMPARE_CHILD, sys.argv[2:], card)
    if sys.argv[1:2] == ["--horner"]:
        return run_roots(HORNER_CHILD, sys.argv[2:] or ["."], card)
    if sys.argv[1:2] == ["--sass"]:
        for name in sys.argv[2:]:
            sass_summary(name)
        return print(card)
    if sys.argv[1:2] == ["--logup"]:
        return run_roots(LOGUP_CHILD, sys.argv[2:] or ["."], card,
                         json.dumps(workloads.LOGUP_SIDES), json.dumps(LOGUP_TILES))
    for name, exec_state, build in (("ADD", ExecutionState.ADD, build_add_workload),
                                    ("MUL", ExecutionState.MUL, build_mul_workload)):
        tables, steps, nexts = build(workloads.GROUP_LANES)
        verifier = CompiledGroupVerifier(tables, exec_state, steps, nexts)
        inputs = verifier.prepare_inputs(steps, nexts)
        profile_call(name, lambda: verifier(*inputs), card, lanes=workloads.GROUP_LANES)
    for mix in ("memory_stack", "storage_account"):
        rows, mpt_rows = getattr(workloads, f"build_state_{mix}")(workloads.ALU_BLOCK_STATE_ROWS)
        cols, tree, meta = state.pack_state_inputs(rows, mpt_rows)
        check, inputs = state.make_state_check_fn(meta), to_device((cols, tree), "cuda")
        profile_call(f"state_{mix}", lambda: check(*inputs), card,
                     rows=workloads.ALU_BLOCK_STATE_ROWS)
    rows, keccak_rows, r = workloads.build_alu_bytecodes(workloads.ALU_BLOCK_TXS,
                                                         workloads.ALU_BLOCK_OPS)
    kernel = bytecode.bytecode_kernel(rows, keccak_rows, r)
    profile_call("bytecode", kernel, card, rows=len(rows))
    for data, build in (("alu_block", workloads.build_keccak_alu_block),
                        ("sha3_mix", workloads.build_keccak_sha3_mix)):
        preimages, keccak_rows, r = build()
        kernel = keccak.keccak_kernel(preimages, keccak_rows, r)
        profile_call(f"keccak_{data}", kernel, card, rows=len(preimages))
    witness, n, r = workloads.build_withdrawals()
    profile_call("withdrawal", withdrawal.withdrawal_kernel(witness, n, r), card, rows=n)
    for path, build in (("block", workloads.build_alu_block),
                        ("arith", workloads.build_arith_block)):
        block = build()
        bv = CompiledBlockVerifier(block)
        prepared = bv.prepare()
        for label, run in ((f"{path}_per_kernel", bv.run_device),
                           (f"{path}_graph", bv.run_device_combined)):
            profile_call(label, lambda: run(prepared), card, steps=len(block.steps),
                         rw_rows=len(block.rw.rws))
        del bv, prepared, block
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
