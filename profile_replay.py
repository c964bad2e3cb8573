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
``-DLOGUP_RUN`` for each tile but the first, its own, by
``cuda_build.build_variants`` and launched inside ``launching``), with the plan and
the kernels' resident blocks an SM; one JSON line per shape and tile,
then the kernels' registers and spills from ptxas (of the first tile).

    python3 profile_replay.py --logup [ROOT ...]

With ``--limbs``, for each checkout root in the order given (``.`` when
none; parent and change in one call compare them on one card), a fresh
process builds the ALU block and the arithmetic block
(``workloads.build_alu_block``, ``build_arith_block``), runs each block's
per-kernel pass once under torch.profiler (K3's and K4's device time and
launches), and once more with every call of K3 (``limbs.limb_addsub``)
and K4 (``engine.lookup_gather_eq``) counted under its shape (operand
shapes and row strides, mode), as it does for the calls of each block's
rw logUp check and for the kernels line's two shapes (K3's Fr add of two
``[131072, 16]`` rows, K4's 5-part stack pop of the MUL group); then
times each distinct shape on its own arguments
(``runtime/timing.py:time_on_card_ms``, median of 10) and hashes its
output.  K4's time at the 5-part stack pop is also split by what it
moves (``gather_split``: the whole call, the gather alone, the gather
with every hint at row 0, the narrowest part alone at row 0), each with
its bytes and their time at the card's memory rate.  In a root
whose sources take ``ADDSUB_TILE`` and ``GATHER_TILE``, every shape is
timed at each tile of ``LIMB_TILES`` (the kernel built once more with
``-D`` for each but the first, by ``cuda_build.build_variants``, launched
inside ``launching``).  Per block and kernel it prints the
launches, the one-lane launches, the profiled device time and the sum of
count x ms (by tile); every shape line goes to
``build/profile_limbs.jsonl``, and the outputs must agree across roots
and tiles.

    python3 profile_replay.py --limbs [ROOT ...]

With ``--keccak``, for each checkout root in the order given (``.`` when
none; parent and change in one call compare them on one card), a fresh
process times K7 (``ops/keccak.py:keccak_sponge``) at the ALU block's,
the arithmetic block's and the SHA3 mix's keccak tables (built once, in
this process, into ``build/keccak_shapes.pt``) and at every row count x
blocks a row of ``KECCAK_SWEEP`` (seeded words, every row full): the
source's own build and, in a root whose source takes
``KECCAK_COOP_ROWS``, one build a path (``-DKECCAK_COOP_ROWS=0``: every
batch one thread a row; ``=2^31 - 1``: one warp a row;
``cuda_build.build_variants``), each the median of 10
(``time_on_card_ms``), with the bytes, operations and chain bounds that
this process adds from ``runtime/bounds.py`` (``chip_smoke.py``'s
model).  The outputs must agree across paths and roots; the sweep is
what sets the switch-over.

    python3 profile_replay.py --keccak [ROOT ...]

With ``--frmul``, for each checkout root in the order given, a fresh
process times K1 (``ops/fr.py:fr_mul``) at the kernels line's
``[131072, 16] x [1, 16]`` and at every shape of both blocks' per-kernel
passes, their rw logUp checks and their whole logUp checks, with the
count of each shape (every call captured), and in a root whose source
takes ``FRMUL_SPLIT`` also the builds that only stage and store (1) and
only stage (2), which split each shape's time into loads, stores and
product.  Per block the sums of count x ms by build and of count x
bytes bound (``runtime/bounds.py:fr_mul_cost``, added by this process),
one JSON line a shape and a summary a block; the outputs must agree
across roots.

    python3 profile_replay.py --frmul [ROOT ...]

With ``--search``, for each checkout root in the order given (parent and
change in one call compare them on one card), a fresh process times K6
(``tables/engine.py:lookup_search_eq`` and its fingerprint entry
``lookup_fingerprint``) at every shape the Storage/Account mix's state
check (2^19 rows), the bytecode circuit at k = 20 and both blocks'
per-kernel passes give it, with the count of each shape, the path the
launcher took and, at the Storage lookup, ``torch.searchsorted``'s time on
the same keys (the search step alone); then at ``SEARCH_SWEEP``'s batches
of the Storage lookup's first lanes.  In a root whose source takes
``SEARCH_WARP_BATCH``, every shape is also timed on a build of each path
(``-DSEARCH_WARP_BATCH``, ``-DSEARCH_TILE_BATCH``, ``-DSEARCH_TILE_LIMBS``:
every batch a tile, one warp a lane, or one thread a lane), which sets the
switch-overs.  With ``--wordmul``, the same for K11
(``ops/word_mul.py:mul_add_words``) at the MUL group's replay, at
``WORDMUL_SWEEP``'s lanes of seeded words in both variants, and at the
arithmetic block's pass, with a build of each tile
(``-DWORDMUL_SMALL_BATCH``).  Each shape's bytes, operations and (K11)
chain bound come from this checkout's ``runtime/bounds.py``, loaded into
each root's process; per pass the sums of count x ms by build and of
count x bound; the outputs must agree across roots and builds.

    python3 profile_replay.py --search [ROOT ...]
    python3 profile_replay.py --wordmul [ROOT ...]

With ``--narrow``, the same for K2 and K5: K2's product
(``ops/limbs.py:limb_mul``) and K5 (``circuits/state.py:state_order_lt``)
at every shape of the Memory/Stack state check (2^19 rows) and of both
blocks' per-kernel passes, with counts, K2 also at ``NARROW_SWEEP``'s
lanes of seeded limbs (``[lanes, 1] x [1, 16] -> 16``, the arithmetic
pass's widest, and ``[lanes, 16] x [lanes, 16] -> 32``); the logUp tail
(both sides ``[2, 16]`` at keep 17, reduced; a ``[2, 32]`` input reduced
and rippled alone) as the root runs it, K2's normalise-and-reduce entry
(``ops/fr.py:normalize_reduce``, ``ops/limbs.py:carry_propagate``) or,
before it, a ``carry_propagate`` and a ``reduce_wide`` a row, with the
port's launches and every device kernel
(torch.profiler) a call and the entry's chain bound; and each logUp
family's check of both blocks (``sharded_logup_check``: its launches,
device kernels, time and verdict).

    python3 profile_replay.py --narrow [ROOT ...]

With ``--graphs``, for each checkout root in the order given (pass
parent, change, change, parent to alternate), a fresh process builds the
ALU block and the arithmetic block, captures each one's device pass in
its CUDA graph and times ``GRAPH_REPLAYS`` replays back to back on the
card alone (CUDA events around each, after ``GRAPH_WARMUP``), while
nvidia-smi samples the SM and memory clocks, power draw, temperature and
throttle reasons every 50 ms: one JSON line a block and root with each
replay's time, the samples' medians within it, and the medians of the
fast and the slow replays (the graphs' times fall in two modes, fast
within ``MODE_GAP_MS`` of the fastest replay).

    python3 profile_replay.py --graphs ROOT_A ROOT_B [ROOT ...]

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
from zkevm_specs_tpu_torch.runtime import bounds, timing
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


# runtime/timing.py's source, put before each child script that times a
# call, so every checkout it imports is timed by this checkout's timer
TIMER = Path(timing.__file__).read_text()

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
        ms = time_on_card_ms(call)
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
import contextlib, ctypes, json, re, sys
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
    # -DLOGUP_THREADS and -DLOGUP_RUN for the others
    # (cuda_build.build_variants: one nvcc each, all at once)
    variants = cuda_build.build_variants(
        "logup_sum", {f"{t}x{r}": [f"LOGUP_THREADS={t}", f"LOGUP_RUN={r}"] for t, r in tiles[1:]})
    return {tuple(tiles[0]): cuda_build.library("logup_sum"),
            **{(t, r): variants[f"{t}x{r}"] for t, r in tiles[1:]}}


for lanes in (1, 131072):
    a = elements(lanes)
    call = lambda: fr.inv(a)
    got = call()
    assert fr.to_ints(got.cpu()[:4]) == [pow(v, fr.P - 2, fr.P) for v in fr.to_ints(a.cpu()[:4])]
    count, us = kernels(call)
    emit(kernel="fr_inv", lanes=lanes, ms=time_on_card_ms(call), device_launches=count, kernel_us=us)

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
            plan = logup.logup_plan(n)
            blocks = [ctypes.c_int(), ctypes.c_int()]
            assert lib.logup_blocks_per_sm(*map(ctypes.byref, blocks)) == 0
            info = {"threads": threads, "run": run, "levels": list(plan.levels),
                    "planned_launches": sum(plan.launches(True)) + 1,
                    "blocks_per_sm": [blocks[0].value, blocks[1].value]}
        call = lambda: logup.logup_partial_sum(fps, alpha, m)
        with cuda_build.launching("logup_sum", lib) if lib else contextlib.nullcontext():
            out = call()
            first = out if first is None else first
            assert torch.equal(out, first), (label, threads, run)
            count, us = kernels(call)
            emit(kernel="logup_sum", side=label, n=n, m_limbs=m_width, **info,
                 ms=time_on_card_ms(call), device_launches=count, kernel_us=us,
                 sum=hex(L.limbs_to_int(out.cpu())))
emit(resource_usage={k: cuda_build.resource_usage(k) for k in ("fr_inv", "logup_sum")})
"""


# tiles swept at the block passes' shapes in a checkout whose sources take
# them (the first of each is the source's own): K3's ADDSUB_TILE, K4's
# GATHER_TILE
LIMB_TILES = {"limb_addsub": ("ADDSUB_TILE", [128, 256, 64]),
              "lookup_gather_eq": ("GATHER_TILE", [128, 64, 256])}

LIMBS_CHILD = r"""
import hashlib, json, sys
from collections import Counter
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.parallel import logup_shard
from zkevm_specs_tpu_torch.runtime import cuda_build
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables.schemas import Target

tiles = json.loads(sys.argv[2])
KERNELS = {"limb_addsub": "limb_addsub_kernel", "lookup_gather_eq": "lookup_gather_eq_kernel"}
HBM_BYTES_PER_S = 3.35e12   # chip_smoke.py's: the H100 SXM's memory rate


def emit(**kw):
    print(json.dumps({"root": sys.argv[1], **kw}), flush=True)


def digest(out):
    h = hashlib.sha256()
    for t in out if isinstance(out, (list, tuple)) else [out]:
        for u in t if isinstance(t, (list, tuple)) else [t]:
            if u is not None:
                h.update(u.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def key(name, args):
    if name == "limb_addsub":
        a, b, mode = args[:3]
        return [mode, args[3] if len(args) > 3 else 0, list(a.shape), list(b.shape),
                L.row_stride(a), L.row_stride(b)]
    table, query, idx = args[:3]
    return [[[list(t.shape), L.row_stride(t)] for t in table],
            [None if q is None else list(q.shape) for q in query], list(idx.shape),
            None if len(args) < 4 or args[3] is None else list(args[3].shape)]


def tile_libraries(name):
    # the source's own build at its first tile, and the kernel built with
    # -D<define> for each other tile (cuda_build.build_variants)
    define, values = tiles[name]
    if f"#ifndef {define}" not in (cuda_build.CSRC / f"{name}.cu").read_text():
        return {None: cuda_build.library(name)}
    variants = cuda_build.build_variants(name, {str(v): [f"{define}={v}"] for v in values[1:]})
    return {values[0]: cuda_build.library(name), **{v: variants[str(v)] for v in values[1:]}}


def capture(modules, run):
    # every K3 and K4 call of run(), counted by key, the first of each kept
    calls, counts = {}, Counter()
    originals = {(m, n): getattr(m, n) for m, n in modules}

    def recorder(module, name):
        def record(*args, **kw):
            k = json.dumps([name, key(name, args)])
            calls.setdefault(k, (name, originals[module, name], args, kw))
            counts[k] += 1
            return originals[module, name](*args, **kw)
        return record

    for m, n in modules:
        setattr(m, n, recorder(m, n))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
    return calls, counts


def time_calls(label, calls, counts, profiled=None):
    # each captured shape timed at every tile on its own arguments; the sums
    sums = {name: {"launches": 0, "shapes": 0, "one_lane_launches": 0, "sum_count_ms": {}}
            for name in KERNELS}
    for name, (n, us) in (profiled or {}).items():
        sums[name].update(profiled_launches=n, profiled_device_ms=us / 1e3)
    for k, (name, fn, args, kw) in calls.items():
        lanes = L.batch_rows(args[0], args[1]) if name == "limb_addsub" else args[2].shape[0]
        by_tile = {}
        for tile, lib in libs[name].items():
            with cuda_build.launching(name, lib):
                call = lambda: fn(*args, **kw)
                by_tile[str(tile)] = {"ms": time_on_card_ms(call), "digest": digest(call())}
        first = next(iter(by_tile.values()))
        assert all(v["digest"] == first["digest"] for v in by_tile.values()), (k, by_tile)
        s = sums[name]
        s["launches"] += counts[k]
        s["shapes"] += 1
        s["one_lane_launches"] += counts[k] if lanes == 1 else 0
        for tile, v in by_tile.items():
            s["sum_count_ms"][tile] = s["sum_count_ms"].get(tile, 0.0) + counts[k] * v["ms"]
        emit(block=label, kernel=name, key=k, count=counts[k], lanes=lanes,
             ms={t: v["ms"] for t, v in by_tile.items()}, digest=first["digest"])
    return sums


cuda_build.build_all()   # every kernel of the passes, one nvcc each, all at once
libs = {name: tile_libraries(name) for name in KERNELS}
PASS = [(L, "limb_addsub"), (engine, "lookup_gather_eq")]

# the kernels line's timed shapes: K3's Fr add of two [131072, 16] rows;
# K4's first stack pop of the MUL group's replay on its own rw table
rng = torch.Generator().manual_seed(0)
x, y = (torch.randint(0, 1 << 16, (workloads.GROUP_LANES, 16), generator=rng) for _ in "xy")
x[:, 15] %= 0x3064
y[:, 15] %= 0x3064
x, y = x.cuda(), y.cuda()
tables, steps, nexts = workloads.build_mul_workload(workloads.GROUP_LANES)
v = CompiledGroupVerifier(tables, ExecutionState.MUL, steps, nexts)
curr, _, tree, hints = v.prepare_inputs(steps, nexts)
table = [tree["rw"]["cols"][c]["f"] for c in ("rw_counter", "rw", "key0", "id", "address")]
query = [curr["rw_counter"], torch.zeros((1, 1), dtype=torch.int64, device="cuda"),
         torch.tensor([[int(Target.Stack)]], dtype=torch.int64, device="cuda"), curr["call_id"],
         curr["stack_pointer"]]
calls, counts = capture(PASS, lambda: (L.limb_addsub(x, y, L.FR_ADD),
                                       engine.lookup_gather_eq(table, query, hints[1]["idx"])))
emit(block="timed_shapes", summary=time_calls("timed_shapes", calls, counts))

# K4's time at that rw lookup split by what it moves: the whole call; the
# gather alone (hint rows, table reads, gathered stores); the gather with
# every hint at row 0 (the table read from cache: hint rows and stores);
# the narrowest part alone at row 0 (about the hint rows alone).  Each
# with the bytes it must move and their time at HBM_BYTES_PER_S.
idx, lanes = hints[1]["idx"], hints[1]["idx"].shape[0]
row0, narrow = torch.zeros_like(idx), min(range(len(table)), key=lambda p: table[p].shape[1])
rows = torch.unique(idx.long().clamp(0, table[0].shape[0] - 1)).numel()
tws = [t.shape[1] for t in table]
moved = {"idx": 4 * lanes, "table_rows": 8 * sum(tws) * rows,
         "query": sum(8 * q.shape[1] * q.shape[0] for q in query), "gathered": 8 * sum(tws) * lanes,
         "ok": lanes}
split = {"whole": (lambda: engine.lookup_gather_eq(table, query, idx), sum(moved.values())),
         "gather_only": (lambda: engine.lookup_gather_eq(table, [None] * len(table), idx,
                                                  want_ok=False),
                         moved["idx"] + moved["table_rows"] + moved["gathered"]),
         "gather_row0": (lambda: engine.lookup_gather_eq(table, [None] * len(table), row0,
                                                  want_ok=False),
                         moved["idx"] + 8 * sum(tws) + moved["gathered"]),
         "narrowest_part_row0": (lambda: engine.lookup_gather_eq([table[narrow]], [None], row0,
                                                                 want_ok=False),
                                 moved["idx"] + 8 * tws[narrow] * (lanes + 1))}
emit(block="gather_split", lanes=lanes, table_rows_touched=rows, table_widths=tws,
     query_shapes=[list(q.shape) for q in query], bytes=moved,
     **{name: {"ms": time_on_card_ms(call, repeats=25), "bytes": b,
               "bound_ms": b / HBM_BYTES_PER_S * 1e3} for name, (call, b) in split.items()})
del idx, row0
del v, tables, steps, nexts, curr, tree, hints, calls

for path, build in (("block", workloads.build_alu_block), ("arith", workloads.build_arith_block)):
    witness = build()
    bv = CompiledBlockVerifier(witness)
    prepared = bv.prepare()
    assert not bv.run_device(prepared), path
    torch.cuda.synchronize()
    # the per-kernel pass under the profiler: K3's and K4's device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bv.run_device(prepared)
        torch.cuda.synchronize()
    profiled = {name: [0, 0.0] for name in KERNELS}
    for e in prof.events():
        for name, kernel in KERNELS.items():
            if e.device_type == DeviceType.CUDA and kernel in e.name:
                profiled[name][0] += 1
                profiled[name][1] += e.time_range.end - e.time_range.start
    calls, counts = capture(PASS, lambda: bv._device_pass(prepared))
    emit(block=path, steps=len(witness.steps),
         summary=time_calls(path, calls, counts, profiled))
    # the logUp check of the block's rw family (the table fingerprint's K3
    # launches, the 14-part gather of the query side)
    calls, counts = capture(PASS + [(logup_shard, "lookup_gather_eq")],
                            lambda: bv.verify_lookups(prepared, tables_names=("rw",)))
    emit(block=f"logup_{path} rw", summary=time_calls(f"logup_{path} rw", calls, counts))
    del bv, prepared, calls, witness
    torch.cuda.empty_cache()
emit(resource_usage={name: cuda_build.resource_usage(name) for name in KERNELS})
"""


GRAPHS_CHILD = r"""
import datetime, json, statistics, subprocess, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

replays, warmup = int(sys.argv[2]), int(sys.argv[3])
MODE_GAP_MS = 1.0
FIELDS = ["timestamp", "clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
          "clocks_throttle_reasons.active"]


def query(fields, *loop):
    return ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits",
            *loop]


def start_sampler():
    # nvidia-smi every 50 ms in the background (without the throttle
    # reasons where this nvidia-smi does not take them)
    fields = FIELDS
    if subprocess.run(query(fields), capture_output=True).returncode != 0:
        fields = FIELDS[:-1]
    proc = subprocess.Popen(query(fields, "-lms", "50"), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout))
    reader.start()
    return fields, proc, reader, lines


def stop_sampler(fields, proc, reader, lines):
    # [(host seconds, {field: value})]
    proc.terminate()
    reader.join()
    proc.wait()
    rows = []
    for line in lines:
        vals = [v.strip() for v in line.split(",")]
        if len(vals) != len(fields):
            continue
        try:
            t = datetime.datetime.strptime(vals[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
        except ValueError:
            continue
        rows.append((t, dict(zip(fields[1:], vals[1:]))))
    return rows


def replay_times(replay):
    # (host start seconds, device ms) of each replay: back to back, a short
    # sleep kernel before each so its start event fires after the host
    # has enqueued it, placed on the host's clock by a reference event
    for _ in range(warmup):
        replay()
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    events = []
    t0 = time.time()
    ref.record()
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [(t0 + ref.elapsed_time(s) / 1e3, s.elapsed_time(e)) for s, e in events]


def during(rows, t, ms, field):
    # the field's median over the samples within a replay (the nearest one
    # where none falls within it)
    inside = [float(r[field]) for ts, r in rows if t <= ts <= t + ms / 1e3
              if r[field].replace(".", "", 1).isdigit()]
    if not inside and rows:
        near = min(rows, key=lambda r: abs(r[0] - t))[1][field]
        inside = [float(near)] if near.replace(".", "", 1).isdigit() else []
    return statistics.median(inside) if inside else None


for path, build in (("block", workloads.build_alu_block), ("arith", workloads.build_arith_block)):
    bv = CompiledBlockVerifier(build())
    prepared = bv.prepare()
    assert not bv.run_device_combined(prepared), path
    sampler = start_sampler()
    times = replay_times(prepared["graph"]["graph"].replay)
    rows = stop_sampler(*sampler)
    ms = [m for _, m in times]
    reasons = sorted({r.get("clocks_throttle_reasons.active") for _, r in rows} - {None})
    # the replays fall in two modes 2.2-2.8 ms apart (PERF.md §6): fast is
    # within MODE_GAP_MS of the fastest replay, slow the rest
    fast = [m for m in ms if m < min(ms) + MODE_GAP_MS]
    slow = [m for m in ms if m >= min(ms) + MODE_GAP_MS]
    print(json.dumps({"root": sys.argv[1], "block": path, "replays": replays, "warmup": warmup,
                      "graph_device_ms_median": statistics.median(ms),
                      "fast_replays": len(fast), "fast_ms_median": statistics.median(fast),
                      "slow_ms_median": statistics.median(slow) if slow else None,
                      "graph_device_ms_min": min(ms), "ms": ms,
                      "sm_mhz": [during(rows, t, m, "clocks.sm") for t, m in times],
                      "mem_mhz": [during(rows, t, m, "clocks.mem") for t, m in times],
                      "power_w": [during(rows, t, m, "power.draw") for t, m in times],
                      "temperature_c": [during(rows, t, m, "temperature.gpu") for t, m in times],
                      "throttle_reasons": reasons, "samples": len(rows)}), flush=True)
    del bv, prepared
    torch.cuda.empty_cache()
"""

GRAPH_REPLAYS, GRAPH_WARMUP = 60, 3


# K7's sweep: row counts and blocks a row (every row full); the switch-over
# KECCAK_COOP_ROWS is read from it
KECCAK_SWEEP = {"rows": [1, 8, 40, 256, 2048, 2560, 3072, 4096, 16384, 65536],
                "blocks": [1, 3, 178, 486]}

KECCAK_CHILD = r"""
import contextlib, hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from zkevm_specs_tpu_torch.ops import keccak
from zkevm_specs_tpu_torch.runtime import cuda_build

shapes_file, sweep = sys.argv[2], json.loads(sys.argv[3])


def emit(**kw):
    print(json.dumps({"root": sys.argv[1], **kw}), flush=True)


def libraries():
    # {path: library}: the source's own build (None) and, where it has the
    # switch, one build a path: -DKECCAK_COOP_ROWS=0 (every batch one
    # thread a row), =2^31 - 1 (one warp a row)
    if "#ifndef KECCAK_COOP_ROWS" not in (cuda_build.CSRC / "keccak_sponge.cu").read_text():
        return {"own": None}
    return {"own": None, **cuda_build.build_variants(
        "keccak_sponge", {"row": ["KECCAK_COOP_ROWS=0"],
                          "warp": [f"KECCAK_COOP_ROWS={2**31 - 1}"]})}


def time_paths(label, blocks, n_blocks, **info):
    times, first = {}, None
    for path, lib in libs.items():
        with cuda_build.launching("keccak_sponge", lib) if lib else contextlib.nullcontext():
            call = lambda: keccak.keccak_sponge(blocks, n_blocks)
            out = call()
            first = out if first is None else first
            assert torch.equal(out, first), (label, path)
            times[path] = time_on_card_ms(call, repeats=10)
    digest = hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()[:16]
    clamped = n_blocks.clamp(0, blocks.shape[1])
    emit(shape=label, rows=blocks.shape[0], max_blocks=blocks.shape[1], **info, ms=times,
         absorbed=int(clamped.sum()), longest=int(clamped.max()), digest=digest)


libs = libraries()
src = (cuda_build.CSRC / "keccak_sponge.cu").read_text()
switch = [l for l in src.splitlines() if l.startswith("#define KECCAK_COOP_ROWS")]
emit(switch=switch[0] if switch else None, paths=list(libs))
for label, (blocks, n_blocks) in torch.load(shapes_file).items():
    time_paths(label, blocks.cuda(), n_blocks.cuda())
gen = torch.Generator(device="cuda").manual_seed(0)
for nb in sweep["blocks"]:
    for rows in sweep["rows"]:
        blocks = torch.randint(0, 1 << 32, (rows, nb, 34), device="cuda", generator=gen)
        n_blocks = torch.full((rows,), nb, dtype=torch.int32, device="cuda")
        time_paths("sweep", blocks, n_blocks, blocks_per_row=nb)
        del blocks
        torch.cuda.empty_cache()
emit(resource_usage=cuda_build.resource_usage("keccak_sponge"))
"""


def keccak_shapes(path):
    """K7's arguments at the ALU block's keccak table, the arithmetic
    block's and the SHA3 mix's (``build_keccak_inputs``'s blocks and block
    counts), saved to ``path`` for the children."""
    from zkevm_specs_tpu_torch.ops.keccak import RATE_WORDS, pad_blocks

    def args(preimages):
        _, _, padded, n_blocks = pad_blocks(preimages)
        blocks = padded.view("<u4").astype("int64").reshape(len(preimages), -1, RATE_WORDS)
        return torch.from_numpy(blocks), torch.from_numpy(n_blocks.astype("int32"))

    arith = workloads.build_arith_block()
    shapes = {"alu_block": args(workloads.build_keccak_alu_block()[0]),
              "arith_block": args([bytes(bc.code) for bc in arith.bytecodes]
                                  + list(arith.sha3_preimages)),
              "sha3_mix": args(workloads.build_keccak_sha3_mix()[0])}
    torch.save(shapes, path)


def keccak_bounds(rec, clock_hz):
    """A ``--keccak`` shape line's bytes, operations and chain bounds
    (``runtime/bounds.py``), in ms."""
    moved, ops = bounds.sponge_cost(rec["absorbed"], rec["rows"])
    return {"bytes_ms": moved / bounds.HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / bounds.INT32_OPS_PER_S * 1e3,
            "chain_ms": bounds.sponge_chain_ms(rec["longest"], clock_hz)}


# K1's builds timed at each shape: the kernel, then (where its source has
# the switch) -DFRMUL_SPLIT=1 (staged loads and stores, no product) and =2
# (staged loads alone)
FRMUL_SPLITS = ["whole", "loads_stores", "loads"]

FRMUL_CHILD = r"""
import contextlib, hashlib, json, sys
from collections import Counter
sys.path.insert(0, sys.argv[1])
import torch
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.runtime import cuda_build
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

splits = json.loads(sys.argv[2])


def emit(**kw):
    print(json.dumps({"root": sys.argv[1], **kw}), flush=True)


def libraries():
    # {split: library}: the source's own build (None) and, where it has the
    # switch, the builds with -DFRMUL_SPLIT=1 and =2
    if "#ifndef FRMUL_SPLIT" not in (cuda_build.CSRC / "fr_mul.cu").read_text():
        return {splits[0]: None}
    return {splits[0]: None, **cuda_build.build_variants(
        "fr_mul", {name: [f"FRMUL_SPLIT={v}"] for v, name in enumerate(splits) if v})}


def key(a, b):
    return [list(a.shape), list(b.shape), L.row_stride(a), L.row_stride(b),
            a.data_ptr() % 16, b.data_ptr() % 16]


def capture(run):
    calls, counts = {}, Counter()
    orig = fr.fr_mul

    def record(a, b):
        k = json.dumps(key(a, b))
        calls.setdefault(k, (a, b))
        counts[k] += 1
        return orig(a, b)

    fr.fr_mul = record
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fr.fr_mul = orig
    return calls, counts


def time_calls(label, calls, counts):
    sums = {"launches": 0, "shapes": 0, "sum_count_ms": {}}
    for k, (a, b) in calls.items():
        ms = {}
        for name, lib in libs.items():
            with cuda_build.launching("fr_mul", lib) if lib else contextlib.nullcontext():
                ms[name] = time_on_card_ms(lambda: fr.fr_mul(a, b))
        out = fr.fr_mul(a, b)
        split = {}
        if len(ms) == len(splits):
            split = {"loads_ms": ms["loads"], "stores_ms": ms["loads_stores"] - ms["loads"],
                     "product_ms": ms["whole"] - ms["loads_stores"]}
        sums["launches"] += counts[k]
        sums["shapes"] += 1
        for name, v in ms.items():
            sums["sum_count_ms"][name] = sums["sum_count_ms"].get(name, 0.0) + counts[k] * v
        emit(block=label, key=k, count=counts[k], lanes=L.batch_rows(a, b), ms=ms, **split,
             digest=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16])
    return sums


cuda_build.build_all()
libs = libraries()
# the kernels line's shape: [131072, 16] x a constant [1, 16]
gen = torch.Generator().manual_seed(0)
x = torch.randint(0, 1 << 16, (workloads.GROUP_LANES, 16), generator=gen)
x[:, 15] %= 0x3064
c = fr.from_ints([pow(8, fr.P - 2, fr.P)]).cuda()
x = x.cuda()
calls, counts = capture(lambda: fr.fr_mul(x, c))
emit(block="timed_shapes", summary=time_calls("timed_shapes", calls, counts))
for path, build in (("block", workloads.build_alu_block), ("arith", workloads.build_arith_block)):
    witness = build()
    bv = CompiledBlockVerifier(witness)
    prepared = bv.prepare()
    assert not bv.run_device(prepared), path
    for label, run in ((path, lambda: bv._device_pass(prepared)),
                       (f"logup_{path} rw", lambda: bv.verify_lookups(prepared, tables_names=("rw",))),
                       (f"logup_{path}", lambda: bv.verify_lookups(prepared))):
        calls, counts = capture(run)
        emit(block=label, summary=time_calls(label, calls, counts))
    del bv, prepared, witness, calls
    torch.cuda.empty_cache()
emit(resource_usage=cuda_build.resource_usage("fr_mul"))
"""


# K6's batches swept on the Storage lookup's own arguments (its first lanes)
SEARCH_SWEEP = [1, 32, 128, 512, 2048, 4096, 8192, 16384, 65536, 524288]
# K11's lanes swept on seeded words, both variants
WORDMUL_SWEEP = [1, 2048, 8192, 13365, 32768, 65536, 131072]

# shared by the --search and --wordmul children: this checkout's bounds
# (runtime/bounds.py, loaded from its path into the root's package so that
# every root is bounded by one model), the digest, the capture of a
# module's calls by key, and the timing of each call on every build
SHAPES_HELPERS = r"""
import contextlib, hashlib, importlib.util, json, sys
from collections import Counter
sys.path.insert(0, sys.argv[1])
import torch
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.runtime import cuda_build

sweep, bounds_path = json.loads(sys.argv[2]), sys.argv[3]
spec = importlib.util.spec_from_file_location("zkevm_specs_tpu_torch.runtime.bounds_model",
                                              bounds_path)
bounds = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bounds)
clock_hz = bounds.sm_clock_max_hz()


def emit(**kw):
    print(json.dumps({"root": sys.argv[1], **kw}), flush=True)


def digest(out):
    h = hashlib.sha256()
    for t in out if isinstance(out, (list, tuple)) else [out]:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def variant_libraries(name, switch, variants):
    # {build: library}: the source's own build (None) and, where the source
    # takes the switch, one build a variant's defines (cuda_build.build_variants)
    if f"#ifndef {switch}" not in (cuda_build.CSRC / f"{name}.cu").read_text():
        return {"own": None}
    return {"own": None, **cuda_build.build_variants(name, variants)}


def capture(module, names, key, run):
    # every call of module.<name> in run(), counted by key, the first kept
    calls, counts = {}, Counter()
    originals = {n: getattr(module, n) for n in names}

    def recorder(name):
        def record(*args):
            k = json.dumps(key(name, args))
            calls.setdefault(k, (name, args))
            counts[k] += 1
            return originals[name](*args)
        return record

    for n in names:
        setattr(module, n, recorder(n))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)
    return calls, counts


def time_builds(lib_name, libs, call):
    # (ms by build, digest): every build's output equal to the first's
    ms, first = {}, None
    for build, lib in libs.items():
        with cuda_build.launching(lib_name, lib) if lib else contextlib.nullcontext():
            d = digest(call())
            first = d if first is None else first
            assert d == first, build
            ms[build] = time_on_card_ms(call, repeats=10)
    return ms, first


def summed(label, rows):
    # a pass's sums over its shapes: launches, count x ms by build, count x bound
    out = {"launches": 0, "shapes": 0, "sum_count_ms": {}, "sum_count_bound_ms": 0.0}
    for r in rows:
        out["launches"] += r["count"]
        out["shapes"] += 1
        out["sum_count_bound_ms"] += r["count"] * r["bound_ms"]
        for build, v in r["ms"].items():
            out["sum_count_ms"][build] = out["sum_count_ms"].get(build, 0.0) + r["count"] * v
    emit(block=label, summary=out)
"""

SEARCH_CHILD = r"""
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import bytecode, state
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.tables import engine

NAMES = ("lookup_search_eq", "lookup_fingerprint")


def key(name, args):
    if name == "lookup_fingerprint":
        parts = args[0]
        return [name, [list(t.shape) for t in parts], [L.row_stride(t) for t in parts]]
    query, table, _, fps, _, max_span, batch = args
    return [name, batch, [list(q.shape) for q in query], [L.row_stride(q) for q in query],
            [list(t.shape) for t in table], fps.shape[0], max_span]


def search_path(args):
    if "lookup_search_eq" not in getattr(cuda_build, "PATHS", {}):
        return None
    return cuda_build.path_taken("lookup_search_eq", lambda: engine.lookup_search_eq(*args))


def time_shape(label, k, name, args, count):
    if name == "lookup_fingerprint":
        moved, ops = bounds.fingerprint_cost([t.shape for t in args[0]])
        info = {"rows": args[0][0].shape[0], "parts": len(args[0])}
        call = lambda: engine.lookup_fingerprint(*args)
    else:
        moved, ops, scanned = bounds.search_cost(args)
        info = {"lanes": args[-1], "parts": len(args[0]), "index_rows": args[3].shape[0],
                "span": args[5], "scanned": scanned, "path": search_path(args)}
        call = lambda: list(engine.lookup_search_eq(*args))
    ms, d = time_builds("lookup_search_eq", libs, call)
    b_ms, b_by = bounds.bound(moved, ops)
    rec = dict(block=label, key=k, kernel=name, count=count, **info, ms=ms, bytes=moved,
               int_ops=ops, bound_ms=b_ms, bound_by=b_by, digest=d)
    emit(**rec)
    return rec


def run_pass(label, run):
    calls, counts = capture(engine, NAMES, key, run)
    rows = [time_shape(label, k, name, args, counts[k]) for k, (name, args) in calls.items()]
    for name in NAMES:
        summed(f"{label} {name}", [r for r in rows if r["kernel"] == name])
    return calls


cuda_build.build_all()
top = 2**31 - 1
libs = variant_libraries("lookup_search_eq", "SEARCH_TILE_BATCH", {
    "tile": ["SEARCH_WARP_BATCH=0", "SEARCH_TILE_BATCH=0", "SEARCH_TILE_LIMBS=0"],
    "warp": [f"SEARCH_WARP_BATCH={top}"],
    "row": ["SEARCH_WARP_BATCH=0", f"SEARCH_TILE_BATCH={top}"]})
# the Storage/Account mix's state check (the standalone Storage lookup and
# the MPT index build), then the batch sweep on the Storage lookup's lanes
rows, mpt_rows = workloads.build_state_storage_account(workloads.ALU_BLOCK_STATE_ROWS)
cols, tree, meta = state.pack_state_inputs(rows, mpt_rows)
check, inputs = state.make_state_check_fn(meta), to_device((cols, tree), "cuda")
del rows, mpt_rows, cols, tree
calls = run_pass("state_storage_account", lambda: check(*inputs))
storage = max((args for name, args in calls.values() if name == "lookup_search_eq"),
              key=lambda args: args[-1])
keys = storage[3] ^ engine._SIGN
qkeys = (engine.fingerprint_plain(storage[0], storage[2]).expand(storage[-1])
         ^ engine._SIGN).contiguous()
emit(block="state_storage_account", searchsorted_ms=time_on_card_ms(
    lambda: torch.searchsorted(keys, qkeys, side="left"), repeats=10))
for batch in sweep:
    query = [q if q.shape[0] == 1 else q[:batch] for q in storage[0]]
    args = (query, *storage[1:6], batch)
    time_shape("sweep", json.dumps(["sweep", batch]), "lookup_search_eq", args, 1)
del check, inputs, calls, storage, keys, qkeys, query, args
torch.cuda.empty_cache()
# the bytecode circuit's keccak lookup (the ALU-mix bytecodes at k = 20)
b_rows, keccak_rows, r = workloads.build_alu_bytecodes(workloads.ALU_BLOCK_TXS,
                                                       workloads.ALU_BLOCK_OPS)
kernel = bytecode.bytecode_kernel(b_rows, keccak_rows, r)
del b_rows, keccak_rows
run_pass("bytecode", kernel)
del kernel
torch.cuda.empty_cache()
for path, build in (("block", workloads.build_alu_block), ("arith", workloads.build_arith_block)):
    witness = build()
    bv = CompiledBlockVerifier(witness)
    prepared = bv.prepare()
    assert not bv.run_device(prepared), path
    run_pass(path, lambda: bv._device_pass(prepared))
    del bv, prepared, witness
    torch.cuda.empty_cache()
emit(resource_usage=cuda_build.resource_usage("lookup_search_eq"))
"""

WORDMUL_CHILD = r"""
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
from zkevm_specs_tpu_torch.ops import word_mul
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier


def key(name, args):
    rows, wide = args[0], len(args) > 1 and bool(args[1])
    return [int(wide), [list(r.shape) for r in rows], [L.row_stride(r) for r in rows]]


def time_shape(label, k, rows, wide, count):
    moved, ops = bounds.word_mul_cost([r.shape for r in rows], wide)
    chain_ms = bounds.word_mul_chain_ms(wide, clock_hz)
    b_ms, b_by, b_kind = bounds.chain_bound(*bounds.bound(moved, ops), chain_ms)
    ms, d = time_builds("mul_add_words", libs, lambda: list(word_mul.mul_add_words(rows, wide)))
    rec = dict(block=label, key=k, count=count, lanes=max(r.shape[0] for r in rows),
               variant=512 if wide else 256, ms=ms, bytes=moved, int_ops=ops, chain_ms=chain_ms,
               bound_ms=b_ms, bound_by=b_by, bound_kind=b_kind, digest=d)
    emit(**rec)
    return rec


def run_pass(label, run):
    calls, counts = capture(word_mul, ("mul_add_words",), key, run)
    summed(label, [time_shape(label, k, args[0], len(args) > 1 and bool(args[1]), counts[k])
                   for k, (_, args) in calls.items()])


cuda_build.build_all()
libs = variant_libraries("mul_add_words", "WORDMUL_SMALL_BATCH",
                         {"small": [f"WORDMUL_SMALL_BATCH={2**31 - 1}"],
                          "large": ["WORDMUL_SMALL_BATCH=0"]})
# the MUL group's replay (the kernels line's shape), then the lanes sweep
tables, steps, nexts = workloads.build_mul_workload(workloads.GROUP_LANES)
v = CompiledGroupVerifier(tables, ExecutionState.MUL, steps, nexts)
inputs = v.prepare_inputs(steps, nexts)
run_pass("mul_group", lambda: v(*inputs))
del v, inputs, tables, steps, nexts
gen = torch.Generator(device="cuda").manual_seed(0)
for wide in (False, True):
    for lanes in sweep:
        rows = [torch.randint(0, 1 << 16, (lanes, 8), device="cuda", generator=gen)
                for _ in range(10 if wide else 8)]
        time_shape("sweep", json.dumps(["sweep", int(wide), lanes]), rows, wide, 1)
torch.cuda.empty_cache()
witness = workloads.build_arith_block()
bv = CompiledBlockVerifier(witness)
prepared = bv.prepare()
assert not bv.run_device(prepared)
run_pass("arith", lambda: bv._device_pass(prepared))
emit(resource_usage=cuda_build.resource_usage("mul_add_words"))
"""


# K2's product swept on seeded limbs at the arithmetic pass's widest shape
# and at a full 16 x 16-limb product, on every build
NARROW_SWEEP = [1, 2048, 8192, 32768, 65536, 131072]

NARROW_CHILD = r"""
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import state
from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.parallel import logup_shard
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.convert import to_device

HAS_ENTRY = hasattr(fr, "normalize_reduce")
OWN = {"own": None}   # the source's own build


def key(name, args):
    if name == "limb_mul":
        a, b, out_n = args
        return [name, list(a.shape), list(b.shape), L.row_stride(a), L.row_stride(b), out_n]
    return [name, args[0].shape[0], [c.stride(0) for c in args]]


def device_kernels(call, calls=3):
    # every device kernel a call launches (PyTorch's own included), a mean
    # over a few calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events()) / calls


def launches_of(call):
    # the port's kernel launches of one call, as its wrappers count them
    before = dict(L.LAUNCHES)
    call()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in L.LAUNCHES.items() if v != before.get(k, 0)}


def time_mul(label, k, a, b, out_n, count):
    moved, ops = bounds.limb_mul_cost(a.shape, b.shape, out_n)
    b_ms, b_by = bounds.bound(moved, ops)
    ms, d = time_builds("limb_mul", OWN, lambda: L.limb_mul(a, b, out_n))
    rec = dict(block=label, key=k, kernel="limb_mul", count=count,
               lanes=max(a.shape[0], b.shape[0]), ms=ms, bytes=moved, int_ops=ops,
               bound_ms=b_ms, bound_by=b_by, digest=d)
    emit(**rec)
    return rec


def time_order(label, k, cols, count):
    moved, ops = bounds.order_cost(cols[0].shape[0])
    b_ms, b_by = bounds.bound(moved, ops)
    ms, d = time_builds("state_order_lt", OWN, lambda: state.state_order_lt(*cols))
    rec = dict(block=label, key=k, kernel="state_order_lt", count=count, rows=cols[0].shape[0],
               ms=ms, bytes=moved, int_ops=ops, bound_ms=b_ms, bound_by=b_by, digest=d)
    emit(**rec)
    return rec


def run_pass(label, run):
    rows = []
    for module, name, timer in ((L, "limb_mul", lambda k, a, c: time_mul(label, k, *a, c)),
                                (state, "state_order_lt",
                                 lambda k, a, c: time_order(label, k, a, c))):
        calls, counts = capture(module, (name,), key, run)
        shapes = [timer(k, args, counts[k]) for k, (_, args) in calls.items()]
        if shapes:
            summed(f"{label} {name}", shapes)
        rows += shapes
    return rows


def run_logup(label, bv, prepared):
    # each family's check: its launches (the port's, and every device
    # kernel), its time on the card, its verdict and both sides' limbs
    for name in [n for n in logup_shard.LOGUP_TABLES if n in bv.lookup_log]:
        inp = logup_shard.family_inputs(getattr(bv.tables, name), bv.lookup_log[name], "cuda",
                                        bv.table_parts_on_device(prepared, name))
        args = (inp["query_fps"], inp["query_en"], inp["parts"], inp["multiplicities"],
                logup_shard.ALPHA)
        check = lambda: logup_shard.sharded_logup_check(*args)
        launches = launches_of(check)
        emit(block=f"logup_{label}", key=json.dumps(["logup", name]), family=name,
             ok=check(), launches=launches, launches_total=sum(launches.values()),
             device_kernels=device_kernels(check),
             check_ms=time_on_card_ms(check, repeats=10, warmup=1),
             digest=digest(torch.cat(list(logup_shard.logup_sums(*args)))))


def tail(x, keep, reduce):
    # the logUp tail as this root runs it: K2's entry, or (before it) a
    # carry_propagate and a reduce_wide a row
    if HAS_ENTRY:
        return fr.normalize_reduce(x, keep) if reduce else L.carry_propagate(x, keep)
    rows = [L.carry_propagate(x[i:i + 1], keep) for i in range(x.shape[0])]
    return torch.cat([fr.reduce_wide(r) for r in rows] if reduce else rows)


cuda_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(0)
# the normalise-and-reduce tail: the logUp sides [2, 16] at keep 17, a
# 32-limb input reduced and rippled alone
for label, width, keep, reduce in (("logup_tail", 16, 17, True), ("reduce_32", 32, 32, True),
                                   ("ripple_32", 32, 32, False)):
    x = torch.randint(0, 1 << 16, (2, width), device="cuda", generator=gen)
    call = lambda: tail(x, keep, reduce)
    moved, ops = bounds.reduce_cost(2, width, keep, reduce)
    chain_ms = bounds.reduce_chain_ms(keep, reduce, clock_hz)
    b_ms, b_by, b_kind = bounds.chain_bound(*bounds.bound(moved, ops), chain_ms)
    launches = launches_of(call)
    emit(block="entry", key=json.dumps([label]), entry=HAS_ENTRY, launches=launches,
         device_kernels=device_kernels(call), ms={"own": time_on_card_ms(call, repeats=25)},
         bytes=moved, int_ops=ops, chain_ms=chain_ms, bound_ms=b_ms, bound_by=b_by,
         bound_kind=b_kind, digest=digest(call()))
# K2's product over the lanes
for lanes in sweep:
    for na, nb, out_n, a_rows in ((1, 16, 16, lanes), (16, 16, 32, lanes)):
        a = torch.randint(0, 1 << 16, (a_rows, na), device="cuda", generator=gen)
        b = torch.randint(0, 1 << 16, (1 if na == 1 else lanes, nb), device="cuda", generator=gen)
        time_mul("sweep", json.dumps(["sweep", lanes, na, nb]), a, b, out_n, 1)
torch.cuda.empty_cache()
# the state check's K5 (Memory/Stack, 2^19 rows)
rows, mpt_rows = workloads.build_state_memory_stack(workloads.ALU_BLOCK_STATE_ROWS)
cols, tree, meta = state.pack_state_inputs(rows, mpt_rows)
check, inputs = state.make_state_check_fn(meta), to_device((cols, tree), "cuda")
del rows, mpt_rows, cols, tree
run_pass("state_memory_stack", lambda: check(*inputs))
del check, inputs
torch.cuda.empty_cache()
for path, build in (("block", workloads.build_alu_block), ("arith", workloads.build_arith_block)):
    witness = build()
    bv = CompiledBlockVerifier(witness)
    prepared = bv.prepare()
    assert not bv.run_device(prepared), path
    run_pass(path, lambda: bv._device_pass(prepared))
    run_logup(path, bv, prepared)
    del bv, prepared, witness
    torch.cuda.empty_cache()
emit(resource_usage={n: cuda_build.resource_usage(n) for n in ("limb_mul", "state_order_lt")})
"""


def frmul_bounds(lines):
    """``--frmul``'s lines with K1's bytes and their bound
    (``runtime/bounds.py:fr_mul_cost``) added to each shape line, and the
    sum of count x bound to each block's summary (which follows its
    shapes)."""
    out, sums = [], defaultdict(float)
    for line in lines:
        rec = json.loads(line)
        if "key" in rec:
            a_shape, b_shape = json.loads(rec["key"])[:2]
            rec["bytes"] = bounds.fr_mul_cost(a_shape, b_shape)[0]
            rec["bytes_bound_ms"] = rec["bytes"] / bounds.HBM_BYTES_PER_S * 1e3
            sums[rec["root"], rec["block"]] += rec["count"] * rec["bytes_bound_ms"]
        elif "summary" in rec:
            rec["summary"]["sum_count_bound_ms"] = sums[rec["root"], rec["block"]]
        out.append(json.dumps(rec))
    return out


def run_digests(child, roots, *args):
    """``child`` in a fresh process for each root: its JSON lines, and the
    number of shapes whose output (``digest``) agreed across roots."""
    digests, lines = {}, []
    for root in roots:
        out = subprocess.run([sys.executable, "-c", child, root, *args],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"profile_replay: {root} failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            lines.append(line)
            rec = json.loads(line)
            if "digest" in rec:
                at = json.dumps([rec.get(k) for k in ("block", "key", "shape", "rows",
                                                      "max_blocks")])
                want = digests.setdefault(at, rec["digest"])
                assert want == rec["digest"], f"{root} differs at {at}"
    return len(digests), lines


def run_limbs(roots, card):
    """LIMBS_CHILD in a fresh process for each root; every shape line goes
    to build/profile_limbs.jsonl, the summaries to stdout; the outputs at
    every shape must agree across roots."""
    Path("build").mkdir(exist_ok=True)
    shapes, lines = run_digests(TIMER + LIMBS_CHILD, roots, json.dumps(LIMB_TILES))
    for line in lines:
        if "digest" not in json.loads(line):
            print(line, flush=True)
    Path("build/profile_limbs.jsonl").write_text("\n".join(lines) + "\n")
    print(json.dumps({"shapes_equal_across_roots": shapes, "roots": roots,
                      "lines": "build/profile_limbs.jsonl"}))
    print(card)


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
    if sys.argv[1:2] == ["--graphs"]:
        return run_roots(TIMER + GRAPHS_CHILD, sys.argv[2:] or ["."], card, str(GRAPH_REPLAYS),
                         str(GRAPH_WARMUP))
    if sys.argv[1:2] == ["--horner"]:
        return run_roots(TIMER + HORNER_CHILD, sys.argv[2:] or ["."], card)
    if sys.argv[1:2] == ["--sass"]:
        for name in sys.argv[2:]:
            sass_summary(name)
        return print(card)
    if sys.argv[1:2] == ["--limbs"]:
        return run_limbs(sys.argv[2:] or ["."], card)
    if sys.argv[1:2] in (["--keccak"], ["--frmul"]):
        roots = sys.argv[2:] or ["."]
        Path("build").mkdir(exist_ok=True)
        if sys.argv[1] == "--keccak":
            keccak_shapes("build/keccak_shapes.pt")
            shapes, lines = run_digests(TIMER + KECCAK_CHILD, roots,
                                        "build/keccak_shapes.pt", json.dumps(KECCAK_SWEEP))
            clock_hz = bounds.sm_clock_max_hz()
            lines = [json.dumps({**rec, **keccak_bounds(rec, clock_hz)} if "absorbed" in rec
                                else rec) for rec in map(json.loads, lines)]
        else:
            shapes, lines = run_digests(TIMER + FRMUL_CHILD, roots, json.dumps(FRMUL_SPLITS))
            lines = frmul_bounds(lines)
        print("\n".join(lines))
        print(json.dumps({"shapes_equal_across_roots": shapes, "roots": roots}))
        return print(card)
    if sys.argv[1:2] in (["--search"], ["--wordmul"], ["--narrow"]):
        child, sweep = {"--search": (SEARCH_CHILD, SEARCH_SWEEP),
                        "--wordmul": (WORDMUL_CHILD, WORDMUL_SWEEP),
                        "--narrow": (NARROW_CHILD, NARROW_SWEEP)}[sys.argv[1]]
        roots = sys.argv[2:] or ["."]
        shapes, lines = run_digests(TIMER + SHAPES_HELPERS + child, roots, json.dumps(sweep),
                                    bounds.__file__)
        print("\n".join(lines))
        print(json.dumps({"shapes_equal_across_roots": shapes, "roots": roots}))
        return print(card)
    if sys.argv[1:2] == ["--logup"]:
        return run_roots(TIMER + LOGUP_CHILD, sys.argv[2:] or ["."], card,
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
