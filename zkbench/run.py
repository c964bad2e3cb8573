#!/usr/bin/env python3
"""zkbench: the benchmark of ``zkevm_specs_tpu_torch``'s block verifier.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One cell of ``BENCHMARK.json`` a process.  Set-up makes the block's txs
from the seed (``gen/blocks.py``), traces them with the port's tracer,
plants the configuration's faults (``faults.py``), builds
``CompiledBlockVerifier`` and runs one cold and two warm verifications.
The window then verifies for ``--seconds``, a closed loop of one client:
the next verification starts when the last one returns.  A verification
is the traffic's steps: ``prepare`` then ``run_device`` (the body of
``CompiledBlockVerifier.verify``), and ``lookups`` (``verify_lookups``)
where a mix names it.  The traffic's ``blocks`` says on what: ``repeat``
verifies the set-up's block again and again; ``fresh`` makes, traces and
builds a new block from the seed for each verification, as a user who
checks each block once does.

Then every verification's verdicts are held against what the plain
reference (``reference/``) says its block owes: the port's trace against
the reference's row for row, and each verification's failing lanes and
rows against the planted faults' (both limits 0).  The last line of
standard output is the result; with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, read after a profiled
stretch of verifications.  Without a card the run fails: it never falls
back to the CPU."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench import faults as fault_plan  # noqa: E402
from zkbench import readers  # noqa: E402
from zkbench.gen.blocks import block_spec  # noqa: E402
from zkbench.reference import evm, verdicts  # noqa: E402

PKG = "zkevm_specs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "zkevm_specs_tpu")
STEPS = ("prepare", "run_device", "lookups")
BLOCKS = ("repeat", "fresh")
# profiled verifications after the window: at least this many seconds of them
PROFILE_SECONDS = 2.0
HOST_GROUP_REPEATS = 5
WARM_UPS = 3


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"zkbench: no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if not set(traffic["steps"]) <= set(STEPS) or traffic["steps"][:2] != ["prepare", "run_device"]:
        raise SystemExit(f"zkbench: traffic {cell['traffic']!r} steps {traffic['steps']}")
    if traffic["arrivals"] != "closed" or traffic["clients"] != 1:
        raise SystemExit("zkbench: only a closed loop of one client is driven")
    if traffic["blocks"] not in BLOCKS:
        raise SystemExit(f"zkbench: traffic {cell['traffic']!r} blocks {traffic['blocks']!r}")
    return cell, config, traffic


def metrics_of(bench: dict, kind: str, workload: str):
    """The cell's metrics of ``kind``: those that name it or name no cell;
    a per-layer one only where the cell reports the metric it moves."""
    ends = [m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])
            and (kind == "end_to_end" or m["moves"] in ends)]


def card_info():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    name, limit, clock = (s.strip() for s in out.stdout.splitlines()[0].split(","))
    return {"name": name, "power_limit_w": float(limit), "sm_clock_max_hz": float(clock) * 1e6}


def program_block(config: dict, spec):
    """The block's txs as the port's objects, traced by the port."""
    from zkevm_specs_tpu_torch.witness.tracer import trace_block
    from zkevm_specs_tpu_torch.witness.typing import Block, Bytecode, Transaction

    txs = [(Transaction(id=t.id, gas=t.gas, gas_price=t.gas_price, caller_address=0xFE,
                        callee_address=t.callee), Bytecode(bytearray(t.code))) for t in spec]
    return trace_block(Block(**config["header"]), txs, caller_balance=config["caller_balance"])


def verification(bv, steps, spans, record_function):
    """One verification: the traffic's steps, each in a span; returns its
    verdicts as (failing keys, lookup verdicts)."""
    a = time.perf_counter()
    with record_function("zkbench.prepare"):
        prepared = bv.prepare()
    b = time.perf_counter()
    with record_function("zkbench.run_device"):
        failures = bv.run_device(prepared)
    c = time.perf_counter()
    lookups = None
    if "lookups" in steps:
        with record_function("zkbench.lookups"):
            lookups = bv.verify_lookups(prepared)
        spans.setdefault("lookups", []).append(time.perf_counter() - c)
    del prepared
    d = time.perf_counter()
    spans.setdefault("prepare", []).append(b - a)
    spans.setdefault("run_device", []).append(c - b)
    spans.setdefault("verify", []).append(d - a)
    return frozenset(failures), None if lookups is None else tuple(sorted(lookups.items()))


def _no_span(_name):
    return contextlib.nullcontext()


class Block:
    """One block of the cell: its txs and faults from ``seed``, traced and
    built by the port (the times in ``spans``), its circuit-check faults
    planted, ``patch`` applied to the verifier."""

    def __init__(self, config, seed, device, spans, patch=None):
        from zkevm_specs_tpu_torch.circuits.tx import sign_tx
        from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

        self.spec = block_spec(config, seed)
        self.planted = fault_plan.choose(config, seed)
        t = time.perf_counter()
        witness = program_block(config, self.spec)
        b = time.perf_counter()
        fault_plan.plant(witness, self.planted, sign_tx)
        c = time.perf_counter()
        self.bv = CompiledBlockVerifier(witness, device=device)
        d = time.perf_counter()
        self.check_rows = fault_plan.plant_checks(self.bv, self.planted)
        if patch is not None:
            patch(self.bv)
        self.steps, self.rws = witness.steps, witness.rw.rws
        spans.setdefault("trace", []).append(b - t)
        spans.setdefault("build", []).append(d - c)

    def mismatches(self, config, seen):
        """The trace mismatch of the block's witness against the
        reference's, and each of ``seen``'s verdict mismatches against what
        the reference says the block owes: the keys a verification reports
        and the block does not owe, those it owes and misses, and each
        lookup family that fails (the faults change table rows, which the
        steps look up by index, so every family holds)."""
        ref = evm.trace(self.spec, config["header"]["coinbase"], config["header"]["base_fee"],
                        config["caller_balance"])
        owed = (frozenset(verdicts.expected_failures(ref, self.planted))
                | verdicts.check_failures(self.check_rows))
        verdicts.plant(ref, self.planted)
        self.gas, self.owed = ref.gas, len(owed)
        return compare_rows(self.steps, self.rws, ref), [
            len(keys ^ owed) + (0 if lookups is None else
                                sum(not ok for _f, ok in lookups) + (not lookups))
            for keys, lookups in seen]


class WindowProbe:
    """What the host did in the window besides the verifications: the
    collector's pauses (``gc.callbacks``), the main thread's CPU time, its
    wait for a CPU (``/proc/self/schedstat``) and the machine's stolen time
    (``/proc/stat``), read around the window and printed on standard error."""

    def __init__(self):
        self.on, self.pauses, self._t = False, [], {}

    def _gc(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t[info["generation"]] = time.perf_counter()
        elif info["generation"] in self._t:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t.pop(info["generation"])))

    @staticmethod
    def _read():
        out = {"cpu": time.thread_time(), "wall": time.perf_counter()}
        for key, path, field, scale in (("wait", "/proc/self/schedstat", 1, 1e9),
                                        ("steal", "/proc/stat", 8, os.sysconf("SC_CLK_TCK"))):
            try:
                out[key] = int(Path(path).read_text().split("\n")[0].split()[field]) / scale
            except (OSError, IndexError, ValueError):
                pass
        return out

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self.start, self.on = self._read(), True
        return self

    def __exit__(self, *exc):
        self.on, self.end = False, self._read()
        gc.callbacks.remove(self._gc)

    def line(self) -> str:
        d = {k: self.end[k] - self.start[k] for k in self.start if k in self.end}
        by_gen = [sum(t for g, t in self.pauses if g == gen) for gen in range(3)]
        counts = [sum(g == gen for g, _t in self.pauses) for gen in range(3)]
        t = time.perf_counter()
        x = 0
        for i in range(1_000_000):
            x += i
        probe = time.perf_counter() - t
        return (f"window host: wall {d['wall']:.3f} s, main thread cpu {d['cpu']:.3f} s, "
                f"cpu wait {d.get('wait', float('nan')):.3f} s, machine steal "
                f"{d.get('steal', float('nan')):.2f} s; gc collections gen0/1/2 "
                f"{counts[0]}/{counts[1]}/{counts[2]}, paused {by_gen[0]:.3f}/{by_gen[1]:.3f}/"
                f"{by_gen[2]:.3f} s, longest {max((t for _g, t in self.pauses), default=0):.3f} s;"
                f" python probe {1e3 * probe:.1f} ms")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config_override: dict = None, patch=None, traffic_override: dict = None):
    """Set-up, window and checks of one cell; returns (result, check lines).
    ``device`` and the overrides let the tests drive a run on the CPU at a
    small size or with another traffic; ``patch(verifier)``, applied to
    each verifier once it is built, lets the control and the tests break
    the timed path."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_of(bench, workload)
    config = {**config, **(config_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    steps, fresh = traffic["steps"], traffic["blocks"] == "fresh"
    setup_spans: dict = {}
    block = Block(config, f"{seed}.0" if fresh else seed, device, setup_spans, patch)
    blocks = [block]
    seen = [[]]         # each block's verifications' verdicts
    warm_spans: dict = {}
    # the cold verification (its prepare packs the state rows), then two warm ones
    for _ in range(WARM_UPS):
        seen[0].append(verification(block.bv, steps, warm_spans, _no_span))
    if on_card:
        torch.cuda.synchronize()
    setup = {"trace": setup_spans["trace"][0], "build": setup_spans["build"][0],
             "total": time.perf_counter() - T0}
    # the peak over the set-up: the build and a fixed count of verifications
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"zkbench: JAX modules loaded after set-up: {found}")

    spans: dict = {}
    verify_cpu = []
    with WindowProbe() as probe:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            c0 = time.thread_time()
            if fresh:
                block.bv = None             # the last block's verifier goes first
                t = time.perf_counter()
                block = Block(config, f"{seed}.{len(blocks)}", device, spans, patch)
                blocks.append(block)
                seen.append([])
            seen[-1].append(verification(block.bv, steps, spans, _no_span))
            if fresh:
                spans["verify"][-1] = time.perf_counter() - t
            verify_cpu.append(time.thread_time() - c0)
        window_s = time.perf_counter() - t_start
    attempted = len(spans["verify"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    record = {"setup": setup, "spans": spans, "profile": None, "bound_ms": None}
    info = card_info() if on_card else {}
    if trace:
        bv = block.bv
        record["spans"] = {**spans, "host_groups": []}
        for _ in range(HOST_GROUP_REPEATS):
            t = time.perf_counter()
            bv.host_group_fails()
            record["spans"]["host_groups"].append(time.perf_counter() - t)
        if on_card:
            record["profile"] = profiled(bv, steps, seen[-1], statistics.fmean(spans["verify"]))
            record["bound_ms"] = captured_bound(bv, steps, seen[-1], info["sm_clock_max_hz"])
        del bv

    # the program's state goes before the reference runs
    for b in blocks:
        b.bv = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    trace_mismatch, mismatch = 0, []
    for b, verified in zip(blocks, seen):
        t_bad, v_bad = b.mismatches(config, verified)
        trace_mismatch += t_bad
        mismatch += v_bad
    checks = {
        "trace_mismatch": {"value": trace_mismatch, "limit": 0},
        "verdict_mismatch": {"value": max(mismatch), "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"zkbench: JAX modules loaded after the window: {found}")

    # the gas of each verification in the window, by the reference's reckoning
    gas = sum(b.gas for b in blocks[1:]) if fresh else attempted * block.gas
    metrics = {}
    if trace:
        for m in metrics_of(bench, "per_layer", workload):
            v = readers.read(record, load_json(HERE / "metrics" / f"{m['name']}.json"))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "block_gas_per_s": gas / window_s,
            "peak_device_gib": peak_setup / 2 ** 30,
            "setup_s": setup["total"],
        }
        for m in metrics_of(bench, "end_to_end", workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"] if on_card else 0, "memory_peak_bytes": peak}
    window = mismatch[WARM_UPS:WARM_UPS + attempted]
    result = {"correct": correct, "attempted": attempted, "failed": sum(m > 0 for m in window),
              "metrics": metrics, "device": dev}
    if trace and record["profile"]:
        p = record["profile"]
        dev.update(busy_s=p["busy_s"], window_s=p["window_s"])
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    result["card"] = info
    result["verdicts"] = {"checked": len(mismatch), "blocks": len(blocks),
                          "owed_failures": blocks[-1].owed}
    result["checks"] = checks
    quart = lambda v: " ".join(f"{1e3 * x:.1f}" for x in (  # noqa: E731
        [v[0], min(v)] + (statistics.quantiles(v, n=4) if len(v) > 1 else []) + [max(v)]))
    lines = [f"zkbench {workload} seed {seed}: {attempted} verifications in {window_s:.3f} s, "
             f"{len(mismatch)} verifications of {len(blocks)} block(s) checked, "
             f"{blocks[-1].owed} failing lanes and rows owed, block gas {blocks[-1].gas}, "
             f"setup {setup}, peak {peak_setup} bytes after set-up, {peak} in all",
             f"verify_p95_ms over {attempted} verifications",
             "verify_ms first, min, quartiles, max: " + quart(spans["verify"]),
             "verify_cpu_ms first, min, quartiles, max: " + quart(verify_cpu),
             probe.line()]
    lines += [f"check {k} {c['value']} limit {c['limit']}" for k, c in checks.items()]
    return result, lines


def profiled(bv, steps, seen, verify_s):
    """Verifications under torch.profiler for PROFILE_SECONDS or more, the
    first of them not read; their device summary (``profile.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from zkbench.profile import events_of, kernel_symbols, summarize

    n = max(2, int(PROFILE_SECONDS / max(verify_s, 1e-3)) + 1)
    spans: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n + 1):
            seen.append(verification(bv, steps, spans, record_function))
        torch.cuda.synchronize()
    t = time.perf_counter()
    summary = summarize(events_of(prof), kernel_symbols(ROOT / PKG / "csrc"), n)
    print(f"zkbench: profiled {n + 1} verifications, read in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    return summary


def captured_bound(bv, steps, seen, clock_hz):
    """The summed bound of one verification's hand-written kernel calls:
    each wrapper call's (``capture.py``) and K9's, from the upload."""
    from zkbench.capture import Capture
    from zkbench.costs.models import unpack_bound_ms

    with Capture(clock_hz) as cap:
        seen.append(verification(bv, steps, {}, _no_span))
    return cap.bound_ms + unpack_bound_ms(bv.upload_stats)


def compare_rows(steps, rws, ref) -> int:
    """Differing steps and rw rows between the port's witness (its
    ``steps`` and ``rw.rws``) and the reference's trace, and the difference
    of their counts."""
    bad = abs(len(steps) - len(ref.steps)) + abs(len(rws) - len(ref.rws))
    for s, r in zip(steps, ref.steps):
        got = (s.execution_state.name,) + tuple(getattr(s, k) for k in evm.STEP_FIELDS[1:])
        bad += got != r
    for row, r in zip(rws, ref.rws):
        bad += tuple(row[k] for k in evm.ROW_FIELDS) != r
    return bad


def compare_trace(witness, ref) -> int:
    return compare_rows(witness.steps, witness.rw.rws, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PKG).is_dir():
        print(f"zkbench: the port ({PKG}/) is not in {ROOT}", file=sys.stderr)
        return 2
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_of(bench, args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zkbench: {args.workload} needs {chips} card(s); "
              f"cuda available {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
