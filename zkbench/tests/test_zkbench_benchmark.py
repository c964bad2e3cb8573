"""BENCHMARK.json against the benchmark's contract, the files the harness
finds by name, the block generator, the readers, the trace summary and the
import rules.  CPU only, seconds."""
import ast
import json
import re
from pathlib import Path

import pytest

from zkbench import faults, readers
from zkbench.gen.blocks import block_spec
from zkbench.profile import kernel_symbols, summarize
from zkbench.reference import evm

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "zkbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = ("block_gas_per_s", "peak_device_gib", "setup_s")
PER_LAYER = ("trace_s", "build_s", "verify_p95_ms", "prepare_ms", "pass_ms", "host_groups_ms",
             "kernels_roofline", "kernel_launches", "torch_kernel_ms", "device_idle_share")


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "zkbench/run.py"]
    assert BENCH["paths"] == ["zkbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [e["name"] for e in BENCH[kind]]
        assert len(kind_names) == len(set(kind_names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs_cells_and_metrics():
    assert [c["name"] for c in BENCH["configs"]] == ["alu_heavy_1m", "sstore_heavy_30m"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"zkbench/configs/{c['name']}.json"
        assert config(c["name"])["reduced"] == c["reduced"]
        assert config(c["name"])["source"] == c["source"]
    assert [c["reduced"] for c in BENCH["configs"]] == [["txs"], []]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert [m["name"] for m in BENCH["end_to_end"]] == list(E2E)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in BENCH["per_layer"]] == list(PER_LAYER)
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        spec = json.loads((HERE / "metrics" / f"{m['name']}.json").read_text())
        assert spec["reader"] in readers.READERS
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers["kernels"] == ["kernels_roofline", "kernel_launches"]


@pytest.mark.parametrize("name,steps,gas,rows", [("alu_heavy_1m", 352025, 1136000, 528369),
                                                 ("sstore_heavy_30m", 12999, 29949526, 48889)])
def test_generators_at_the_published_shapes(name, steps, gas, rows):
    cfg = config(name)
    spec = block_spec(cfg, 2**33 + 11)
    trace = evm.trace(spec, cfg["header"]["coinbase"], cfg["header"]["base_fee"],
                      cfg["caller_balance"])
    assert (len(trace.steps), trace.gas, len(trace.rws)) == (steps, gas, rows)
    assert (cfg["steps"], cfg["gas"], cfg["rw_rows"]) == (steps, gas, rows)


@pytest.mark.parametrize("name", ["alu_heavy_1m", "sstore_heavy_30m"])
def test_generators_follow_the_seed(name):
    cfg = config(name)
    a, b, c = block_spec(cfg, 7), block_spec(cfg, 7), block_spec(cfg, 8)
    assert [t.code for t in a] == [t.code for t in b]
    assert [t.code for t in a] != [t.code for t in c]
    assert [len(t.code) for t in a] == [len(t.code) for t in c]
    assert faults.choose(cfg, 7) == faults.choose(cfg, 7) != faults.choose(cfg, 8)
    if cfg["code"] == "shared":
        assert len({t.code for t in a}) == 1


def test_sstore_operands_stay_cold_sets():
    cfg = config("sstore_heavy_30m")
    slots, values = [], []
    for tx in block_spec(cfg, 2**31 + 3):
        prog = evm.disassemble(tx.code)
        for k, (_pc, name, imm) in enumerate(prog):
            if name == "SSTORE":
                slots.append(prog[k - 1][2])
                values.append(prog[k - 2][2])
    assert len(slots) == len(set(slots)) == 194 * 6 and min(values) >= 1
    assert sum(t.gas for t in block_spec(cfg, 1)) > cfg["header"]["gas_limit"] - cfg["tx_gas"]


def test_faults_sit_apart_and_reach_every_circuit_check():
    for name in ("alu_heavy_1m", "sstore_heavy_30m"):
        cfg = config(name)
        checks = cfg["faults"]["check_rows"]
        assert set(checks) == {"prologue", "bytecode", "keccak", "sig", "withdrawal", "pi"}
        for seed in (1, 2, 2**32 + 1):
            fs = faults.choose(cfg, seed)
            steps = sorted(f.step for f in fs if f.step >= 0)
            n = sum(v for v in cfg["faults"].values() if isinstance(v, int))
            assert len(fs) == n + sum(checks.values())
            assert all(b - a >= 2 for a, b in zip(steps, steps[1:]))
            assert [f.half for f in fs if f.check == "sig"] == [0, 1]


def test_traffic_files():
    from zkbench.run import BLOCKS, STEPS

    for path in sorted((HERE / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        assert set(t) == {"arrivals", "clients", "blocks", "steps"}, path
        assert t["arrivals"] == "closed" and t["clients"] == 1 and t["blocks"] in BLOCKS
        assert t["steps"][:2] == ["prepare", "run_device"] and set(t["steps"]) <= set(STEPS)
    assert json.loads((HERE / "traffic" / "fresh.json").read_text())["blocks"] == "fresh"


def test_a_cell_reads_the_metrics_that_name_it():
    from zkbench.run import metrics_of

    bench = {"end_to_end": [{"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "pass_ms", "moves": "rate"},
                           {"name": "build_s", "moves": "setup_s"},
                           {"name": "only_b", "moves": "setup_s", "workloads": ["b"]}]}
    assert [m["name"] for m in metrics_of(bench, "end_to_end", "a")] == ["rate", "setup_s"]
    assert [m["name"] for m in metrics_of(bench, "end_to_end", "b")] == ["setup_s"]
    assert [m["name"] for m in metrics_of(bench, "per_layer", "a")] == ["pass_ms", "build_s"]
    assert [m["name"] for m in metrics_of(bench, "per_layer", "b")] == ["build_s", "only_b"]
    for w in BENCH["workloads"]:
        ends = {m["name"] for m in metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in ends and len(ends) >= 2
        assert metrics_of(BENCH, "per_layer", w["name"])


def test_readers():
    rec = {"setup": {"trace": 2.0}, "spans": {"verify": [0.1 * i for i in range(1, 101)],
                                               "prepare": [0.5, 1.5]},
           "profile": {"window_s": 2.0, "busy_s": 0.5, "own_ms": 4.0, "own_launches": 10.0},
           "bound_ms": 1.0}
    assert readers.read(rec, {"reader": "setup_phase", "phase": "trace"}) == 2.0
    assert readers.read(rec, {"reader": "setup_phase", "phase": "build"}) is None
    assert readers.read(rec, {"reader": "span_mean", "span": "prepare", "scale": 1000.0}) == 1000.0
    assert readers.read(rec, {"reader": "span_quantile", "span": "verify", "q": 0.95}) == \
        pytest.approx(9.505)
    assert readers.read(rec, {"reader": "idle_share"}) == 75.0
    assert readers.read(rec, {"reader": "roofline"}) == 25.0
    assert readers.read({**rec, "profile": None}, {"reader": "roofline"}) is None


def test_summary_of_a_trace():
    symbols = kernel_symbols(ROOT / "zkevm_specs_tpu_torch" / "csrc")
    assert "limb_addsub_kernel" in symbols and "leaf_unpack_kernel" in symbols
    ev = []
    for v in range(3):            # three verifications of 100 us, the first not read
        t = 1000.0 * v
        ev += [{"name": "zkbench.prepare", "device_type": "cpu", "start": t, "end": t + 40},
               {"name": "zkbench.run_device", "device_type": "cpu", "start": t + 40,
                "end": t + 100},
               {"name": "void leaf_unpack_kernel(unsigned char const*)", "device_type": "cuda",
                "start": t + 30, "end": t + 35},
               {"name": "void (anonymous namespace)::limb_addsub_kernel<2, 17, true>(Args)",
                "device_type": "cuda", "start": t + 50, "end": t + 60},
               {"name": "void at::native::reduce_kernel<512, 1>(int)", "device_type": "cuda",
                "start": t + 70, "end": t + 72},
               {"name": "Memcpy DtoH (Device -> Pageable)", "device_type": "cuda",
                "start": t + 90, "end": t + 91},
               {"name": "zkbench.run_device", "device_type": "cuda", "start": t + 50,
                "end": t + 91}]
    s = summarize(ev, symbols, 2)
    assert s["own_launches"] == 2 and s["own_ms"] == pytest.approx(0.015)
    assert s["library_ms"] == pytest.approx(0.002)
    assert s["window_s"] == pytest.approx(1100e-6)
    assert s["busy_s"] == pytest.approx(36e-6)
    assert s["device_ops"][0][0] == "limb_addsub_kernel"
    assert s["idle_gaps"][0][0] == "between"
    assert {g[0] for g in s["idle_gaps"]} == {"prepare", "run_device", "between"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_no_port():
    for src in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(src)}
        assert not tops & {"jax", "jaxlib", "flax", "zkevm_specs_tpu"}, src
    from zkbench.capture import CAPTURES

    assert {module.split(".")[0] for _k, module, _a in CAPTURES} == {"zkevm_specs_tpu_torch"}
    for src in (HERE / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(src)}
        assert not tops & {"zkevm_specs_tpu_torch", "torch", "zkbench"}, src


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import sys

    from zkbench import run

    monkeypatch.setitem(sys.modules, "zkevm_specs_tpu_torch_probe", sys)
    assert not [m for m in run.forbidden_modules() if m.startswith("zkevm_specs_tpu_torch")]
    monkeypatch.setitem(sys.modules, "zkevm_specs_tpu.probe", sys)
    assert run.forbidden_modules() == ["zkevm_specs_tpu.probe"]
