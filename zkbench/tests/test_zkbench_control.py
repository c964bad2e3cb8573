"""Whole runs of a cell on the CPU at a small size (``run.run_cell`` with
``device="cpu"``, past the harness's look for a card): a sound run comes
out correct; the control (``control.py``: the host-scheduled groups
skipped) and each fault of the timed path a cell can have come out not
correct.  One card test runs a cell's command end to end."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkbench import control
from zkbench.run import run_cell

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
CHECKS = {"prologue": 2, "bytecode": 2, "keccak": 2, "sig": 2, "withdrawal": 1, "pi": 2}
SMALL = {"txs": 3, "faults": {"gas_left": 2, "stack_value": 2, "storage_value": 2,
                              "memory_value": 1, "end_tx_gas": 2, "tx_signature": 1,
                              "check_rows": CHECKS}}
CELL = "sstore_heavy_30m.repeat"


def run(patch=None, trace=False, traffic=None, seconds=0.01):
    return run_cell(CELL, 2**31 + 5, seconds, trace, device="cpu", config_override=SMALL,
                    patch=patch, traffic_override=traffic)


def test_a_sound_run_is_correct_and_its_last_line_has_the_keys():
    result, lines = run(trace=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["checks"]["trace_mismatch"] == {"value": 0, "limit": 0}
    assert result["checks"]["verdict_mismatch"] == {"value": 0, "limit": 0}
    assert result["verdicts"]["owed_failures"] == (2 * 2 + 2 * 2 + 2 * 2 + 2 + 2 + 1
                                                   + sum(CHECKS.values()))
    assert set(result["checks"]) == {"trace_mismatch", "verdict_mismatch"}
    assert {"trace_s", "build_s", "prepare_ms", "pass_ms", "host_groups_ms"} <= set(
        result["metrics"])
    assert lines[-1].startswith("check ")
    json.dumps(result)


@pytest.mark.parametrize("patch", ["control", "unchanged", "half_batch", "altered"])
def test_the_control_and_each_fault_come_out_not_correct(patch):
    result, _lines = run(patch=control.PATCHES[patch])
    assert not result["correct"]
    assert result["checks"]["verdict_mismatch"]["value"] >= 1
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("check", ["state", "copy", "tx"] + list(CHECKS))
def test_a_check_that_reports_no_failure_comes_out_not_correct(check):
    result, _lines = run(patch=control.silence(check))
    assert not result["correct"] and result["failed"] == result["attempted"]


@pytest.mark.parametrize("check", list(CHECKS))
def test_a_check_that_leaves_out_half_its_rows_comes_out_not_correct(check):
    """Either half left out misses a planted row where that half holds one
    (a check's faults go to both halves where its eligible rows do), and
    at least one half always holds one."""
    from zkbench.run import Block

    cfg = {**json.loads((ROOT / "zkbench/configs/sstore_heavy_30m.json").read_text()), **SMALL}
    block = Block(cfg, 2**31 + 5, "cpu", {})
    n = dict(block.bv.circuit_kernels)[check].n
    halves = {int(row >= n // 2) for c, row in block.check_rows if c == check}
    assert halves
    for half in (0, 1):
        result, _lines = run(patch=control.halve(check, half))
        assert result["correct"] == (half not in halves)


def test_fresh_blocks_are_made_traced_built_and_checked_one_a_verification():
    result, lines = run(traffic={"blocks": "fresh"}, seconds=0.05)
    assert result["correct"] and result["attempted"] >= 1
    assert result["verdicts"]["blocks"] == result["attempted"] + 1
    assert result["metrics"]["block_gas_per_s"]["value"] > 0
    bad, _lines = run(traffic={"blocks": "fresh"}, seconds=0.05, patch=control.silence("sig"))
    assert not bad["correct"] and bad["failed"] == bad["attempted"]


def test_a_tracer_that_alters_a_row_comes_out_not_correct(monkeypatch):
    from zkbench import run as harness

    traced = harness.program_block

    def altered(config, spec):
        witness = traced(config, spec)
        witness.rw.rws[-1]["value"] += 1      # EndBlock's cumulative gas read
        return witness

    monkeypatch.setattr(harness, "program_block", altered)
    result, _lines = run()
    assert not result["correct"] and result["checks"]["trace_mismatch"]["value"] == 1


def test_the_capture_bounds_every_kernel_call_of_a_verification():
    from zkbench.capture import Capture
    from zkbench.gen.blocks import block_spec
    from zkbench.run import _no_span, load_json, program_block, verification
    from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

    cfg = {**load_json(ROOT / "zkbench/configs/sstore_heavy_30m.json"), "txs": 2}
    bv = CompiledBlockVerifier(program_block(cfg, block_spec(cfg, 9)), device="cpu")
    with Capture(1.98e9, on=lambda t: True) as cap:
        verification(bv, ["prepare", "run_device"], {}, _no_span)
    assert {"limb_addsub", "lookup_gather_eq", "fr_mul", "state_order_lt", "lookup_search_eq",
            "lookup_fingerprint", "horner_rlc", "keccak_sponge"} <= set(cap.calls)
    assert 0 < cap.bound_ms < 1.0
    from zkevm_specs_tpu_torch.tables import engine

    assert engine.lookup_gather_eq.__name__ == "lookup_gather_eq"   # unwrapped again


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench")
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", CELL, "--seed", "3",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
