"""The port's profiling hooks (zkevm_specs_tpu_torch.runtime.profiling)
against the JAX package's: after one ``run_device`` of a small block (a
device group of ADD lanes, host groups, the state check and every circuit),
``STATS`` holds the labels and call counts that the JAX verifier's
``run_device`` adds on the same witness, and ``report()`` has the JAX
report's JSON shape; ``device_trace`` on the CPU writes a Chrome trace and
``annotate`` names a range in it.  The JAX ``run_device`` runs with its
checks stubbed to all-pass vectors (no XLA compile): what is compared is
its instrumentation."""
import json

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.runtime import block as jblock
from zkevm_specs_tpu.runtime import profiling as jprof
from zkevm_specs_tpu.runtime.jit import CompiledGroupVerifier as JVerifier
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.runtime import profiling
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

torch.set_num_threads(1)


def _witness(T, Y):
    bc = Y.Bytecode()
    for j in range(6):
        bc.push1(j).push1(j + 1).add().pop()
    bc.stop()
    tx = Y.Transaction(id=1, gas=100000, gas_price=int(2e9), caller_address=0xFE,
                       callee_address=0xFF)
    return T.trace_block(Y.Block(base_fee=int(1e9)), [(tx, bc)])


def _jax_stats(monkeypatch):
    """The JAX ``run_device``'s STATS on the witness, its checks stubbed."""
    bv = jblock.CompiledBlockVerifier(_witness(JT, JY))
    monkeypatch.setattr(JVerifier, "__call__",
                        lambda self, curr, *a: np.zeros(len(next(iter(curr.values()))), bool))
    prepared = {
        "groups": [None if g["verifier"] is None else ({"x": np.zeros(len(g["curr"]))},)
                   for g in bv.groups],
        "state_fn": lambda: np.zeros(len(bv._state_rows), bool),
        "state_args": (),
        "circuits": [(name, lambda _a, n=k.n: np.zeros(n, bool), None)
                     for name, k in bv.circuit_kernels],
    }
    stats = jprof.KernelStats()
    monkeypatch.setattr(jprof, "STATS", stats)
    assert bv.run_device(prepared) == {}
    return stats, bv


@pytest.fixture(scope="module")
def port_run():
    stats = profiling.KernelStats()
    bv = CompiledBlockVerifier(_witness(PT, PY), device="cpu")
    prepared = bv.prepare()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "STATS", stats)
        failures = bv.run_device(prepared)
    return stats, bv, failures


def test_stats_labels_and_calls_match_jax(port_run, monkeypatch):
    stats, bv, failures = port_run
    assert failures == {}
    jstats, jbv = _jax_stats(monkeypatch)
    assert dict(stats.calls) == dict(jstats.calls)
    assert set(stats.times) == set(jstats.times)
    # a device group of ADD lanes, host groups, the state check, the circuits
    assert stats.calls["evm:ADD"] == 1 and stats.calls["state"] == 1
    assert any(k.startswith("host:") for k in stats.calls)
    assert {n for n, _ in bv.circuit_kernels} <= set(stats.calls)
    assert all(v >= 0 for v in stats.times.values())


def test_report_has_the_jax_shape(port_run, monkeypatch):
    stats, _, _ = port_run
    jstats, _ = _jax_stats(monkeypatch)
    rows, jrows = json.loads(stats.report()), json.loads(jstats.report())
    assert [list(r) for r in rows] == [list(r) for r in jrows]
    assert [r["seconds"] for r in rows] == sorted((r["seconds"] for r in rows), reverse=True)
    assert {r["kernel"]: r["calls"] for r in rows} == {r["kernel"]: r["calls"] for r in jrows}
    assert stats.device_times == {}    # no region ran on the card


def test_timed_accumulates_and_reset_clears():
    stats = profiling.KernelStats()
    for _ in range(3):
        with stats.timed("a"):
            pass
    with pytest.raises(ValueError):
        with stats.timed("b"):
            raise ValueError
    assert dict(stats.calls) == {"a": 3, "b": 1}
    stats.reset()
    assert not stats.calls and not stats.times and json.loads(stats.report()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as path:
        with profiling.annotate("zkevm-region"):
            torch.ones(64).sum()
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "zkevm-region" for e in trace["traceEvents"])


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: each pair spans 2 ms;
    ``done`` says whether the card has reached it."""
    done = True

    def __init__(self, enable_timing=False):
        self.synced = False

    def record(self):
        pass

    def query(self):
        return _FakeEvent.done or self.synced

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.query(), "read before its end event completed"
        return 2.0


def test_device_events_are_folded_and_dropped(monkeypatch):
    """Each pair of events leaves ``KernelStats`` once its end event has
    completed (seen without waiting, at the next region) or in ``report()``,
    which waits for the rest: a long-running verifier holds only the pairs
    still in flight."""
    monkeypatch.setattr(profiling.torch.cuda, "Event", _FakeEvent)
    stats = profiling.KernelStats()
    for _ in range(1000):
        with stats.timed("a", "cuda"):
            pass
    assert len(stats._pending) == 0
    assert stats.device_times["a"] == pytest.approx(2.0)
    monkeypatch.setattr(_FakeEvent, "done", False)
    for _ in range(5):
        with stats.timed("b", "cuda"):
            pass
    assert len(stats._pending) == 5 and "b" not in stats.device_times
    json.loads(stats.report())
    assert len(stats._pending) == 0
    assert stats.device_times["b"] == pytest.approx(0.01)
    assert dict(stats.calls) == {"a": 1000, "b": 5}
