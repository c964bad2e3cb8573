"""The port's communication model (zkevm_specs_tpu_torch.parallel.comm_model)
against the JAX package's: on the same traced block, the byte legs that
take no restated constant (the EVM verdicts, the state verdicts, the
producer verdicts and the count of logUp all_reduces) equal the JAX
model's, and with the JAX model's constants put in, every leg, the compute
and the predicted efficiency equal it, so the JAX weak-scaling test's
properties hold for the port's model too.  The restated constants (K1's
operations, the packed state row, the H100's rates) are left out of the
comparison."""
import pytest
import torch

from zkevm_specs_tpu.parallel import comm_model as jcm
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.parallel import comm_model as pcm
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

torch.set_num_threads(1)


def _witness(T, Y):
    callee = Y.Bytecode().push1(0x55).push1(0x09).sstore().push1(0).push1(0).revert()
    bc = Y.Bytecode()
    for j in range(20):
        bc.push1(j).push1(j + 1).add().pop()
    bc.push1(8).push1(0).push1(0).calldatacopy()
    bc.push1(3).push1(2).exp().pop()
    bc.push1(0).push1(0).push1(0).push1(0).push1(0).push2(0x5000).push2(0xFFFF).call().pop()
    bc.stop()
    tx = Y.Transaction(id=1, gas=200000, gas_price=int(2e9), caller_address=0xFE,
                       callee_address=0xFF, call_data=bytes(range(8)))
    return T.trace_block(Y.Block(base_fee=int(1e9)), [(tx, bc)],
                         accounts={0x5000: Y.Account(address=0x5000, code=callee)})


@pytest.fixture(scope="module")
def witnesses():
    return _witness(JT, JY), _witness(PT, PY)


@pytest.fixture
def jax_constants(monkeypatch):
    monkeypatch.setattr(pcm, "U32_OPS_PER_FR_MUL", jcm.U32_OPS_PER_FR_MUL)
    monkeypatch.setattr(pcm, "LOGUP_PSUM_BYTES", jcm.LOGUP_PSUM_BYTES)
    monkeypatch.setattr(pcm, "state_row_bytes", lambda: jcm.STATE_ROW_BYTES)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_byte_legs_match_jax(witnesses, n):
    jw, pw = witnesses
    j, p = jcm.model_from_witness(jw, n), pcm.model_from_witness(pw, n)
    assert p.producer_rows == j.producer_rows and p.producer_rows["exp"] > 0
    assert (p.n_steps, p.n_rw_rows) == (j.n_steps, j.n_rw_rows)
    assert p.evm_verdict_bytes == j.evm_verdict_bytes
    assert p.producer_verdict_bytes == j.producer_verdict_bytes
    assert (p.state_halo_bytes - (n - 1) * pcm.state_row_bytes()
            == j.state_halo_bytes - (n - 1) * jcm.STATE_ROW_BYTES)
    assert p.logup_bytes // pcm.LOGUP_PSUM_BYTES == j.logup_bytes // jcm.LOGUP_PSUM_BYTES


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_model_equals_jax_on_its_constants(witnesses, n, jax_constants):
    jw, pw = witnesses
    j, p = jcm.model_from_witness(jw, n), pcm.model_from_witness(pw, n)
    assert p.total_comm_bytes == j.total_comm_bytes
    assert p.total_u32_ops == j.total_u32_ops
    tpu = dict(chip_u32_ops_per_s=7.1e12, link_bytes_per_s=4.5e10, latency_s=5e-6)
    assert (p.predicted_weak_efficiency(**tpu)
            == j.predicted_weak_efficiency(7.1e12, 4.5e10, 5e-6))


def test_weak_scaling_properties(jax_constants):
    """tests/test_sharding.py:test_comm_model_weak_scaling_bound's
    properties, on the JAX model's constants."""
    tpu = dict(chip_u32_ops_per_s=7.1e12, link_bytes_per_s=4.5e10, latency_s=5e-6)
    weak = pcm.CommModel(n_devices=8, n_steps=352_000 * 8, n_rw_rows=1_056_000 * 8,
                         n_constraints_per_step=29, n_logup_families=10)
    assert weak.predicted_weak_efficiency(**tpu) > 0.85
    weak64 = pcm.CommModel(n_devices=64, n_steps=352_000 * 64, n_rw_rows=1_056_000 * 64,
                           n_constraints_per_step=29, n_logup_families=10)
    assert abs(weak64.predicted_weak_efficiency(**tpu) - weak.predicted_weak_efficiency(**tpu)) < 0.01
    small_strong = pcm.CommModel(n_devices=64, n_steps=8_000, n_rw_rows=12_000,
                                 n_constraints_per_step=29, n_logup_families=10)
    assert small_strong.predicted_weak_efficiency(**tpu) < 0.5


def test_restated_constants_are_the_ports():
    from zkevm_specs_tpu_torch.circuits.state import StateRows
    from zkevm_specs_tpu_torch.runtime import bounds

    assert pcm.U32_OPS_PER_FR_MUL == bounds.fr_product_ops(8, 8)
    assert pcm.state_row_bytes() % 8 == 0
    assert pcm.state_row_bytes() // 8 >= len(StateRows._BITS) + 2 * len(StateRows._WORDS)
    m = pcm.CommModel(n_devices=8, n_steps=352_000 * 8, n_rw_rows=1_056_000 * 8,
                      n_constraints_per_step=29, n_logup_families=10)
    # the H100 defaults: the same compute over the card's int32 rate
    t_compute = m.ops_per_device / bounds.INT32_OPS_PER_S
    t_comm = m.total_comm_bytes / 8 / pcm.NVLINK_BYTES_PER_S
    assert m.predicted_weak_efficiency() == pytest.approx(
        t_compute / (t_compute + t_comm + 40 * pcm.COLLECTIVE_LATENCY_S), rel=0, abs=0)
