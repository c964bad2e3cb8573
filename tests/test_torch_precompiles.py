"""The port's precompile gadgets, ecc circuit and BN254 arithmetic
(zkevm_specs_tpu_torch.evm.execution.precompiles, errors.error_oog_precompile,
circuits/ecc.py, ops/ecc/bn254.py) against the JAX package, on the CPU,
tolerance 0.

Every vector of tests/evm/test_precompiles.py and test_precompiles_more.py
runs as that file's own test body with its ``Tables`` and ``verify_steps``
intercepted (``test_torch_flow_context.run_case``): both packages' spec
failure dicts equal key for key and message for message.  One vector of
each precompile state is replayed on the port's ``CompiledGroupVerifier``
at 8 lanes, and ecRecover's host RLC loop runs once a prepare (the eager
pass), never in a replay.  Every body of tests/test_ecc_circuit.py and the
BN254 bodies of tests/test_crypto.py run on the port's modules (the ecc
bodies' circuits also through the JAX ``verify_circuit`` and
``ecc_table_rows``, equal); the Miller loop, the final exponentiation and
the scalar multiplications equal the JAX ones on seeded inputs; the port's
``EXECUTION_STATE_IMPL`` has every state of the JAX one; the tracer's
precompile gas equals the JAX tracer's."""
import random

import pytest
import torch

import test_torch_flow_context as FC  # puts tests/evm on the path
import test_crypto  # noqa: E402
import test_ecc_circuit  # noqa: E402
import test_precompiles  # noqa: E402
import test_precompiles_more  # noqa: E402
from zkevm_specs_tpu.circuits import ecc as jecc  # noqa: E402
from zkevm_specs_tpu.evm.execution import EXECUTION_STATE_IMPL as JAX_IMPL  # noqa: E402
from zkevm_specs_tpu.ops.ecc import bn254 as jbn  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu_torch.circuits import ecc as pecc  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution import EXECUTION_STATE_IMPL  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution import precompiles  # noqa: E402
from zkevm_specs_tpu_torch.ops.ecc import bn254  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402

torch.set_num_threads(1)

CASES = FC._cases(((test_precompiles, None), (test_precompiles_more, None)))


def _run(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    return FC.run_case(module, fn, kwargs, monkeypatch)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_precompile_vectors_match_jax(case, monkeypatch):
    _run(case, monkeypatch)


def test_every_vector_is_collected():
    assert len(CASES) == 6


# one vector of each precompile state
REPLAYED = [
    ("BN254_ADD", "test_precompiles.test_ec_add_precompile[0]"),
    ("BN254_SCALAR_MUL", "test_precompiles_more.test_ec_mul_precompile[0]"),
    ("BN254_PAIRING", "test_precompiles_more.test_ec_pairing_precompile_empty_input[0]"),
    ("ECRECOVER", "test_precompiles_more.test_ec_recover_precompile[0]"),
    ("DATACOPY", "test_precompiles_more.test_data_copy_precompile[0]"),
]


@pytest.mark.parametrize("state,case", REPLAYED)
def test_replay_matches_spec(state, case, monkeypatch):
    (ptables, psteps, want), = [c for c in _run(case, monkeypatch)
                                if c[1][0].execution_state.name == state][:1]
    monkeypatch.undo()
    assert FC.replay_fails(ptables, psteps) == (list(range(FC.REPLAY_LANES)) if want else [])


def test_replay_covers_every_precompile_state():
    assert {s for s, _ in REPLAYED} == {
        s.name for s in EXECUTION_STATE_IMPL
        if EXECUTION_STATE_IMPL[s].__module__ == precompiles.__name__}


def test_ecrecover_rlc_loop_runs_once_a_prepare(monkeypatch):
    """ecRecover's input and output RLCs are host work: the eager pass
    computes them once a lane (a prepare's host pass), the replay never
    (one placeholder through ``Instruction.host_ints``), and the replay
    still fails exactly the lanes spec mode fails."""
    (ptables, psteps, want), = _run("test_precompiles_more.test_ec_recover_precompile[0]",
                                    monkeypatch)
    monkeypatch.undo()
    calls = []
    for name in ("_input_rlc", "_output_rlc"):
        orig = getattr(precompiles, name)
        monkeypatch.setattr(precompiles, name,
                            lambda a, r, orig=orig, name=name: calls.append(name) or orig(a, r))
    lanes = FC.REPLAY_LANES
    curr, nxt = [psteps[0]] * lanes, [psteps[1]] * lanes
    v = CompiledGroupVerifier(ptables, psteps[0].execution_state, curr, nxt, device="cpu")
    assert len(calls) == 2 * lanes                 # the trace pass, a lane each
    inputs = v.prepare_inputs(list(curr), list(nxt))
    assert len(calls) == 4 * lanes                 # a prepare's host pass, a lane each
    for _ in range(2):
        fail = v(*inputs)
        assert torch.nonzero(fail).flatten().tolist() == (list(range(lanes)) if want else [])
    assert len(calls) == 4 * lanes                 # never in a replay


# -- the ecc circuit -------------------------------------------------------------------

ECC_TESTS = sorted(n for n in vars(test_ecc_circuit) if n.startswith("test_"))


def _jax_circuit(c):
    """The JAX ``EccCircuit`` holding the port circuit ``c``'s ops."""
    out = jecc.EccCircuit(c.max_add_ops, c.max_mul_ops, c.max_pairing_ops)
    out.add_ops = [jecc.EcAdd(*op) for op in c.add_ops]
    out.mul_ops = [jecc.EcMul(*op) for op in c.mul_ops]
    out.pairing_ops = [jecc.EcPairing(*op) for op in c.pairing_ops]
    return out


def _outcome(fn, *args):
    try:
        fn(*args)
        return None
    except AssertionError as e:
        return str(e)


@pytest.mark.parametrize("name", ECC_TESTS)
def test_ecc_circuit_bodies_on_the_port(name, monkeypatch):
    """tests/test_ecc_circuit.py's body on the port's ecc circuit and
    BN254 module; each circuit it verifies also through the JAX
    ``verify_circuit``: the same rows (``ecc_table_rows``), the same
    verdict and message, and the port's ``ecc_kernel`` chip bits agree."""
    verified = []

    def verify_circuit(c, r):
        jc = _jax_circuit(c)
        assert pecc.ecc_table_rows(c, r) == jecc.ecc_table_rows(jc, r)
        got, want = _outcome(pecc.verify_circuit, c, r), _outcome(jecc.verify_circuit, jc, r)
        assert got == want
        cols, extra = pecc.ecc_inputs(c, r)
        assert bool(extra["chip_ok"].all()) == (want is None)
        verified.append(c)
        if got is not None:
            raise AssertionError(got)

    for attr in ("EcAdd", "EcMul", "EcPairing", "EccCircuit"):
        monkeypatch.setattr(test_ecc_circuit, attr, getattr(pecc, attr))
    monkeypatch.setattr(test_ecc_circuit, "verify_circuit", verify_circuit)
    monkeypatch.setattr(test_ecc_circuit, "bn254", bn254)
    # the body that imports EccCircuitRow from the JAX module gets the port's
    monkeypatch.setattr(jecc, "EccCircuitRow", pecc.EccCircuitRow)
    getattr(test_ecc_circuit, name)()
    assert verified or name == "test_ec_add_invalid_point_flagged"


def test_ecc_kernel_fails_the_bad_row_alone():
    """The port's ``ecc_kernel`` on the CPU: a wrong ecAdd result fails its
    row alone, as the JAX kernel's chip bits give it."""
    p, q = bn254.g1_mul(bn254.G1, 2), bn254.g1_mul(bn254.G1, 3)
    out = bn254.g1_add(p, q)
    c = pecc.EccCircuit(4, 4, 4)
    c.append_add(pecc.EcAdd(p=p, q=q, out=out))
    c.append_add(pecc.EcAdd(p=p, q=q, out=(out[0], out[1] + 1)))
    c.append_mul(pecc.EcMul(p=p, s=7, out=bn254.g1_mul(p, 7)))
    fail = pecc.ecc_kernel(c, 0xABCDEF, device="cpu")()
    assert torch.nonzero(fail).flatten().tolist() == [1]
    assert pecc.ecc_kernel(pecc.EccCircuit(1, 1, 1), 0xABCDEF, device="cpu") is None


# -- BN254 ---------------------------------------------------------------------------------

BN254_TESTS = ("test_bn254_group_ops", "test_bn254_fq2_fq12", "test_bn254_pairing_bilinear")


@pytest.mark.parametrize("name", BN254_TESTS)
def test_crypto_bn254_bodies_on_the_port(name, monkeypatch):
    monkeypatch.setattr(test_crypto, "bn254", bn254)
    getattr(test_crypto, name)()


def _jax_g2(pt):
    return None if pt is None else (jbn.FQ2(pt[0].c), jbn.FQ2(pt[1].c))


def test_bn254_matches_jax_on_seeded_inputs():
    """G1 and G2 multiples (on and off the curve with reduced coordinates,
    scalars up to 2^256), the
    Miller loop's value and the final exponentiation, each equal to the JAX
    module's."""
    rnd = random.Random(18)
    for _ in range(8):
        k = rnd.getrandbits(256)
        assert bn254.g1_mul(bn254.G1, k) == jbn.g1_mul(jbn.G1, k)
    for pt in [(1, 1), (5, 7), (0, 3), (bn254.P - 1, 2)]:     # off the curve
        for k in (1, 2, 3, 5, bn254.R):
            assert bn254.g1_mul(pt, k) == jbn.g1_mul(pt, k), (pt, k)
    for k in (2, rnd.getrandbits(64)):
        q = bn254.g2_mul(bn254.G2, k)
        jq = jbn.g2_mul(jbn.G2, k)
        assert (q[0].c, q[1].c) == (jq[0].c, jq[1].c)
        a = rnd.randrange(1, bn254.R)
        f = bn254.pairing(q, bn254.g1_mul(bn254.G1, a))
        jf = jbn.pairing(_jax_g2(q), jbn.g1_mul(jbn.G1, a))
        assert f.c == jf.c
        assert bn254.final_exponentiate(f).c == jbn.final_exponentiate(jf).c


# -- the registry and the tracer's gas -------------------------------------------------------

def test_execution_state_impl_has_every_jax_state():
    assert sorted(s.name for s in EXECUTION_STATE_IMPL) == sorted(s.name for s in JAX_IMPL)


@pytest.mark.parametrize("target", range(1, 10))
def test_precompile_required_gas_matches_jax(target):
    for cd_length in (0, 1, 31, 32, 33, 128, 192, 384, 768, 1000):
        assert (PT._precompile_required_gas(target, cd_length)
                == JT._precompile_required_gas(target, cd_length))
