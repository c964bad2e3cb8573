"""The exp circuit: exponentiation-by-squaring traces, one row per step.

Counterpart of ``zkevm_specs_tpu/circuits/exp.py`` (reference:
src/zkevm_specs/exp_circuit.py:14-97).  Each step row proves
a * b + c == d (mod 2^256) and the parity split 2 q + r == exponent, both
through kernel K11 (``ops/word_mul.py``); the cyclic next row is a shifted
gather, as in the state and bytecode circuits.  ``verify_exp_circuit`` is
the spec run on host tensors; ``exp_kernel`` the same body as one
``CircuitKernel`` on the card.
"""
from __future__ import annotations

from typing import List

import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops import word_mul
from ..utils.typing import is_circuit_code
from ..witness.typing import ExpCircuit

_BITS = {"q_usable": 1, "is_step": 1, "identifier": 32, "is_last": 1, "r": 8}
_WORDS = ("base", "exponent", "exponentiation", "a", "b", "c", "d", "q")
_MUL_ADD_CHECKS = ("carry_lo out of range", "carry_hi out of range", "low constraint failed",
                   "high constraint failed")


def _mul_add_words(cs: ConstraintSystem, a: Word, b: Word, c: Word, d: Word, mask, msg: str):
    """Constrain a*b + c == d mod 2^256 under mask (the JAX package's
    ``circuits/exp.py:_mul_add_words`` :19-42, reference
    util/arithmetic.py:245-276): one K11 launch, its four checks in the
    chain's order."""
    ok, _ = word_mul.mul_add_words([p.limbs for w in (a, b, c, d) for p in (w.lo, w.hi)])
    for k, what in enumerate(_MUL_ADD_CHECKS):
        cs.check(ok[k] | ~mask, lambda what=what: f"{msg}: {what}")


def build_exp_cols(ctx: Ctx, rows: List[dict]):
    cols = {name: F.from_ints(ctx, [r[name] for r in rows], bits) for name, bits in _BITS.items()}
    for name in _WORDS:
        cols[name] = Word.from_ints(ctx, [r[name] for r in rows])
    return cols


@is_circuit_code
def check_exp(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The exp-circuit constraint body (reference exp_circuit.py:14-86):
    the same checks, order and messages as the JAX package's ``check_exp``."""
    c = {name: cols[name] for name in _BITS}
    words = {name: cols[name] for name in _WORDS}
    n = ctx.batch
    i1 = (torch.arange(n, device=ctx.device) + 1) % n
    next_identifier = c["identifier"].gather(i1)
    w1 = {name: words[name].gather(i1) for name in ("base", "d", "exponent")}

    def check(mask, ok, msg):
        cs.check(ok | ~mask, lambda: msg)

    is_step = ~c["is_step"].is_zero_mask()
    is_last = ~c["is_last"].is_zero_mask()

    # every step except the last (reference :16-24)
    m = is_step & ~is_last
    check(m, words["base"].eq_mask(w1["base"]), "base changes within trace")
    check(m, words["a"].eq_mask(w1["d"]), "a != next d")
    check(m, c["identifier"].eq_mask(next_identifier), "identifier changes within trace")

    # every step (reference :26-50)
    check(is_step, c["is_last"].le_bits_mask(1), "is_last not boolean")
    check(is_step, c["r"].le_bits_mask(1), "parity not boolean")
    _mul_add_words(cs, words["a"], words["b"], words["c"], words["d"], is_step,
                   "exp multiplication")
    check(is_step, words["exponentiation"].eq_mask(words["d"]), "exponentiation != d")
    check(is_step, words["c"].is_zero_mask(), "c != 0")
    _mul_add_words(cs, Word.const(ctx, 2), words["q"], Word.from_lo(c["r"]), words["exponent"],
                   is_step, "parity check")

    # odd exponent steps (reference :52-61)
    m = is_step & ~is_last & ~c["r"].is_zero_mask()
    check(m, w1["exponent"].lo.eq_mask(words["exponent"].lo - 1), "odd: lo not decremented")
    check(m, w1["exponent"].hi.eq_mask(words["exponent"].hi), "odd: hi changed")
    check(m, words["base"].eq_mask(words["b"]), "odd: b != base")

    # even exponent steps (reference :63-73)
    m = is_step & ~is_last & c["r"].is_zero_mask()
    check(m, w1["exponent"].lo.eq_mask(words["q"].lo), "even: lo != quotient lo")
    check(m, w1["exponent"].hi.eq_mask(words["q"].hi), "even: hi != quotient hi")
    check(m, words["a"].eq_mask(words["b"]), "even: a != b")

    # last step (reference :75-83)
    check(is_last, words["exponent"].lo.eq_mask(2), "last: exponent lo != 2")
    check(is_last, words["exponent"].hi.is_zero_mask(), "last: exponent hi != 0")
    check(is_last, words["base"].eq_mask(words["a"]), "last: a != base")
    check(is_last, words["base"].eq_mask(words["b"]), "last: b != base")


def verify_exp_circuit(exp_circuit: ExpCircuit, success: bool = True):
    """Spec-mode (eager, host tensors) run with the reference's verdict
    semantics."""
    from ..runtime.kernels import run_spec

    rows = exp_circuit.table()
    if not rows:
        return
    run_spec("exp", check_exp, build_exp_cols(Ctx("cpu", len(rows), "eager"), rows),
             success=success)


def exp_kernel(exp_circuit: ExpCircuit, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel`` on
    ``device`` (the card unless the caller asks for "cpu"); None for an
    empty circuit."""
    from ..runtime.kernels import CircuitKernel

    rows = exp_circuit.table()
    if not rows:
        return None
    return CircuitKernel("exp", check_exp, build_exp_cols(Ctx("cpu", len(rows), "eager"), rows),
                         device=device)
