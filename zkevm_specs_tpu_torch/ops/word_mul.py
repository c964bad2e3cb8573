"""The 512-bit word product and its carry constraints (kernel K11).

Counterpart of the F-operation chain of ``zkevm_specs_tpu/evm/instruction.py:
_mul_512_terms`` (:812), ``mul_add_words`` (:827), ``mul_add_words_512``
(:845) and ``circuits/exp.py:_mul_add_words`` (:19).  A word is given as
its lo and hi rows, ``[B|1, w]`` int64 16-bit limbs (w <= 16, canonical
below p); a ``[1, w]`` constant row broadcasts.  ``mul_add_words`` returns
the chain's verdicts, one bool row per check in the chain's order, and for
the 256 variant its overflow (``carry_hi + t4 + t5 + t6`` as 16 canonical
limbs); the callers record the verdicts through ``cs.check`` with the
chain's own messages.

On the card it is one launch of ``csrc/mul_add_words.cu``; on the CPU its
plain version, the same steps in plain PyTorch limb operations (the plain
versions of K1, K2 and K3), which the CPU tests hold against the JAX chain.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import fr
from . import limbs as L

_INV128 = L.int_to_limbs(pow(1 << 128, fr.P - 2, fr.P), 16)
_POW128 = L.int_to_limbs(1 << 128, 16)


def _quarters(lo: torch.Tensor, hi: torch.Tensor):
    """The four 64-bit quarters (``Word.to_64s``) as [rows, 4] limb rows."""
    lo8, hi8 = L.pad_limbs(lo[:, :8], 8), L.pad_limbs(hi[:, :8], 8)
    return lo8[:, :4], lo8[:, 4:], hi8[:, :4], hi8[:, 4:]


def _shl64(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :4]), x], dim=1)


def _fadd(x, y):
    return L.addsub_plain(x, y, L.FR_ADD, 16)


def _fsub(x, y):
    return L.addsub_plain(L.pad_limbs(x, 16), L.pad_limbs(y, 16), L.FR_SUB, 16)


def _below_2_72(v: torch.Tensor) -> torch.Tensor:
    return (v[:, 4] < 256) & (v[:, 5:] == 0).all(dim=1)


def _half_carry(lhs, rhs):
    """carry = (lhs - rhs) * 2^-128 mod p, and rhs + carry * 2^128."""
    carry = fr.fr_mul_plain(_fsub(lhs, rhs), fr._row(_INV128, lhs.device))
    return carry, _fadd(rhs, fr.fr_mul_plain(carry, fr._row(_POW128, lhs.device)))


def mul_add_words_plain(rows: Sequence[torch.Tensor], wide: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K11: ``rows`` are a.lo, a.hi, b.lo, b.hi, c.lo,
    c.hi, d.lo, d.hi (and e.lo, e.hi when ``wide``); returns (ok
    ``[n_checks, B]`` bool, overflow ``[B, 16]`` or None)."""
    v = chain_values(rows, wide)
    return v["ok"], v.get("overflow")


def chain_values(rows: Sequence[torch.Tensor], wide: bool) -> dict:
    """The plain version's steps by name: the carries, each equality's two
    sides (``lhs<h>``, ``rhs<h>``), the verdicts ``ok`` and the 256
    variant's ``overflow``; the eager pass reads them for its failure
    messages."""
    a_lo, a_hi, b_lo, b_hi, c_lo, c_hi, d_lo, d_hi = rows[:8]
    A, B = _quarters(a_lo, a_hi), _quarters(b_lo, b_hi)
    t = []
    for k in range(7):
        acc = None
        for i in range(max(0, k - 3), min(3, k) + 1):
            p = L.mul_plain(A[i], B[k - i], 8)         # < 2^128: exact in 8 limbs
            acc = p if acc is None else L.addsub_plain(acc, p, L.ADD, 9)
        t.append(L.pad_limbs(acc, 9))

    def pair(h):                                       # t_2h + t_(2h+1) * 2^64, exact
        return L.addsub_plain(t[2 * h], _shl64(t[2 * h + 1]), L.ADD, 16)

    lo, hi = (rows[8], rows[9]) if wide else (d_lo, d_hi)
    v = {"lhs0": _fadd(pair(0), c_lo)}
    v["carry0"], v["rhs0"] = _half_carry(v["lhs0"], lo)
    v["lhs1"] = _fadd(_fadd(pair(1), c_hi), v["carry0"])
    v["carry1"], v["rhs1"] = _half_carry(v["lhs1"], hi)
    halves = 2
    if wide:
        v["lhs2"] = _fadd(pair(2), v["carry1"])
        v["carry2"], v["rhs2"] = _half_carry(v["lhs2"], d_lo)
        v["lhs3"], v["rhs3"] = _fadd(t[6], v["carry2"]), L.pad_limbs(d_hi, 16)
        halves = 3
    else:
        s = L.addsub_plain(L.addsub_plain(t[4], t[5], L.ADD, 16), t[6], L.ADD, 16)
        v["overflow"] = _fadd(v["carry1"], s)
    eqs = [(v[f"lhs{h}"] == v[f"rhs{h}"]).all(dim=1) for h in range(halves + wide)]
    v["ok"] = torch.stack([_below_2_72(v[f"carry{h}"]) for h in range(halves)] + eqs)
    return v


def mul_add_words(rows: Sequence[torch.Tensor], wide: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K11 wrapper: the verdicts (and the 256 variant's overflow) of the
    word product chain for ``rows`` as in ``mul_add_words_plain``, on the
    rows' device.

    Replaces ``zkevm_specs_tpu/evm/instruction.py:_mul_512_terms`` (:812)
    with ``mul_add_words`` (:827) / ``mul_add_words_512`` (:845), and
    ``circuits/exp.py:_mul_add_words`` (:19)."""
    rows = list(rows)
    if len(rows) != (10 if wide else 8):
        raise ValueError(f"mul_add_words: {'10' if wide else '8'} limb rows expected, got {len(rows)}")
    for k, t in enumerate(rows):
        L.check_limbs(t, f"mul_add_words row {k}")
        if not 1 <= t.shape[1] <= 16:
            raise ValueError(f"mul_add_words: row {k} takes at most 16 limbs, got {t.shape[1]}")
    batch = max(t.shape[0] for t in rows)
    if any(t.shape[0] not in (1, batch) for t in rows):
        raise ValueError(f"mul_add_words: batch sizes {[t.shape[0] for t in rows]} do not broadcast")
    if L.on_cpu(*rows):
        ok, overflow = mul_add_words_plain(rows, wide)
        return ok.expand(ok.shape[0], batch), (None if overflow is None
                                               else overflow.expand(batch, 16))
    from ..runtime import cuda_build

    ok = torch.empty((7 if wide else 4, batch), dtype=torch.bool, device=rows[0].device)
    overflow = None if wide else torch.empty((batch, 16), dtype=L.DTYPE, device=rows[0].device)
    padded = rows + [rows[0], rows[1]] * (not wide)   # variant 256 reads no e rows
    desc = (ctypes.c_longlong * 30)(*[t.data_ptr() for t in padded],
                                    *[L.row_stride(t) for t in padded],
                                    *[t.shape[1] for t in padded])
    lib = cuda_build.library("mul_add_words")
    err = lib.mul_add_words_launch(int(wide), desc, ok.data_ptr(),
                                   None if overflow is None else overflow.data_ptr(),
                                   batch, L.cuda_stream())
    L.check_launch(err, "mul_add_words")
    return ok, overflow
