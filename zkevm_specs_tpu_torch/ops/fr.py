"""BN254 scalar-field (Fr) arithmetic on 16-bit limb tensors.

Counterpart of ``zkevm_specs_tpu/ops/fr.py``.  A field element batch is
``[B or 1, 16] int64`` (sixteen 16-bit limbs, little-endian), canonical
(< p).  The field multiply is kernel K1 (``fr_mul``, ``csrc/fr_mul.cu``);
add, sub, neg and reduce_once are the Fr modes of kernel K3
(``limbs.limb_addsub``); the inverse is kernel K12 (``inv``,
``csrc/fr_inv.cu``).
"""
from __future__ import annotations

import torch

from . import limbs as L
from .limbs import P

NL = 16  # limbs per canonical field element
BARRETT_K = 512  # mu = floor(2^512 / p)
MU = (1 << BARRETT_K) // P

P_LIMBS_17 = L.int_to_limbs(P, 17)
MU_LIMBS = L.int_to_limbs(MU, 17)  # 259 bits -> 17 limbs

_ZERO_ROW = torch.zeros((1, 1), dtype=L.DTYPE)
_const_cache = {}


def _row(host: torch.Tensor, device) -> torch.Tensor:
    """A host constant as a [1, n] row on ``device`` (cached per device)."""
    key = (id(host), str(device))
    t = _const_cache.get(key)
    if t is None:
        t = host.reshape(1, -1).to(device)
        _const_cache[key] = t
    return t


def _reduce_wide(x, mul, sub, select):
    """Barrett with b=2^16, k=16 (HAC 14.42), over the given limb ops:
      q1 = x >> 240 ; q2 = q1*mu ; q3 = q2 >> 272
      r  = (x mod 2^272) - (q3*p mod 2^272), then subtract p at most twice.
    """
    x = L.pad_limbs(x, 32)
    q1 = x[..., 15:]                                   # x >> 240, 17 limbs
    q2 = mul(q1, _row(MU_LIMBS, x.device), 34)
    q3 = q2[..., 17:]                                  # q2 >> 272, 17 limbs
    r2 = mul(q3, _row(P_LIMBS_17, x.device), 17)      # mod 2^272
    r, _ = sub(x[..., :17], r2)
    for _ in range(2):
        d, b2 = sub(r, _row(P_LIMBS_17, x.device))
        r = select(b2 == 0, d, r)
    return r[..., :NL]


def _select_plain(cond, a, b):
    return torch.where(cond[..., None], a, b)


def reduce_wide(x: torch.Tensor) -> torch.Tensor:
    """Barrett-reduce x (< p^2, up to 32 limbs) to a canonical 16-limb value
    (through K2 and K3 on the card)."""
    return _reduce_wide(x, L.mul, L.sub, L.select)


def reduce_once(x: torch.Tensor) -> torch.Tensor:
    """Reduce a 16/17-limb value known < 2p into [0, p)."""
    return L.limb_addsub(x, _row(_ZERO_ROW, x.device), L.FR_ADD)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical inputs."""
    return L.limb_addsub(a, b, L.FR_ADD)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical inputs."""
    return L.limb_addsub(a, b, L.FR_SUB)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p (0 stays 0)."""
    return L.limb_addsub(_row(_ZERO_ROW, a.device), a, L.FR_SUB)


# ---------------------------------------------------------------------------
# K1: field multiply
# ---------------------------------------------------------------------------

def reduce_wide_plain(x: torch.Tensor) -> torch.Tensor:
    """``reduce_wide`` in plain PyTorch ops (the kernels' plain versions)."""
    return _reduce_wide(x, L.mul_plain, lambda u, v: L.addsub_plain(u, v, L.SUB, 0),
                        _select_plain)


def fr_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the schoolbook product and Barrett reduction of
    ``fr.mul`` in plain PyTorch ops."""
    return reduce_wide_plain(L.mul_plain(a, b, a.shape[-1] + b.shape[-1]))


def fr_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: (a * b) mod p for ``a [B|1, <=16]`` and ``b [B|1, <=16]``
    as ``[B, 16]`` canonical limbs, bit-identical to Barrett in
    ``reduce_wide``.

    Replaces ``zkevm_specs_tpu/ops/fr.py:mul`` -> ``reduce_wide`` (the live
    form of the retired Pallas kernel ``fr_mul_pallas``)."""
    L.check_limbs(a, "fr_mul a")
    L.check_limbs(b, "fr_mul b")
    na, nb = a.shape[-1], b.shape[-1]
    if not (1 <= na <= NL and 1 <= nb <= NL):
        raise ValueError(f"fr_mul: operands take at most {NL} limbs, got {na}, {nb}")
    rows = L.batch_rows(a, b)
    if L.on_cpu(a, b):
        return fr_mul_plain(a, b)
    from ..runtime import cuda_build

    out = torch.empty((rows, NL), dtype=L.DTYPE, device=a.device)
    lib = cuda_build.library("fr_mul")
    err = lib.fr_mul_launch(a.data_ptr(), L.row_stride(a), na, b.data_ptr(), L.row_stride(b), nb,
                            out.data_ptr(), rows, L.cuda_stream())
    L.check_launch(err, "fr_mul")
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for canonical inputs of any limb width <= 16."""
    return fr_mul(a, b)


def _pow(a: torch.Tensor, e: int, mul) -> torch.Tensor:
    """a ** e mod p for a static Python-int exponent by right-to-left square
    and multiply over ``mul`` (the JAX package's ``pow_const``, fr.py:112-127,
    step for step)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        one = torch.zeros((a.shape[0], NL), dtype=L.DTYPE, device=a.device)
        one[:, 0] = 1
        return one
    return L.pad_limbs(result, NL)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a ** e mod p for a static exponent, every product through K1."""
    return _pow(a, e, mul)


# ---------------------------------------------------------------------------
# K12: field inverse
# ---------------------------------------------------------------------------

def inv_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: ``pow_const(a, p - 2)`` over ``fr_mul_plain``."""
    return _pow(a, P - 2, fr_mul_plain)


def inv(a: torch.Tensor) -> torch.Tensor:
    """K12 wrapper: a^(p-2) mod p (0 maps to 0) for ``a [B, <=16]`` as
    ``[B, 16]`` canonical limbs.

    Replaces ``zkevm_specs_tpu/ops/fr.py:inv`` (:134-158): any exact ladder
    gives the one canonical value, so the kernel's left-to-right ladder
    equals the JAX scan and its numpy ``pow_const``."""
    L.check_limbs(a, "fr.inv a")
    if not 1 <= a.shape[-1] <= NL:
        raise ValueError(f"fr.inv: the operand takes at most {NL} limbs, got {a.shape[-1]}")
    if L.on_cpu(a):
        return inv_plain(a)
    from ..runtime import cuda_build

    out = torch.empty((a.shape[0], NL), dtype=L.DTYPE, device=a.device)
    lib = cuda_build.library("fr_inv")
    err = lib.fr_inv_launch(a.data_ptr(), L.row_stride(a), a.shape[-1], out.data_ptr(),
                            a.shape[0], L.cuda_stream())
    L.check_launch(err, "fr_inv")
    return out


def from_ints(values, device="cpu") -> torch.Tensor:
    """Host helper: Python ints -> canonical limb tensor on ``device``."""
    return L.ints_to_limbs([v % P for v in values], NL).to(device)


def to_ints(arr) -> list:
    return L.limbs_to_ints(arr)
