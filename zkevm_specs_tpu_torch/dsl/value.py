"""Batched field-element and 256-bit word values for the constraint DSL.

Counterpart of ``zkevm_specs_tpu/dsl/value.py``.  ``F`` is one *batch* of
BN254-Fr elements stored as ``[B or 1, n_limbs] int64`` 16-bit limbs with a
*static* magnitude bound (``bits``); the bounds, and so the widths, equal
the JAX package's, including its two fast paths (the 1-bit flag product
and the borrow-free constant subtract).  ``Word`` is the lo/hi 128-bit
split word (reference: src/zkevm_specs/util/arithmetic.py:99-168).

``Ctx`` holds the device the values live on.  The eager trace pass runs on
host tensors and may read values; the replay and the device mode run on
``Ctx.device`` and never read one back.  Constants carry their Python int
(``F.value``), so the constant-subtract fast path is decided on the host in
every mode.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import fr
from ..ops import limbs as L

WIDTHS = (1, 2, 4, 8, 16)


def width_for_bits(bits: int) -> int:
    n = (bits + L.LIMB_BITS - 1) // L.LIMB_BITS
    for w in WIDTHS:
        if n <= w:
            return w
    raise ValueError(f"bound of {bits} bits exceeds field width")


# constant rows per (value, width, device): immutable, shared by every
# context, so a replay uploads each constant once per process instead of
# stalling on a host-to-device copy in every replay
_CONST_ROWS = {}


class Ctx:
    """Evaluation context: device + batch size + mode.

    mode "eager": host evaluation; concrete values may be read
    (data-dependent branching, exact failure messages, witness hints).
    mode "replay": the replay of a traced group on ``device``; reading
    values is forbidden, branch decisions come from the static signature
    and witness hints from the recorded hint stream.
    mode "device": a standalone circuit check on ``device`` (the JAX
    package's "jit" mode); reading values is forbidden and there is no
    hint stream, so lookups search their table on the device.
    """

    def __init__(self, device, batch: int, mode: str = "eager"):
        self.device = torch.device(device)
        self.batch = batch
        self.mode = mode

    @property
    def eager(self) -> bool:
        return self.mode == "eager"

    def const_limbs(self, value: int, width: int) -> torch.Tensor:
        key = (value, width, self.device)
        arr = _CONST_ROWS.get(key)
        if arr is None:
            arr = L.int_to_limbs(value, width)[None, :].to(self.device)
            _CONST_ROWS[key] = arr
        return arr


IntOrF = Union[int, "F"]


class F:
    """A batch of canonical BN254-Fr elements with a static magnitude bound."""

    __slots__ = ("ctx", "limbs", "bits", "value")

    def __init__(self, ctx: Ctx, limbs: torch.Tensor, bits: int, value: Optional[int] = None):
        self.ctx = ctx
        self.limbs = limbs  # [B or 1, w] int64, canonical
        self.bits = min(bits, 254)
        self.value = value  # the Python int of a constant, else None

    # -- constructors ------------------------------------------------------

    @staticmethod
    def const(ctx: Ctx, value: int) -> "F":
        value = int(value) % fr.P
        bits = max(value.bit_length(), 1)
        return F(ctx, ctx.const_limbs(value, width_for_bits(bits)), bits, value)

    @staticmethod
    def from_ints(ctx: Ctx, values: Sequence[int], bits: int = 254) -> "F":
        """Build from host ints with a *declared* bound.

        Well-formed witnesses respect the bound; malformed ones auto-widen
        instead of crashing, so range constraints can reject them."""
        P = fr.P
        # values in [0, 2^64) are canonical already; numpy finds that
        # without a Python loop, which matters at millions of values
        vals = L.small_ints(values)
        if vals is None:
            vals = [v if (type(v) is int and 0 <= v < P) else int(v) % P for v in values]
        w = width_for_bits(bits)
        try:
            arr = L.ints_to_limbs(vals, w)
        except AssertionError:
            arr = L.ints_to_limbs(vals, width_for_bits(254))
        host = arr.numpy()
        nz = np.flatnonzero(host.any(axis=0))
        if nz.size == 0:
            real_bits = 1
        else:
            k = int(nz[-1])
            real_bits = k * L.LIMB_BITS + int(host[:, k].max()).bit_length()
        bits = max(bits, real_bits)
        w = width_for_bits(bits)
        if arr.shape[1] > w:
            arr = arr[:, :w]
        elif arr.shape[1] < w:
            arr = L.pad_limbs(arr, w)
        return F(ctx, arr.contiguous().to(ctx.device), bits)

    @staticmethod
    def from_bool(ctx: Ctx, mask: torch.Tensor) -> "F":
        return F(ctx, mask.to(L.DTYPE)[..., None], 1)

    def _coerce(self, other: IntOrF) -> "F":
        if isinstance(other, F):
            return other
        return F.const(self.ctx, other)

    # -- helpers -----------------------------------------------------------

    def widen(self, width: int) -> "F":
        if self.limbs.shape[-1] >= width:
            return self
        return F(self.ctx, L.pad_limbs(self.limbs, width), self.bits, self.value)

    @property
    def width(self) -> int:
        return self.limbs.shape[-1]

    def _host_scalar(self) -> Optional[int]:
        """The value of a [1, w] row known without a device read: a
        constant's int, or, in the eager pass, a host row (as the JAX
        package's eager pass reads any [1, w] row, e.g. a one-lane batch)."""
        if self.value is not None:
            return self.value
        if self.ctx.eager and self.limbs.device.type == "cpu":
            v = int(self.limbs[0, 0])
            if self.width > 1:
                v += int(self.limbs[0, 1]) << L.LIMB_BITS
            return v
        return None

    # -- arithmetic --------------------------------------------------------

    def __add__(self, other: IntOrF) -> "F":
        other = self._coerce(other)
        nb = max(self.bits, other.bits) + 1
        if nb <= 253:
            return F(self.ctx, L.add(self.limbs, other.limbs, width_for_bits(nb)), nb)
        return F(self.ctx, fr.add(self.limbs, other.limbs), 254)

    __radd__ = __add__

    def __sub__(self, other: IntOrF) -> "F":
        other = self._coerce(other)
        # no-borrow fast path: a scalar lhs whose value dominates the rhs's
        # static bound cannot wrap mod p (e.g. the ubiquitous `1 - flag`),
        # so the difference keeps the narrow width and bound
        if self.limbs.shape[0] == 1 and self.bits <= 32 and other.bits <= self.bits:
            v = self._host_scalar()
            if v is not None and v >= (1 << other.bits) - 1:
                w = width_for_bits(self.bits)
                d, _ = L.sub(self.widen(w).limbs, other.widen(w).limbs)
                return F(self.ctx, d, self.bits)
        return F(self.ctx, fr.sub(self.limbs, other.limbs), 254)

    def __rsub__(self, other: IntOrF) -> "F":
        return self._coerce(other).__sub__(self)

    def __mul__(self, other: IntOrF) -> "F":
        other = self._coerce(other)
        # flag fast path: a 1-bit operand is 0/1 by the bound contract, so
        # the product is an elementwise select
        if self.bits == 1 or other.bits == 1:
            flag, val = (self, other) if self.bits == 1 else (other, self)
            return F(self.ctx, val.limbs * flag.limbs[..., :1], val.bits)
        nb = self.bits + other.bits
        if nb <= 253:
            return F(self.ctx, L.mul(self.limbs, other.limbs, width_for_bits(nb)), nb)
        return F(self.ctx, fr.mul(self.limbs, other.limbs), 254)

    __rmul__ = __mul__

    def __neg__(self) -> "F":
        return F(self.ctx, fr.neg(self.limbs), 254)

    def fdiv_const(self, denom: int) -> "F":
        """Field division by a static constant (multiply by its inverse)
        (reference: src/zkevm_specs/evm_circuit/instruction.py:613)."""
        inv = pow(int(denom) % fr.P, fr.P - 2, fr.P)
        return self * F.const(self.ctx, inv)

    # -- predicates (bool tensors over the batch) --------------------------

    def is_zero_mask(self) -> torch.Tensor:
        return L.is_zero(self.limbs)

    def eq_mask(self, other: IntOrF) -> torch.Tensor:
        return L.eq(self.limbs, self._coerce(other).limbs)

    def lt_mask(self, other: IntOrF) -> torch.Tensor:
        return L.lt(self.limbs, self._coerce(other).limbs)

    def le_bits_mask(self, n_bits: int) -> torch.Tensor:
        """value < 2^n_bits, as a bool mask."""
        k, rem = divmod(n_bits, L.LIMB_BITS)
        if k >= self.width:
            return torch.ones(self.limbs.shape[:-1], dtype=torch.bool, device=self.limbs.device)
        ok = (self.limbs[..., k + (1 if rem else 0):] == 0).all(dim=-1)
        if rem:
            ok = ok & (self.limbs[..., k] < (1 << rem))
        return ok

    def is_bool_mask(self) -> torch.Tensor:
        return (self.limbs[..., 0] <= 1) & (self.limbs[..., 1:] == 0).all(dim=-1)

    # -- data movement -----------------------------------------------------

    def select(self, mask: torch.Tensor, other: "F") -> "F":
        """mask ? self : other (elementwise over the batch)."""
        other = self._coerce(other)
        return F(self.ctx, L.select(mask, self.limbs, other.limbs), max(self.bits, other.bits))

    def gather(self, idx: torch.Tensor) -> "F":
        """Gather rows of the batch by integer index tensor."""
        if self.limbs.shape[0] == 1:
            return self
        return F(self.ctx, self.limbs[idx], self.bits)

    def broadcast(self) -> "F":
        """Materialize a constant row to full batch size (a view)."""
        if self.limbs.shape[0] == self.ctx.batch:
            return self
        return F(self.ctx, self.limbs.expand(self.ctx.batch, self.width), self.bits)

    # -- eager-mode host access -------------------------------------------

    def to_ints(self) -> list:
        assert self.ctx.eager, "reading values is only allowed in eager mode"
        out = L.limbs_to_ints(self.limbs)
        return out if isinstance(out, list) else [out]

    def to_int_scalar(self) -> int:
        vals = self.to_ints()
        assert all(v == vals[0] for v in vals)
        return vals[0]

    # -- bit/byte decomposition (values must satisfy their bound) ---------

    def le_bytes(self, n_bytes: int) -> list:
        """Split into n_bytes little-endian byte-valued F's (no checks)."""
        out = []
        for b in range(n_bytes):
            limb = b // 2
            if limb < self.width:
                v = self.limbs[..., limb]
                v = ((v >> 8) if (b % 2) else v) & 0xFF
            else:
                v = torch.zeros(self.limbs.shape[:-1], dtype=L.DTYPE, device=self.limbs.device)
            out.append(F(self.ctx, v[..., None], 8))
        return out

    def split_pow2(self, bits: int, hi_bits: int) -> Tuple["F", "F"]:
        """Return (self >> bits, self mod 2^bits) with hi bound hi_bits."""
        q, r = L.divmod_pow2(self.limbs, bits)
        qf = F(self.ctx, trim(q, width_for_bits(hi_bits)), hi_bits)
        rf = F(self.ctx, trim(r, width_for_bits(bits)), bits)
        return qf, rf

    def __repr__(self):
        if self.ctx.eager:
            vals = self.to_ints()
            s = vals[0] if len(vals) == 1 else vals[: min(len(vals), 4)]
            return f"F({s})"
        return f"F(bits={self.bits}, width={self.width})"


def trim(arr: torch.Tensor, width: int) -> torch.Tensor:
    """Truncate or zero-pad a limb tensor to the given width (high limbs
    must be zero by the caller's bound)."""
    if arr.shape[-1] <= width:
        return L.pad_limbs(arr, width)
    return arr[..., :width]


class Word:
    """A 256-bit EVM word as lo/hi 128-bit field elements.

    Mirrors reference Word (src/zkevm_specs/util/arithmetic.py:99-168)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: F, hi: F):
        self.lo = lo
        self.hi = hi

    @staticmethod
    def const(ctx: Ctx, value: int) -> "Word":
        assert 0 <= value < (1 << 256)
        return Word(F.const(ctx, value & ((1 << 128) - 1)), F.const(ctx, value >> 128))

    @staticmethod
    def from_lo(lo: F) -> "Word":
        return Word(lo, F.const(lo.ctx, 0))

    @staticmethod
    def from_ints(ctx: Ctx, values: Sequence[int]) -> "Word":
        mask = (1 << 128) - 1
        return Word(
            F.from_ints(ctx, [v & mask for v in values], 128),
            F.from_ints(ctx, [v >> 128 for v in values], 128),
        )

    def to_lo_hi(self) -> Tuple[F, F]:
        return self.lo, self.hi

    def to_64s(self) -> Tuple[F, F, F, F]:
        lo_q, lo_r = self.lo.split_pow2(64, 64)
        hi_q, hi_r = self.hi.split_pow2(64, 64)
        return (lo_r, lo_q, hi_r, hi_q)

    def to_le_bytes(self) -> list:
        return self.lo.le_bytes(16) + self.hi.le_bytes(16)

    def add_lanes(self, other: "Word") -> "Word":
        """Lane-wise add of lo/hi (NOT 256-bit addition) — mirrors reference
        Word.__add__ used with select (util/arithmetic.py:143-146)."""
        return Word(self.lo + other.lo, self.hi + other.hi)

    def select_scale(self, selector: F) -> "Word":
        return Word(selector * self.lo, selector * self.hi)

    def select(self, mask: torch.Tensor, other: "Word") -> "Word":
        return Word(self.lo.select(mask, other.lo), self.hi.select(mask, other.hi))

    def gather(self, idx: torch.Tensor) -> "Word":
        return Word(self.lo.gather(idx), self.hi.gather(idx))

    def eq_mask(self, other: "Word") -> torch.Tensor:
        return self.lo.eq_mask(other.lo) & self.hi.eq_mask(other.hi)

    def is_zero_mask(self) -> torch.Tensor:
        return self.lo.is_zero_mask() & self.hi.is_zero_mask()

    def to_ints(self) -> list:
        los, his = self.lo.to_ints(), self.hi.to_ints()
        if len(los) == 1 and len(his) > 1:
            los = los * len(his)
        if len(his) == 1 and len(los) > 1:
            his = his * len(los)
        return [lo + (hi << 128) for lo, hi in zip(los, his)]

    def __repr__(self):
        return f"Word({self.lo!r},{self.hi!r})"


class WordOrValue(Word):
    """A word or a single field value in the lo lane — mirrors reference
    WordOrValue (util/arithmetic.py:171-195)."""

    __slots__ = ("is_word",)

    def __init__(self, value: Union[Word, F]):
        if isinstance(value, Word):
            super().__init__(value.lo, value.hi)
            self.is_word = True
        else:
            super().__init__(value, F.const(value.ctx, 0))
            self.is_word = False

    def value(self) -> F:
        return self.lo
