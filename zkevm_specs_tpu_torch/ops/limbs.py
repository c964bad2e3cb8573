"""Multi-precision integer arithmetic on 16-bit limb tensors.

Counterpart of ``zkevm_specs_tpu/ops/limbs.py``.  Big integers are stored
as little-endian ``torch.int64`` tensors of 16-bit limbs, shape
``[B or 1, n_limbs]``; a ``[1, n]`` row broadcasts against a ``[B, n]``
batch.  int64 is wide enough for every intermediate of the plain versions:
a limb product is below 2^32 and a product column of up to 17 terms plus
its carry stays far below 2^63.

Three functions carry the arithmetic on the card, each a hand-written
CUDA kernel with a plain PyTorch version beside it:

* ``limb_mul`` (K2, ``csrc/limb_mul.cu``): the unreduced narrow product,
  carries normalised into canonical limbs, top carry dropped;
* ``carry_propagate`` (K2's second entry, ``limb_reduce``): the carry
  normalisation of accumulated columns (the same entry with ``reduce``
  set is ``fr.normalize_reduce``);
* ``limb_addsub`` (K3, ``csrc/limb_addsub.cu``): the add and subtract
  chains, plain or mod p (the Fr modes are used by ``ops/fr.py``).

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel, and it raises for anything else.  Every
wrapper of the port passes its launch to ``check_launch``, which counts it
in ``LAUNCHES`` under the kernel's name.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Tuple

import numpy as np
import torch

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1
DTYPE = torch.int64

# BN254 scalar-field modulus; the Fr modes of limb_addsub need it here
# (ops/fr.py re-exports it as fr.P).
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617


# ---------------------------------------------------------------------------
# Host-side conversions (CPU tensors; used for constants and witness IO)
# ---------------------------------------------------------------------------

def int_to_limbs(value: int, n_limbs: int) -> torch.Tensor:
    """Convert a Python int to a little-endian 16-bit limb vector."""
    assert value >= 0
    assert value < (1 << (LIMB_BITS * n_limbs)), f"value needs more than {n_limbs} limbs"
    return torch.tensor(
        [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)], dtype=DTYPE)


def small_ints(values) -> "np.ndarray | None":
    """``values`` as a numpy ``uint64`` array when every one is an int in
    [0, 2^64), else None.  numpy infers the type in C (int64, uint64, or
    object once a value leaves that range), so no Python loop runs."""
    arr = values if isinstance(values, np.ndarray) else np.asarray(values)
    if arr.dtype.kind == "u" or (arr.dtype.kind == "i" and (arr.size == 0 or arr.min() >= 0)):
        return arr.astype(np.uint64, copy=False)
    return None


def ints_to_limbs(values, n_limbs: int) -> torch.Tensor:
    """Convert a sequence of Python ints to a [len, n_limbs] limb tensor."""
    vals = values if isinstance(values, np.ndarray) else list(values)
    arr = small_ints(vals)
    if arr is not None:
        out = np.zeros((len(vals), n_limbs), dtype=np.int64)
        for k in range(min(4, n_limbs)):
            out[:, k] = ((arr >> np.uint64(LIMB_BITS * k)) & np.uint64(LIMB_MASK)).astype(np.int64)
        assert n_limbs >= 4 or not (arr >> np.uint64(LIMB_BITS * n_limbs)).any(), (
            f"values need more than {n_limbs} limbs")
        return torch.from_numpy(out)
    nbytes = n_limbs * (LIMB_BITS // 8)
    try:
        buf = b"".join(int(v).to_bytes(nbytes, "little") for v in vals)
    except OverflowError:
        raise AssertionError(f"values need more than {n_limbs} limbs")
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), n_limbs).astype(np.int64)
    return torch.from_numpy(arr)


def limbs_to_int(limbs) -> int:
    """Convert a 1-D limb vector back to a Python int."""
    arr = _host_array(limbs)
    assert arr.ndim == 1
    value = 0
    for i in range(arr.shape[0] - 1, -1, -1):
        value = (value << LIMB_BITS) | int(arr[i])
    return value


def limbs_to_ints(limbs) -> list:
    """Convert a [..., n_limbs] limb array to a nested list of Python ints."""
    arr = _host_array(limbs)
    if arr.ndim == 1:
        return limbs_to_int(arr)
    if arr.ndim == 2:
        # one vectorised Horner pass over Python-int object columns
        acc = np.zeros(arr.shape[0], dtype=object)
        for i in range(arr.shape[1] - 1, -1, -1):
            acc = (acc << LIMB_BITS) | arr[:, i].astype(object)
        return [int(v) for v in acc]
    return [limbs_to_ints(a) for a in arr]


def _host_array(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        return limbs.detach().cpu().numpy()
    return np.asarray(limbs)


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------

def pad_limbs(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the limb axis of ``a`` up to ``n`` limbs."""
    cur = a.shape[-1]
    if cur == n:
        return a
    assert cur < n
    return torch.nn.functional.pad(a, (0, n - cur))


def batch_rows(a: torch.Tensor, b: torch.Tensor) -> int:
    ra, rb = a.shape[0], b.shape[0]
    if ra != rb and 1 not in (ra, rb):
        raise ValueError(f"batch sizes {ra} and {rb} do not broadcast")
    return max(ra, rb)


# ---------------------------------------------------------------------------
# Carry normalisation (plain PyTorch)
# ---------------------------------------------------------------------------

_CARRY_WORD = 62    # limbs a packed word of carry flags spans (its sums stay below 2^63)


def _carries(g: torch.Tensor, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carry into each limb of a chain in which limb k carries out
    ``g_k | (p_k & carry_in_k)`` (0/1 int64 ``g``, ``p`` over ``[..., n]``,
    never both 1), and the carry out of the top limb: the carries of the
    binary sum ``(g | p) + g`` with the flags packed into words of 62 bits,
    one word at a time.  No value is read back."""
    n = g.shape[-1]
    cin = torch.empty_like(g)
    carry = torch.zeros(g.shape[:-1], dtype=DTYPE, device=g.device)
    for lo in range(0, n, _CARRY_WORD):
        hi = min(n, lo + _CARRY_WORD)
        shift = torch.arange(hi - lo, dtype=DTYPE, device=g.device)
        x = ((g[..., lo:hi] | p[..., lo:hi]) << shift).sum(-1)
        y = (g[..., lo:hi] << shift).sum(-1)
        total = x + y + carry
        cin[..., lo:hi] = ((total ^ x ^ y)[..., None] >> shift) & 1
        carry = total >> (hi - lo)
    return cin, carry


def _normalize(cols: torch.Tensor, out_n: int, rounds: int = 3) -> torch.Tensor:
    """Non-negative columns into ``out_n`` canonical limbs, the carry out
    of the top limb dropped (the limbs of a sequential ripple).  ``rounds``
    of every limb's carry moved up one limb bring each column to at most
    0x1FFFE (3 rounds for any int64 column, 2 below 2^47, a product's
    columns; none for a sum of two canonical limbs), so a limb then
    carries out 1 where it is 2^16 or more and its incoming carry where it
    is 0xFFFF; ``_carries`` resolves those chains.  No value is read
    back."""
    m = cols.shape[-1]
    out = cols[..., :out_n] if m >= out_n else torch.nn.functional.pad(cols, (0, out_n - m))
    for _ in range(rounds):
        carry = out >> LIMB_BITS
        out = out & LIMB_MASK
        out[..., 1:] += carry[..., :-1]
    cin, _ = _carries(out >> LIMB_BITS, (out == LIMB_MASK).to(DTYPE))
    return (out + cin) & LIMB_MASK


def carry_propagate_plain(cols: torch.Tensor, out_n: int) -> torch.Tensor:
    """Plain version of ``carry_propagate`` (and of K2's normalisation
    entry without ``reduce``)."""
    if cols.shape[-1] > out_n:
        cols = cols[..., :out_n]
    return _normalize(cols, out_n)


def carry_propagate(cols: torch.Tensor, out_n: int) -> torch.Tensor:
    """Normalize accumulated non-negative columns ``[R, m]`` into ``out_n``
    canonical 16-bit limbs; any residual carry out of the top limb is
    dropped, as in the JAX package.  On the card one K2 launch
    (``limb_reduce`` without ``reduce``)."""
    check_limbs(cols, "carry_propagate cols")
    if on_cpu(cols):
        return carry_propagate_plain(cols, out_n)
    return limb_reduce(cols, out_n, False)


# ---------------------------------------------------------------------------
# Kernel plumbing
# ---------------------------------------------------------------------------

def check_limbs(t: torch.Tensor, name: str) -> None:
    if t.dtype != DTYPE:
        raise TypeError(f"{name}: expected int64 limbs, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a [rows, limbs] tensor, got shape {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: limb axis must be contiguous (stride {t.stride(-1)})")


def row_stride(t: torch.Tensor) -> int:
    """Element stride between lanes; 0 for a broadcast [1, w] row."""
    return 0 if t.shape[0] == 1 else t.stride(0)


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every tensor lies on one CUDA device (kernel).  Raises otherwise."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA device, got {devs}")


def cuda_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# launches of each kernel by name, counted where the launch is checked (the
# plain versions launch nothing)
LAUNCHES: Counter = Counter()


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K2: narrow product
# ---------------------------------------------------------------------------

MAX_MUL_LIMBS = 17   # widest operand on the path (Barrett's 17-limb terms)
MAX_MUL_OUT = 34


def mul_plain(a: torch.Tensor, b: torch.Tensor, out_n: int) -> torch.Tensor:
    """Plain version of K2: (a * b) mod 2^(16 out_n) in canonical limbs."""
    na, nb = a.shape[-1], b.shape[-1]
    rows = batch_rows(a, b)
    ncols = min(na + nb, out_n)
    cols = torch.zeros((rows, ncols), dtype=DTYPE, device=a.device)
    for i in range(min(na, ncols)):
        n = min(nb, ncols - i)
        cols[:, i:i + n] += a[:, i:i + 1] * b[:, :n]
    return _normalize(cols, out_n, rounds=2)      # columns below min(na, nb) * 2^32


def limb_mul(a: torch.Tensor, b: torch.Tensor, out_n: int) -> torch.Tensor:
    """K2 wrapper: unreduced product of ``a [B|1, na]`` and ``b [B|1, nb]``
    as ``[B, out_n]`` canonical limbs, carry out of the top limb dropped.
    On the card a tile of 32 lanes (``csrc/limb_mul.cu``'s ``MUL_TILE``)
    is staged through shared memory, one lane a thread, and stored
    flattened.

    Replaces ``zkevm_specs_tpu/ops/limbs.py:mul`` with its
    ``carry_propagate``/``_resolve_carries``."""
    check_limbs(a, "limb_mul a")
    check_limbs(b, "limb_mul b")
    na, nb = a.shape[-1], b.shape[-1]
    if not (1 <= na <= MAX_MUL_LIMBS and 1 <= nb <= MAX_MUL_LIMBS and 1 <= out_n <= MAX_MUL_OUT):
        raise ValueError(f"limb_mul: widths ({na}, {nb} -> {out_n}) out of range")
    rows = batch_rows(a, b)
    if on_cpu(a, b):
        return mul_plain(a, b, out_n)
    from ..runtime import cuda_build

    out = torch.empty((rows, out_n), dtype=DTYPE, device=a.device)
    lib = cuda_build.library("limb_mul")
    err = lib.limb_mul_launch(a.data_ptr(), row_stride(a), na, b.data_ptr(), row_stride(b), nb,
                              out.data_ptr(), out_n, rows, cuda_stream())
    check_launch(err, "limb_mul")
    return out


MAX_REDUCE_KEEP = 32   # reduce_wide's input width


def limb_reduce(x: torch.Tensor, keep: int, reduce: bool) -> torch.Tensor:
    """K2's second entry, the launch alone (``x`` on a CUDA device): the
    columns of ``x [R, m]`` (non-negative int64) rippled into ``keep``
    canonical limbs, the carry out of the top limb dropped, as ``[R,
    keep]``; with ``reduce`` (``keep`` <= 32) that value mod p as ``[R,
    16]`` canonical limbs.  One launch, one thread a row.  Its wrappers,
    which take the plain versions on the CPU, are ``carry_propagate`` and
    ``fr.normalize_reduce``.

    Replaces ``zkevm_specs_tpu/ops/limbs.py:carry_propagate`` and, with
    ``reduce``, ``ops/fr.py:reduce_wide`` after it
    (``parallel/logup_shard.py:153-154``)."""
    check_limbs(x, "limb_reduce x")
    cap = MAX_REDUCE_KEEP if reduce else MAX_MUL_OUT
    if not (1 <= keep <= cap and x.shape[-1] >= 1):
        raise ValueError(f"limb_reduce: {x.shape[-1]} columns -> keep {keep} out of range")
    if on_cpu(x):
        raise ValueError("limb_reduce launches on a CUDA tensor: on the CPU call "
                         "carry_propagate or fr.normalize_reduce")
    from ..runtime import cuda_build

    rows = x.shape[0]
    out = torch.empty((rows, 16 if reduce else keep), dtype=DTYPE, device=x.device)
    lib = cuda_build.library("limb_mul")
    err = lib.limb_reduce_launch(x.data_ptr(), x.stride(0), x.shape[-1], out.data_ptr(), keep,
                                 int(reduce), rows, cuda_stream())
    check_launch(err, "limb_reduce")
    return out


# ---------------------------------------------------------------------------
# K3: add / subtract chains, plain and mod p
# ---------------------------------------------------------------------------

ADD, SUB, FR_ADD, FR_SUB = 0, 1, 2, 3
MAX_ADDSUB_LIMBS = 64
_FR_LIMBS = 16


def _p_row(n: int, device) -> torch.Tensor:
    return int_to_limbs(P, n)[None, :].to(device)


def _sub_plain(a: torch.Tensor, b: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = batch_rows(a, b)
    d = (pad_limbs(a, n) - pad_limbs(b, n)).expand(rows, n)
    # each limb's difference is in (-2^16, 2^16): it borrows 1 where it is
    # negative and its incoming borrow where it is 0
    borrow_in, borrow = _carries((d < 0).to(DTYPE), (d == 0).to(DTYPE))
    return (d - borrow_in) & LIMB_MASK, borrow


def addsub_plain(a: torch.Tensor, b: torch.Tensor, mode: int, out_n: int):
    """Plain version of K3 (see ``limb_addsub`` for the modes)."""
    if mode == ADD:
        n = max(a.shape[-1], b.shape[-1])
        s = pad_limbs(a, n) + pad_limbs(b, n)
        return _normalize(s[:, :out_n], out_n, rounds=0)
    if mode == SUB:
        return _sub_plain(a, b, max(a.shape[-1], b.shape[-1]))
    if mode == FR_ADD:
        n = max(a.shape[-1], b.shape[-1], _FR_LIMBS)
        s = addsub_plain(a, b, ADD, max(n, _FR_LIMBS + 1))
        d, borrow = _sub_plain(s, _p_row(s.shape[-1], s.device), s.shape[-1])
        return torch.where((borrow == 0)[:, None], d, s)[:, :_FR_LIMBS]
    if mode == FR_SUB:
        d, borrow = _sub_plain(a, b, _FR_LIMBS)
        d_plus_p = addsub_plain(d, _p_row(_FR_LIMBS, d.device), ADD, _FR_LIMBS)
        return torch.where((borrow == 0)[:, None], d, d_plus_p)
    raise ValueError(f"unknown limb_addsub mode {mode}")


def limb_addsub(a: torch.Tensor, b: torch.Tensor, mode: int, out_n: int = 0):
    """K3 wrapper: the carry and borrow chains.

    Modes, for ``a [B|1, na]`` and ``b [B|1, nb]``:

    * ``ADD``: (a + b) mod 2^(16 out_n) as ``[B, out_n]``;
    * ``SUB``: ((a - b) mod 2^(16n), borrow) with n = max(na, nb), borrow
      an int64 ``[B]`` that is 1 where a < b;
    * ``FR_ADD``: a + b over 17 limbs, then ``reduce_once`` (subtract p
      unless that borrows), low 16 limbs; with b = 0 it is ``reduce_once``;
    * ``FR_SUB``: (a - b) mod 2^256, p added back (mod 2^256) under borrow;
      with a = 0 it is ``fr.neg`` (neg(0) = 0).

    On the card a batch of at least one tile (``csrc/limb_addsub.cu``'s
    ``ADDSUB_TILE``) of a chain of 3 to 17 limbs is staged through shared
    memory; a smaller batch, another width or two ``[1, n]`` rows runs one
    thread a lane (``cuda_build.path_launches`` counts each path).

    Replaces ``zkevm_specs_tpu/ops/limbs.py:add``/``sub`` and
    ``ops/fr.py:add``/``sub``/``neg``/``reduce_once``."""
    check_limbs(a, "limb_addsub a")
    check_limbs(b, "limb_addsub b")
    na, nb = a.shape[-1], b.shape[-1]
    if mode == SUB:
        out_n = max(na, nb)
    elif mode in (FR_ADD, FR_SUB):
        out_n = _FR_LIMBS
        cap = _FR_LIMBS + 1 if mode == FR_ADD else _FR_LIMBS
        if na > cap or nb > cap:
            raise ValueError(f"limb_addsub: Fr mode takes at most {cap} limbs, got {na}, {nb}")
    elif mode != ADD:
        raise ValueError(f"unknown limb_addsub mode {mode}")
    if not (1 <= out_n <= MAX_ADDSUB_LIMBS and max(na, nb) <= MAX_ADDSUB_LIMBS):
        raise ValueError(f"limb_addsub: widths ({na}, {nb} -> {out_n}) out of range")
    rows = batch_rows(a, b)
    if on_cpu(a, b):
        return addsub_plain(a, b, mode, out_n)
    from ..runtime import cuda_build

    out = torch.empty((rows, out_n), dtype=DTYPE, device=a.device)
    borrow = torch.empty((rows,), dtype=DTYPE, device=a.device) if mode == SUB else None
    lib = cuda_build.library("limb_addsub")
    err = lib.limb_addsub_launch(a.data_ptr(), row_stride(a), na, b.data_ptr(), row_stride(b), nb,
                                 out.data_ptr(), out_n,
                                 None if borrow is None else borrow.data_ptr(),
                                 mode, rows, cuda_stream())
    check_launch(err, "limb_addsub")
    return (out, borrow) if mode == SUB else out


# ---------------------------------------------------------------------------
# Addition / subtraction / comparison
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, out_n: int) -> torch.Tensor:
    """(a + b) as an out_n-limb value; caller guarantees it fits."""
    return limb_addsub(a, b, ADD, out_n)


def sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a - b) mod 2^(16n) plus a borrow flag (1 where a < b)."""
    return limb_addsub(a, b, SUB)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean a < b (unsigned), elementwise over the batch."""
    _, borrow = sub(a, b)
    return borrow.bool()


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean a == b, elementwise over the batch."""
    n = max(a.shape[-1], b.shape[-1])
    return (pad_limbs(a, n) == pad_limbs(b, n)).all(dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor, out_n: int = None) -> torch.Tensor:
    """Schoolbook product a [B|1, na] x b [B|1, nb] -> [B, out_n] (default
    na + nb), through K2."""
    if out_n is None:
        out_n = a.shape[-1] + b.shape[-1]
    return limb_mul(a, b, out_n)


def mul_small(a: torch.Tensor, k: int, out_n: int) -> torch.Tensor:
    """Multiply by a small Python-int scalar k < 2^16."""
    assert 0 <= k < LIMB_BASE
    return limb_mul(a, torch.tensor([[k]], dtype=DTYPE, device=a.device), out_n)


# ---------------------------------------------------------------------------
# Division by powers of two, select
# ---------------------------------------------------------------------------

def divmod_pow2(a: torch.Tensor, bits: int, out_n: int = None):
    """(a >> bits, a mod 2^bits) for a static bit count."""
    k, rem_bits = divmod(bits, LIMB_BITS)
    n = a.shape[-1]
    lead = a.shape[:-1]
    if out_n is None:
        out_n = max(1, n - k)

    def zeros(w):
        return torch.zeros(lead + (w,), dtype=DTYPE, device=a.device)

    if rem_bits == 0:
        q = a[..., k:] if k < n else zeros(1)
    else:
        shifted = a[..., k:]
        lo_parts = shifted >> rem_bits
        hi_parts = (shifted & ((1 << rem_bits) - 1)) << (LIMB_BITS - rem_bits)
        q = lo_parts.clone()
        q[..., :-1] |= hi_parts[..., 1:]
    q = pad_limbs(q[..., :out_n], out_n)
    rem_n = k + (1 if rem_bits else 0)
    if rem_n == 0:
        r = zeros(1)
    else:
        parts = [a[..., :min(k, n)]]
        if k > n:
            parts.append(zeros(k - n))
        if rem_bits:
            top = a[..., k:k + 1] & ((1 << rem_bits) - 1) if k < n else zeros(1)
            parts.append(top)
        r = torch.cat(parts, dim=-1)
    return q, r


def divmod_small(a: torch.Tensor, d: int):
    """(a // d, a % d) for a constant 0 < d < 2^16: schoolbook long division
    from the top limb down (the running remainder r < d keeps r * 2^16 +
    limb below 2^32); the quotient keeps a's width, the remainder is
    ``[...]``."""
    assert 0 < d < LIMB_BASE
    r = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    q = []
    for k in range(a.shape[-1] - 1, -1, -1):
        cur = (r << LIMB_BITS) | a[..., k]
        q.append(cur // d)
        r = cur % d
    q.reverse()
    return torch.stack(q, dim=-1), r


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise limb select: cond ? a : b.  cond: bool[...]."""
    n = max(a.shape[-1], b.shape[-1])
    return torch.where(cond[..., None], pad_limbs(a, n), pad_limbs(b, n))
