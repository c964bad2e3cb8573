"""The logUp lookup argument: multiset fingerprints and batched inverses.

Counterpart of ``zkevm_specs_tpu/tables/logup.py``.  A lookup family holds
when its queries form a sub-multiset of the table, which one field
equation checks:

    sum_i en_i / (alpha - q_i)  ==  sum_j m_j / (alpha - t_j)

with q_i / t_j sound Fr fingerprints (a random-weight combination of the
key columns), m_j the multiplicities and alpha a random challenge.

The inverses are Montgomery's batch inverse: kernel K13 (``logup_sum``,
``csrc/logup_sum.cu``) builds the product tree and, from the inverse of
the total (kernel K12, ``fr.inv``), every element's inverse, or forms
``alpha - fp_i`` and the partial sum on the way.  The plain versions
(``batch_inverse_plain``, ``logup_partial_sum_plain``) run for tensors on
the CPU.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..dsl.value import Ctx, F
from ..ops import fr
from ..ops import limbs as L

NL = fr.NL


def fingerprint_fr(ctx: Ctx, schema, subset: Tuple[str, ...], values) -> torch.Tensor:
    """Sound Fr fingerprint ``sum_j w_j * col_j`` with the schema's fixed
    random weights, as ``[B, 16]`` limbs (full-field; the u64 router hash of
    ``engine.py`` is not sound on its own)."""
    acc = None
    for c in subset:
        v = values[c]
        spec = schema.columns[c]
        parts = ([("lo", v.lo), ("hi", v.hi)] if spec.kind == "word"
                 else [("f", v if isinstance(v, F) else v.value())])
        for part_name, fv in parts:
            w = F.const(ctx, schema.weight(c, part_name))
            term = (fv * w).widen(NL).limbs
            acc = term if acc is None else fr.add(acc, term)
    return acc


# ---------------------------------------------------------------------------
# K13: batch inverse and partial sum
# ---------------------------------------------------------------------------

def _scan_mul(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products of the rows of ``x`` by a log-depth
    (Hillis-Steele) scan of ``fr_mul_plain``."""
    out = x
    d = 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], fr.fr_mul_plain(out[d:], out[:-d])])
        d *= 2
    return out


def _inverse_parts(x: torch.Tensor):
    """``batch_inverse_plain`` before its inverse: ``(prefix[i-1] *
    suffix[i+1], the total [1, 16])``."""
    x = L.pad_limbs(x, NL)
    prefix = _scan_mul(x)
    suffix = _scan_mul(x.flip(0)).flip(0)
    one = L.int_to_limbs(1, NL)[None, :].to(x.device)
    prefix_shift = torch.cat([one, prefix[:-1]])
    suffix_shift = torch.cat([suffix[1:], one])
    return fr.fr_mul_plain(prefix_shift, suffix_shift), prefix[-1:]


def batch_inverse_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13's batch inverse: the JAX package's jit branch
    (logup.py:71-84), prefix and suffix products by a log-depth scan, one
    inverse of the total, ``inv[i] = prefix[i-1] * suffix[i+1] *
    total_inv``.  One zero element zeroes every output."""
    shifted, total = _inverse_parts(x)
    return fr.fr_mul_plain(shifted, fr.inv_plain(total))


def _pairwise_sum_plain(inv: torch.Tensor, multiplicities: Optional[torch.Tensor]) -> torch.Tensor:
    """``sum_i m_i * inv_i`` by the JAX package's pairwise tree of Fr adds
    (logup.py:87-106); ``[16]``."""
    total = inv if multiplicities is None else fr.fr_mul_plain(inv, multiplicities)
    while total.shape[0] > 1:
        half = total.shape[0] // 2
        lead = L.addsub_plain(total[:half], total[half:2 * half], L.FR_ADD, NL)
        if total.shape[0] % 2:
            last = L.addsub_plain(lead[-1:], total[-1:], L.FR_ADD, NL)
            lead = torch.cat([lead[:-1], last])
        total = lead
    return total[0]


def logup_partial_sum_plain(fps: torch.Tensor, alpha: torch.Tensor,
                            multiplicities: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K13's partial sum: ``sum_i m_i / (alpha - fp_i)``
    with the JAX package's pairwise tree of Fr adds (logup.py:87-106);
    ``[16]``."""
    denom = L.addsub_plain(alpha.reshape(1, -1), fps, L.FR_SUB, NL)
    return _pairwise_sum_plain(batch_inverse_plain(denom), multiplicities)


def logup_partial_sums_plain(sides) -> List[torch.Tensor]:
    """``logup_partial_sum_plain`` at several sides ``(fps, alpha, m)``:
    each side's scans, one ``fr.inv_plain`` over every side's total (a lane
    each: the plain chain's 309 products cost their launches, whatever the
    lanes), each side's sum; a ``[16]`` a side, each equal to
    ``logup_partial_sum_plain`` at its side."""
    parts = [_inverse_parts(L.addsub_plain(alpha.reshape(1, -1), fps, L.FR_SUB, NL))
             for fps, alpha, _ in sides]
    total_inv = fr.inv_plain(torch.cat([total for _, total in parts]))
    return [_pairwise_sum_plain(fr.fr_mul_plain(shifted, total_inv[i:i + 1]), m)
            for i, ((shifted, _), (_, _, m)) in enumerate(zip(parts, sides))]


def batch_inverse_ints(vals: List[int]) -> List[int]:
    """Montgomery's batch inverse on Python ints, independent of the limb
    code (every output 0 after a zero element): the reference K13 is held
    against on the card."""
    prefix, acc = [], 1
    for v in vals:
        acc = acc * v % fr.P
        prefix.append(acc)
    inv, out = pow(acc, fr.P - 2, fr.P), [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * (prefix[i - 1] if i else 1) % fr.P
        inv = inv * vals[i] % fr.P
    return out


def logup_partial_sum_ints(fps: List[int], alpha: int, m: Optional[List[int]] = None) -> int:
    """``sum_i m_i / (alpha - fp_i) mod p`` on Python ints (m None: every
    m_i is 1)."""
    inv = batch_inverse_ints([(alpha - v) % fr.P for v in fps])
    return sum(inv if m is None else (mi * ii for mi, ii in zip(m, inv))) % fr.P


# csrc/logup_sum.cu's tile, fixed when it is compiled (its LOGUP_THREADS
# and LOGUP_RUN): threads a block times elements a thread (the run); 1024
# elements, so a level shrinks 1024-fold (sized on the card by
# ``profile_replay.py --logup``)
LOGUP_THREADS = 256
LOGUP_RUN = 4


class LogupPlan(NamedTuple):
    """K13's plan for n elements (``make_plan`` in ``csrc/logup_sum.cu``,
    which refuses any other): ``levels[l]`` elements at level l, from n
    down to the one total; level l + 1 holds the products of level l's
    tiles of ``tile = threads * run`` consecutive elements; the workspace
    holds the elements of every level below the top, 8 uint32 words each."""
    levels: Tuple[int, ...]
    threads: int
    run: int
    words: int

    @property
    def tile(self) -> int:
        return self.threads * self.run

    @property
    def depth(self) -> int:
        """L: the levels with a tile pass (at least one)."""
        return len(self.levels) - 1

    def tile_elements(self, level: int, t: int) -> List[List[int]]:
        """The elements of tile t at ``level``, per thread, in run order
        (thread j: ``t * tile + j + k * threads``, k < run, below the
        level's count)."""
        n = self.levels[level]
        return [[i for i in (t * self.tile + j + k * self.threads for k in range(self.run))
                 if i < n] for j in range(self.threads)]

    def launches(self, sum_mode: bool) -> Tuple[int, int]:
        """Device launches of the up and the down entry (K12 between them
        makes one more): a tile pass a level each way, and in the partial
        sum one launch that adds the tile sums when there are several."""
        return self.depth, self.depth + int(sum_mode and self.depth > 1)


def logup_plan(n: int) -> LogupPlan:
    """K13's levels and workspace for n >= 1 elements at the tile of
    ``LOGUP_THREADS`` and ``LOGUP_RUN``."""
    levels = [n]
    while True:
        levels.append(-(-levels[-1] // (LOGUP_THREADS * LOGUP_RUN)))
        if levels[-1] == 1:
            break
    return LogupPlan(tuple(levels), LOGUP_THREADS, LOGUP_RUN, 8 * sum(levels[:-1]))


def logup_workspace_words(n: int) -> int:
    """uint32 words of K13's workspace for n elements."""
    return logup_plan(n).words


def device_launches() -> Tuple[int, int]:
    """The kernels launched so far by K13's up and down entries, as
    ``csrc/logup_sum.cu`` counts them at each launch (K12's launch between
    them counts under ``fr_inv``)."""
    from ..runtime import cuda_build

    up, down = ctypes.c_int(), ctypes.c_int()
    cuda_build.library("logup_sum").logup_device_launches(ctypes.byref(up), ctypes.byref(down))
    return up.value, down.value


def _check_elements(x: torch.Tensor, name: str) -> None:
    L.check_limbs(x, name)
    if x.shape[0] < 1 or not 1 <= x.shape[1] <= NL:
        raise ValueError(f"{name}: expected [n >= 1, <= {NL}] limbs, got {tuple(x.shape)}")


def _logup_launch(x, alpha, m, out, sum_mode: bool) -> None:
    """K13's up entry, K12 on the total, K13's down entry."""
    from ..runtime import cuda_build

    n = x.shape[0]
    plan = logup_plan(n)
    work = torch.empty((plan.words,), dtype=torch.int32, device=x.device)
    top = torch.empty((1, NL), dtype=L.DTYPE, device=x.device)
    lib = cuda_build.library("logup_sum")
    shape = (plan.depth, work.data_ptr(), plan.words)
    a_ptr = None if alpha is None else alpha.data_ptr()
    err = lib.logup_up_launch(x.data_ptr(), L.row_stride(x), x.shape[1], a_ptr, n, *shape,
                              top.data_ptr(), L.cuda_stream())
    L.check_launch(err, "logup_sum")
    top_inv = fr.inv(top)
    m_ptr, m_stride, m_w = (None, 0, 0) if m is None else (m.data_ptr(), L.row_stride(m), m.shape[1])
    err = lib.logup_down_launch(n, m_ptr, m_stride, m_w, *shape, top_inv.data_ptr(),
                                out.data_ptr(), int(sum_mode), L.cuda_stream())
    L.check_launch(err, "logup_sum")


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """K13 wrapper: the inverse of every row of ``x [n, <=16]`` (canonical
    Fr values), ``[n, 16]``; one zero row zeroes every output.

    Replaces ``zkevm_specs_tpu/tables/logup.py:batch_inverse`` (:49-84)."""
    _check_elements(x, "batch_inverse x")
    if L.on_cpu(x):
        return batch_inverse_plain(x)
    out = torch.empty((x.shape[0], NL), dtype=L.DTYPE, device=x.device)
    _logup_launch(x, None, None, out, sum_mode=False)
    return out


def logup_partial_sum(fps: torch.Tensor, alpha: torch.Tensor,
                      multiplicities: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13 wrapper: ``sum_i m_i / (alpha - fp_i)`` for ``fps [n, <=16]``,
    ``alpha`` one 16-limb row and ``multiplicities [n, <=16]`` (None: every
    m_i is 1), as a ``[16]`` canonical value; 0 when some fp_i equals
    alpha (the batch inverse's zero rule).

    Replaces ``zkevm_specs_tpu/tables/logup.py:logup_partial_sum``
    (:87-106)."""
    fps, alpha, multiplicities = _check_side(fps, alpha, multiplicities)
    if L.on_cpu(*(t for t in (fps, alpha, multiplicities) if t is not None)):
        return logup_partial_sum_plain(fps, alpha, multiplicities)
    out = torch.empty((NL,), dtype=L.DTYPE, device=fps.device)
    _logup_launch(fps, alpha.contiguous(), multiplicities, out, sum_mode=True)
    return out


def logup_partial_sums(sides) -> List[torch.Tensor]:
    """``logup_partial_sum`` at several sides ``(fps, alpha, m)``, each
    checked as it checks its inputs: on the card ``logup_partial_sum`` a
    side, on the CPU ``logup_partial_sums_plain`` (one inverse for every
    side)."""
    sides = [_check_side(*side) for side in sides]
    if L.on_cpu(*(t for side in sides for t in side if t is not None)):
        return logup_partial_sums_plain(sides)
    return [logup_partial_sum(*side) for side in sides]


def _check_side(fps: torch.Tensor, alpha: torch.Tensor, multiplicities: Optional[torch.Tensor]):
    """``logup_partial_sum``'s inputs checked; ``alpha`` as one row."""
    _check_elements(fps, "logup_partial_sum fps")
    alpha = alpha.reshape(1, -1)
    L.check_limbs(alpha, "logup_partial_sum alpha")
    if alpha.shape[1] != NL:
        raise ValueError(f"logup_partial_sum: alpha takes {NL} limbs, got {alpha.shape[1]}")
    if multiplicities is not None:
        _check_elements(multiplicities, "logup_partial_sum multiplicities")
        if multiplicities.shape[0] != fps.shape[0]:
            raise ValueError("logup_partial_sum: multiplicities and fps differ in rows")
    return fps, alpha, multiplicities


def multiset_check(ctx: Ctx, query_fps, table_fps, multiplicities, alpha: int) -> bool:
    """Single-device logUp check: the queries form a sub-multiset of the
    table with the witnessed multiplicities."""
    alpha_l = L.int_to_limbs(alpha % fr.P, NL).to(ctx.device)
    lhs = logup_partial_sum(query_fps, alpha_l)
    rhs = logup_partial_sum(table_fps, alpha_l, multiplicities)
    return bool(L.eq(lhs[None, :], rhs[None, :]).item())


def compute_multiplicities(query_fps_host, table_fps_host, ctx: Ctx) -> torch.Tensor:
    """Witness-side multiplicity counting (host): how many queries hit each
    table row, as ``[T, 16]`` limbs."""
    def rows(t):
        return [tuple(r) for r in torch.as_tensor(t).tolist()]

    counts = Counter(rows(query_fps_host))
    mult = [counts.get(r, 0) for r in rows(table_fps_host)]
    return F.from_ints(ctx, mult, 64).widen(NL).limbs
