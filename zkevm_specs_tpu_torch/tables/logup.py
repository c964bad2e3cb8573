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

from collections import Counter
from typing import Optional, Tuple

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


def batch_inverse_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13's batch inverse: the JAX package's jit branch
    (logup.py:71-84), prefix and suffix products by a log-depth scan, one
    inverse of the total, ``inv[i] = prefix[i-1] * suffix[i+1] *
    total_inv``.  One zero element zeroes every output."""
    x = L.pad_limbs(x, NL)
    prefix = _scan_mul(x)
    total_inv = fr.inv_plain(prefix[-1:])
    suffix = _scan_mul(x.flip(0)).flip(0)
    one = L.int_to_limbs(1, NL)[None, :].to(x.device)
    prefix_shift = torch.cat([one, prefix[:-1]])
    suffix_shift = torch.cat([suffix[1:], one])
    return fr.fr_mul_plain(fr.fr_mul_plain(prefix_shift, suffix_shift), total_inv)


def logup_partial_sum_plain(fps: torch.Tensor, alpha: torch.Tensor,
                            multiplicities: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K13's partial sum: ``sum_i m_i / (alpha - fp_i)``
    with the JAX package's pairwise tree of Fr adds (logup.py:87-106);
    ``[16]``."""
    denom = L.addsub_plain(alpha.reshape(1, -1), fps, L.FR_SUB, NL)
    total = batch_inverse_plain(denom)
    if multiplicities is not None:
        total = fr.fr_mul_plain(total, multiplicities)
    while total.shape[0] > 1:
        half = total.shape[0] // 2
        lead = L.addsub_plain(total[:half], total[half:2 * half], L.FR_ADD, NL)
        if total.shape[0] % 2:
            last = L.addsub_plain(lead[-1:], total[-1:], L.FR_ADD, NL)
            lead = torch.cat([lead[:-1], last])
        total = lead
    return total[0]


LOGUP_CHUNK = 16   # csrc/logup_sum.cu's chunk of a level


def logup_workspace_words(n: int) -> int:
    """uint32 words of K13's workspace for n elements (the layout of
    ``make_plan`` in ``csrc/logup_sum.cu``)."""
    levels = [n]
    while True:
        levels.append(-(-levels[-1] // LOGUP_CHUNK))
        if levels[-1] == 1:
            break
    top = len(levels) - 1
    return NL * (sum(levels[:top]) + sum(levels[1:]) + sum(levels[1:top]))


def _check_elements(x: torch.Tensor, name: str) -> None:
    L.check_limbs(x, name)
    if x.shape[0] < 1 or not 1 <= x.shape[1] <= NL:
        raise ValueError(f"{name}: expected [n >= 1, <= {NL}] limbs, got {tuple(x.shape)}")


def _logup_launch(x, alpha, m, out, sum_mode: bool) -> None:
    """K13's up entry, K12 on the total, K13's down entry."""
    from ..runtime import cuda_build

    n = x.shape[0]
    words = logup_workspace_words(n)
    work = torch.empty((words,), dtype=torch.int32, device=x.device)
    top = torch.empty((1, NL), dtype=L.DTYPE, device=x.device)
    lib = cuda_build.library("logup_sum")
    a_ptr = None if alpha is None else alpha.data_ptr()
    err = lib.logup_up_launch(x.data_ptr(), L.row_stride(x), x.shape[1], a_ptr, n,
                              work.data_ptr(), words, top.data_ptr(), L.cuda_stream())
    L.check_launch(err, "logup_sum")
    top_inv = fr.inv(top)
    m_ptr, m_stride, m_w = (None, 0, 0) if m is None else (m.data_ptr(), L.row_stride(m), m.shape[1])
    err = lib.logup_down_launch(x.data_ptr(), L.row_stride(x), x.shape[1], a_ptr, n, m_ptr,
                                m_stride, m_w, work.data_ptr(), words, top_inv.data_ptr(),
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
    _check_elements(fps, "logup_partial_sum fps")
    alpha = alpha.reshape(1, -1)
    L.check_limbs(alpha, "logup_partial_sum alpha")
    if alpha.shape[1] != NL:
        raise ValueError(f"logup_partial_sum: alpha takes {NL} limbs, got {alpha.shape[1]}")
    tensors = [fps, alpha]
    if multiplicities is not None:
        _check_elements(multiplicities, "logup_partial_sum multiplicities")
        if multiplicities.shape[0] != fps.shape[0]:
            raise ValueError("logup_partial_sum: multiplicities and fps differ in rows")
        tensors.append(multiplicities)
    if L.on_cpu(*tensors):
        return logup_partial_sum_plain(fps, alpha, multiplicities)
    out = torch.empty((NL,), dtype=L.DTYPE, device=fps.device)
    _logup_launch(fps, alpha.contiguous(), multiplicities, out, sum_mode=True)
    return out


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
