"""Columnar tables and their three lookup paths.

Counterpart of ``zkevm_specs_tpu/tables/engine.py``.  A table is a
structure of arrays (one limb tensor per column).  The lookup paths:

* eager (host, the trace pass): each static key subset gets a sorted u64
  fingerprint index, computed in numpy ``uint64`` with the JAX package's
  weights and wraparound, so the resolved row, and therefore the hint
  stream, equals the JAX package's; candidates are compared exactly, so
  the fingerprint only routes the search;
* replay (on the device): the trace resolved each query to its row, and
  the lookup is one launch of kernel K4 (``lookup_gather_eq``,
  ``csrc/lookup_gather_eq.cu``): gather the hinted row, compare the
  queried columns limb for limb, return the per-lane verdict.  ``Row``
  gathers any other column lazily, on first access;
* device (a standalone circuit check, no hints): one launch of kernel K6
  (``lookup_search_eq``, ``csrc/lookup_search_eq.cu``) fingerprints each
  lane's query, searches the sorted index and compares the candidates
  exactly.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word, WordOrValue
from ..ops import fr
from ..ops import limbs as L

_GOLDEN = 0x9E3779B97F4A7C15
# _HORNER[k] = GOLDEN^(15-k) mod 2^64: the fingerprint mixes only the limbs
# a value stores while matching the fixed-16-limb Horner result exactly
_HORNER = [pow(_GOLDEN, 15 - k, 1 << 64) for k in range(16)]
_MASK64 = (1 << 64) - 1


class Col:
    """Column spec: scalar field column ("f", with bit bound) or word."""

    def __init__(self, kind: str = "f", bits: int = 254):
        assert kind in ("f", "word")
        self.kind = kind
        self.bits = bits


class Schema:
    def __init__(self, name: str, columns: Mapping[str, Col]):
        self.name = name
        self.columns = dict(columns)

    def weight(self, col: str, part: str) -> int:
        digest = hashlib.sha256(f"zkevm-tpu-lookup/{self.name}/{col}/{part}".encode()).digest()
        return int.from_bytes(digest, "big") % fr.P


# ---------------------------------------------------------------------------
# K4: hinted gather with exact limb compare
# ---------------------------------------------------------------------------

MAX_PARTS = 16


def hint_rows(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The table row of each hint index, as the JAX package's gather under
    XLA resolves it (``F.gather``'s ``lim[idx]``): a negative index counts
    from the end once, then the index is clamped into the table."""
    row = idx.long()
    return torch.where(row < 0, row + n_rows, row).clamp(0, n_rows - 1)


def lookup_gather_eq_plain(table_cols: Sequence[torch.Tensor],
                           query_cols: Sequence[Optional[torch.Tensor]],
                           idx: torch.Tensor, enabled: Optional[torch.Tensor] = None):
    """Plain version of K4 (see ``lookup_gather_eq``)."""
    batch = idx.shape[0]
    row = hint_rows(idx, table_cols[0].shape[0])
    exact = torch.ones((batch,), dtype=torch.bool, device=idx.device)
    gathered = []
    for t, q in zip(table_cols, query_cols):
        g = t[row]
        gathered.append(g)
        if q is not None:
            exact = exact & L.eq(g, q)
    ok = exact if enabled is None else (exact | ~enabled)
    return ok, gathered


def lookup_gather_eq(table_cols: Sequence[torch.Tensor],
                     query_cols: Sequence[Optional[torch.Tensor]],
                     idx: torch.Tensor, enabled: Optional[torch.Tensor] = None,
                     want_ok: bool = True):
    """K4 wrapper: the hinted replay of one lookup.

    ``table_cols``: the table's queried column parts, each ``[T, w_c]``;
    ``query_cols``: the query for each part, ``[B|1, w_q]``, or None for a
    part that is only gathered; ``idx``: the hinted row per lane, ``[B]``
    int32 (resolved by ``hint_rows``); ``enabled``: optional bool ``[B|1]``.
    Returns ``(ok [B] bool, gathered)``, ok = exact | ~enabled (None when
    ``want_ok`` is False), gathered the ``[B, w_c]`` rows of each part.

    On the card a block of threads takes a tile of lanes
    (``csrc/lookup_gather_eq.cu``'s ``GATHER_TILE``) and sweeps their limbs
    together, a batch under one tile as one partial tile.

    Replaces the hint-replay branch of
    ``zkevm_specs_tpu/tables/engine.py:Table.lookup`` with ``_gather_rows``
    and ``F.gather``."""
    n_parts = len(table_cols)
    if not 1 <= n_parts <= MAX_PARTS or len(query_cols) != n_parts:
        raise ValueError(f"lookup_gather_eq: 1..{MAX_PARTS} parts, got {n_parts}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("lookup_gather_eq: idx must be a contiguous [B] int32 tensor")
    batch = idx.shape[0]
    n_rows = table_cols[0].shape[0]
    for t in table_cols:
        L.check_limbs(t, "lookup_gather_eq table")
        if t.shape[0] != n_rows:
            raise ValueError("lookup_gather_eq: table parts differ in row count")
    for q in query_cols:
        if q is not None:
            L.check_limbs(q, "lookup_gather_eq query")
            if q.shape[0] not in (1, batch):
                raise ValueError(f"lookup_gather_eq: query rows {q.shape[0]} vs batch {batch}")
    if enabled is not None and (enabled.dtype != torch.bool or enabled.dim() != 1
                                or enabled.shape[0] not in (1, batch)):
        raise ValueError("lookup_gather_eq: enabled must be a bool [B|1] tensor")
    tensors = [*table_cols, *(q for q in query_cols if q is not None), idx]
    if enabled is not None:
        tensors.append(enabled)
    if L.on_cpu(*tensors):
        ok, gathered = lookup_gather_eq_plain(table_cols, query_cols, idx, enabled)
        return (ok if want_ok else None), gathered
    from ..runtime import cuda_build

    dev = idx.device
    gathered = [torch.empty((batch, t.shape[1]), dtype=L.DTYPE, device=dev) for t in table_cols]
    ok = torch.empty((batch,), dtype=torch.bool, device=dev) if want_ok else None
    u64, i64, i32 = ctypes.c_uint64 * n_parts, ctypes.c_longlong * n_parts, ctypes.c_int * n_parts
    table_ptrs = u64(*(t.data_ptr() for t in table_cols))
    table_strides = i64(*(L.row_stride(t) for t in table_cols))
    table_ws = i32(*(t.shape[1] for t in table_cols))
    query_ptrs = u64(*(0 if q is None else q.data_ptr() for q in query_cols))
    query_strides = i64(*(0 if q is None else L.row_stride(q) for q in query_cols))
    query_ws = i32(*(0 if q is None else q.shape[1] for q in query_cols))
    gathered_ptrs = u64(*(g.data_ptr() for g in gathered))
    lib = cuda_build.library("lookup_gather_eq")
    err = lib.lookup_gather_eq_launch(
        n_parts, ctypes.addressof(table_ptrs), ctypes.addressof(table_strides),
        ctypes.addressof(table_ws), ctypes.addressof(query_ptrs),
        ctypes.addressof(query_strides), ctypes.addressof(query_ws),
        ctypes.addressof(gathered_ptrs), idx.data_ptr(), n_rows,
        None if enabled is None else enabled.data_ptr(),
        0 if enabled is None else L.row_stride(enabled[:, None]),
        None if ok is None else ok.data_ptr(), batch, L.cuda_stream())
    L.check_launch(err, "lookup_gather_eq")
    return ok, gathered


# ---------------------------------------------------------------------------
# K6: fingerprint search with exact limb compare
# ---------------------------------------------------------------------------
#
# The u64 fingerprints live in int64 tensors holding the same bits: int64
# multiply-adds wrap like u64 ones in two's complement, and flipping the
# sign bit turns the u64 order into the int64 order that torch.searchsorted
# and torch.sort use.  The CUDA kernel reads the same buffers as uint64_t.

_SIGN = -(1 << 63)
MAX_CANDIDATES = 8  # span of an index built on the device (the JAX package's
# traced build); an index built on the host carries its exact span
_COEFS: Dict[tuple, torch.Tensor] = {}


def _as_i64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def fingerprint_coefs(schema: Schema, parts: Sequence[Tuple[str, str]], device) -> torch.Tensor:
    """``[n_parts, 16]`` int64: coefficient k of part (column, part name) is
    HORNER[k] * mult mod 2^64, with the JAX package's weights
    (``_fingerprint``, ``engine.py:109-139``), as the int64 of the same bits."""
    key = (schema.name, tuple(parts), str(device))
    t = _COEFS.get(key)
    if t is None:
        rows = []
        for c, part in parts:
            mult = (schema.weight(c, part) & ((1 << 63) - 1)) | 1
            rows.append([_as_i64((h * mult) & _MASK64) for h in _HORNER])
        t = torch.tensor(rows, dtype=torch.int64).to(device)
        _COEFS[key] = t
    return t


def fingerprint_plain(parts: Sequence[torch.Tensor], coefs: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's fingerprint: sum_k limb_k * coef_k over every
    part, wrapping mod 2^64 in int64; ``[rows]`` (``[1]`` when every part is
    a ``[1, w]`` row)."""
    acc = None
    for p, limbs in enumerate(parts):
        for k in range(limbs.shape[-1]):
            term = limbs[:, k] * coefs[p, k]
            acc = term if acc is None else acc + term
    return acc


def _check_parts(parts, name):
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{name}: 1..{MAX_PARTS} parts, got {len(parts)}")
    for t in parts:
        L.check_limbs(t, name)
        if t.shape[1] > 16:
            raise ValueError(f"{name}: a part holds at most 16 limbs, got {t.shape[1]}")


def lookup_fingerprint(parts: Sequence[torch.Tensor], coefs: torch.Tensor) -> torch.Tensor:
    """K6 wrapper, fingerprint entry: the u64 fingerprint of each row of the
    parts (``[T, w]`` each), as int64 ``[T]``.  Builds a table's index on
    the device (``index_for`` under jit, ``engine.py:141-164``)."""
    _check_parts(parts, "lookup_fingerprint")
    rows = parts[0].shape[0]
    if any(t.shape[0] != rows for t in parts) or coefs.shape != (len(parts), 16):
        raise ValueError("lookup_fingerprint: parts differ in rows, or coefs are not [parts, 16]")
    if L.on_cpu(*parts, coefs):
        return fingerprint_plain(parts, coefs)
    from ..runtime import cuda_build

    n_parts = len(parts)
    out = torch.empty((rows,), dtype=torch.int64, device=coefs.device)
    u64, i64, i32 = ctypes.c_uint64 * n_parts, ctypes.c_longlong * n_parts, ctypes.c_int * n_parts
    ptrs = u64(*(t.data_ptr() for t in parts))
    strides = i64(*(L.row_stride(t) for t in parts))
    widths = i32(*(t.shape[1] for t in parts))
    lib = cuda_build.library("lookup_search_eq")
    err = lib.lookup_fingerprint_launch(n_parts, ctypes.addressof(ptrs), ctypes.addressof(strides),
                                        ctypes.addressof(widths), coefs.data_ptr(), out.data_ptr(),
                                        rows, L.cuda_stream())
    L.check_launch(err, "lookup_fingerprint")
    return out


def lookup_search_eq_plain(query_cols, table_cols, coefs, fps, order, max_span: int, batch: int):
    """Plain version of K6 (see ``lookup_search_eq``)."""
    qfp = fingerprint_plain(query_cols, coefs).expand(batch)
    T = fps.shape[0]
    left = torch.searchsorted(fps ^ _SIGN, (qfp ^ _SIGN).contiguous(), side="left")
    n_match = torch.zeros((batch,), dtype=torch.int32, device=fps.device)
    first_row = torch.zeros((batch,), dtype=torch.int32, device=fps.device)
    for k in range(max_span):
        pos = left + k
        slot = pos.clamp(max=T - 1)
        row = order[slot].to(torch.int32)
        exact = (pos < T) & (fps[slot] == qfp)
        for t, q in zip(table_cols, query_cols):
            exact = exact & L.eq(t[row.long()], q)
        first_row = torch.where(exact & (n_match == 0), row, first_row)
        n_match = n_match + exact.to(torch.int32)
    end = left + max_span
    ok_covered = (end >= T) | (fps[end.clamp(max=T - 1)] != qfp)
    return first_row, n_match >= 1, n_match <= 1, ok_covered


def lookup_search_eq(query_cols: Sequence[torch.Tensor], table_cols: Sequence[torch.Tensor],
                     coefs: torch.Tensor, fps: torch.Tensor, order: torch.Tensor,
                     max_span: int, batch: int):
    """K6 wrapper: the fingerprint lookup of one batched query.

    ``query_cols``: the queried parts, ``[B|1, w_q]`` each; ``table_cols``:
    the same parts of the table, ``[T, w_t]``; ``coefs``: their fingerprint
    coefficients (``fingerprint_coefs``); ``fps``: the table's fingerprints
    sorted in u64 order, ``[T]`` int64 holding the u64 bits; ``order``: the
    table row of each sorted slot, ``[T]`` int64; ``max_span``: candidates
    scanned per lane.  For each lane: fingerprint the query, take the lower
    bound in ``fps``, compare the candidates' parts limb for limb (widths
    zero-padded, as ``limbs.eq`` pads), and return ``(first_row [B] int32,
    ok_unsat, ok_unique, ok_covered)`` (bool ``[B]``, before ``enabled``).

    Replaces the non-hinted branch of
    ``zkevm_specs_tpu/tables/engine.py:Table.lookup`` (``engine.py:227-280``)."""
    _check_parts(query_cols, "lookup_search_eq query")
    _check_parts(table_cols, "lookup_search_eq table")
    n_parts = len(query_cols)
    T = fps.shape[0]
    if len(table_cols) != n_parts or coefs.shape != (n_parts, 16):
        raise ValueError("lookup_search_eq: query, table and coefs disagree in parts")
    if any(q.shape[0] not in (1, batch) for q in query_cols):
        raise ValueError(f"lookup_search_eq: query rows must be 1 or {batch}")
    if any(t.shape[0] != T for t in table_cols) or order.shape != (T,) or T < 1:
        raise ValueError("lookup_search_eq: table parts, fps and order differ in rows")
    for name, t in (("fps", fps), ("order", order), ("coefs", coefs)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"lookup_search_eq: {name} must be a contiguous int64 tensor")
    if max_span < 1:
        raise ValueError("lookup_search_eq: max_span must be at least 1")
    if L.on_cpu(*query_cols, *table_cols, coefs, fps, order):
        return lookup_search_eq_plain(query_cols, table_cols, coefs, fps, order, max_span, batch)
    from ..runtime import cuda_build

    dev = fps.device
    first_row = torch.empty((batch,), dtype=torch.int32, device=dev)
    oks = torch.empty((3, batch), dtype=torch.bool, device=dev)
    u64, i64, i32 = ctypes.c_uint64 * n_parts, ctypes.c_longlong * n_parts, ctypes.c_int * n_parts
    q_ptrs = u64(*(q.data_ptr() for q in query_cols))
    q_strides = i64(*(L.row_stride(q) for q in query_cols))
    q_ws = i32(*(q.shape[1] for q in query_cols))
    t_ptrs = u64(*(t.data_ptr() for t in table_cols))
    t_strides = i64(*(L.row_stride(t) for t in table_cols))
    t_ws = i32(*(t.shape[1] for t in table_cols))
    lib = cuda_build.library("lookup_search_eq")
    err = lib.lookup_search_eq_launch(
        n_parts, ctypes.addressof(q_ptrs), ctypes.addressof(q_strides), ctypes.addressof(q_ws),
        ctypes.addressof(t_ptrs), ctypes.addressof(t_strides), ctypes.addressof(t_ws),
        coefs.data_ptr(), fps.data_ptr(), order.data_ptr(), T, max_span,
        first_row.data_ptr(), oks.data_ptr(), batch, L.cuda_stream())
    L.check_launch(err, "lookup_search_eq")
    return first_row, oks[0], oks[1], oks[2]


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _parts(spec: Col, tv: Union[F, Word], qv) -> List[Tuple[F, F]]:
    """(table part, query part) pairs of one queried column, with the query
    coerced as the JAX package's lookup coerces it."""
    if spec.kind == "word":
        if not isinstance(qv, Word):
            qv = WordOrValue(qv)
        return [(tv.lo, qv.lo), (tv.hi, qv.hi)]
    if isinstance(qv, Word):
        qv = qv.lo
    return [(tv, qv)]


class Table:
    """A columnar lookup table over a batch context."""

    def __init__(self, ctx: Ctx, schema: Schema, data: Dict[str, Union[F, Word]], n_rows: int):
        self.ctx = ctx
        self.schema = schema
        self.data = data
        self.n_rows = n_rows
        self._indexes: Dict[Tuple[str, ...], Tuple] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_rows(cls, ctx: Ctx, schema: Schema, rows: Sequence[Mapping[str, int]]) -> "Table":
        """Build from host-side rows of Python ints (words as ints < 2^256).

        Duplicate rows are collapsed, mirroring the reference's use of
        Python sets for tables (table.py:578-625)."""
        cols = list(schema.columns)
        seen = set()
        uniq: List[Tuple[int, ...]] = []
        for r in rows:
            t = tuple(int(r.get(c, 0)) for c in cols)
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        data: Dict[str, Union[F, Word]] = {}
        row_ctx = Ctx(ctx.device, len(uniq), ctx.mode)
        for j, c in enumerate(cols):
            spec = schema.columns[c]
            vals = [t[j] for t in uniq]
            if spec.kind == "word":
                data[c] = Word.from_ints(row_ctx, vals)
            else:
                data[c] = F.from_ints(row_ctx, vals, spec.bits)
        return cls(ctx, schema, data, len(uniq))

    def to_backend(self, ctx: Ctx) -> "Table":
        """The same columns and built indexes bound to another batch context
        (the JAX package's ``Table.to_backend``, :300-311; here the data
        stays where it is, and only the queries' context changes)."""
        out = Table(ctx, self.schema, self.data, self.n_rows)
        out._indexes = dict(self._indexes)
        return out

    # -- fingerprint index (host, numpy uint64) -----------------------------

    def _fingerprint(self, subset: Tuple[str, ...], values: Mapping[str, Union[F, Word]]):
        """u64 mixing hash of the subset columns (wraps mod 2^64).  It only
        *routes* the search; verdicts come from the exact compare."""
        acc = None
        for c in subset:
            v = values[c]
            if self.schema.columns[c].kind == "word":
                assert isinstance(v, Word)
                parts = [("lo", v.lo), ("hi", v.hi)]
            else:
                parts = [("f", v if isinstance(v, F) else v.value())]
            for part_name, fv in parts:
                mult = (self.schema.weight(c, part_name) & ((1 << 63) - 1)) | 1
                limbs = fv.limbs.cpu().numpy().astype(np.uint64)
                col_acc = None
                for k in range(limbs.shape[-1]):
                    term = limbs[..., k] * np.uint64((_HORNER[k] * mult) & _MASK64)
                    col_acc = term if col_acc is None else col_acc + term
                acc = col_acc if acc is None else acc + col_acc
        return acc

    def _part_names(self, subset: Tuple[str, ...]) -> List[Tuple[str, str]]:
        out = []
        for c in subset:
            names = ("lo", "hi") if self.schema.columns[c].kind == "word" else ("f",)
            out += [(c, p) for p in names]
        return out

    def index_for(self, subset: Tuple[str, ...]):
        """(sorted fingerprints, row of each slot, span) of a key subset.
        Built once on the host in the eager pass (numpy ``uint64``, exact
        span); a device context without a prebuilt index builds it on the
        device on each check with span ``MAX_CANDIDATES``, as the JAX
        package builds an index under jit (``engine.py:141-164``)."""
        idx = self._indexes.get(subset)
        if idx is None and not self.ctx.eager:
            parts = [getattr(self.data[c], p) if p != "f" else self.data[c]
                     for c, p in self._part_names(subset)]
            coefs = fingerprint_coefs(self.schema, self._part_names(subset), self.ctx.device)
            fps = lookup_fingerprint([v.limbs for v in parts], coefs)
            order = torch.sort(fps ^ _SIGN, stable=True).indices
            idx = (fps[order].contiguous(), order, MAX_CANDIDATES)
            self._indexes[subset] = idx
        elif idx is None:
            fps = self._fingerprint(subset, self.data)
            order = np.argsort(fps)
            sorted_fps = fps[order]
            if sorted_fps.size:
                _, counts = np.unique(sorted_fps, return_counts=True)
                max_span = int(counts.max())
            else:
                max_span = 1
            idx = (sorted_fps, order, max_span)
            self._indexes[subset] = idx
        return idx

    # -- query -------------------------------------------------------------

    def lookup(self, cs: ConstraintSystem, query: Mapping[str, Union[F, Word, None]],
               enabled=None) -> "Row":
        """Resolve a batched query; returns the matched rows.

        ``enabled``: optional bool mask — lanes where False are not
        constrained and get arbitrary row values.
        """
        ctx = self.ctx
        subset = tuple(k for k, v in query.items() if v is not None)
        for k in subset:
            assert k in self.schema.columns, (self.schema.name, k)

        if self.n_rows == 0:
            bad = torch.ones((ctx.batch,), dtype=torch.bool, device=ctx.device)
            if enabled is not None:
                bad = bad & enabled
            cs.check(~bad, lambda: f"Lookup {self.schema.name} on empty table")
            zero = {}
            for c, spec in self.schema.columns.items():
                zero[c] = Word.const(ctx, 0) if spec.kind == "word" else F.const(ctx, 0)
            return Row(self, None, zero)

        if cs.hint_replay is not None:
            return self._replay_lookup(cs, query, subset, enabled)
        if ctx.mode == "device":
            return self._device_lookup(cs, query, subset, enabled)
        return self._eager_lookup(cs, query, subset, enabled)

    def _device_lookup(self, cs, query, subset, enabled) -> "Row":
        """No hints on the device: one K6 launch fingerprints each lane's
        query, searches the sorted index and compares the candidates
        exactly; the checks, their order and their messages are those of
        the JAX package's non-eager branch (``engine.py:264-280``)."""
        sorted_fps, order, max_span = self.index_for(subset)
        names = self._part_names(subset)
        pairs = []
        for c in subset:
            if self.schema.columns[c].kind == "word":
                assert isinstance(query[c], Word), (self.schema.name, c)
            pairs += _parts(self.schema.columns[c], self.data[c], query[c])
        coefs = fingerprint_coefs(self.schema, names, self.ctx.device)
        first_row, ok_unsat, ok_unique, ok_covered = lookup_search_eq(
            [q.limbs for _, q in pairs], [t.limbs for t, _ in pairs], coefs,
            sorted_fps, order, max_span, self.ctx.batch)
        if enabled is not None:
            ok_unsat, ok_unique, ok_covered = (m | ~enabled for m in (ok_unsat, ok_unique, ok_covered))
        name = self.schema.name
        cs.check(ok_covered, lambda: f"Lookup {name} candidate span exceeded "
                                     f"(fingerprint run longer than {max_span})")
        cs.check(ok_unsat, lambda: f"Lookup {name} unsat")
        cs.check(ok_unique, lambda: f"Lookup {name} ambiguous")
        return Row(self, first_row)

    def _replay_lookup(self, cs, query, subset, enabled) -> "Row":
        """The eager trace resolved the query to its row: one K4 launch
        gathers it and exact-compares the queried columns."""
        assert cs.hint_bits[cs._hint_idx] == "lookup_idx", "hint stream misaligned at a table lookup"
        row_idx = cs.hint_replay[cs._hint_idx]["idx"]
        cs._hint_idx += 1
        pairs = []
        for c in subset:
            pairs += _parts(self.schema.columns[c], self.data[c], query[c])
        ok, gathered = lookup_gather_eq([t.limbs for t, _ in pairs], [q.limbs for _, q in pairs],
                                        row_idx, enabled)
        name = self.schema.name
        cs.check(ok, lambda: f"Lookup {name} unsat")
        cols = {}
        it = iter(zip(pairs, gathered))
        for c in subset:
            if self.schema.columns[c].kind == "word":
                (lo, _), g_lo = next(it)
                (hi, _), g_hi = next(it)
                cols[c] = Word(F(self.ctx, g_lo, lo.bits), F(self.ctx, g_hi, hi.bits))
            else:
                (t, _), g = next(it)
                cols[c] = F(self.ctx, g, t.bits)
        return Row(self, row_idx, cols)

    def _eager_lookup(self, cs, query, subset, enabled) -> "Row":
        """The host search of the eager pass (numpy); it reads the limbs
        back to the host, so only an eager context may reach it."""
        ctx = self.ctx
        assert ctx.eager, f"host lookup search reached from a {ctx.mode!r} context"
        batch = ctx.batch
        sorted_fps, order, max_span = self.index_for(subset)
        qfp = np.broadcast_to(self._fingerprint(subset, {k: query[k] for k in subset}), (batch,))
        left = np.searchsorted(sorted_fps, qfp, side="left")
        n_match = np.zeros((batch,), dtype=np.int32)
        first_row = np.zeros((batch,), dtype=np.int32)
        T = self.n_rows
        for k in range(max_span):
            slot = np.minimum(left + k, T - 1)
            in_span = ((left + k) < T) & (sorted_fps[slot] == qfp)
            row_idx = order[slot].astype(np.int32)
            ridx = torch.from_numpy(row_idx.astype(np.int64))
            exact = torch.from_numpy(in_span)
            for c in subset:
                for tv, qv in _parts(self.schema.columns[c], self.data[c], query[c]):
                    exact = exact & tv.gather(ridx).eq_mask(qv)
            exact = exact.numpy()
            is_first = exact & (n_match == 0)
            first_row = np.where(is_first, row_idx, first_row)
            n_match = n_match + exact.astype(np.int32)
        ok_unsat = n_match >= 1
        ok_unique = n_match <= 1
        # the candidate loop covers the query's whole equal-fingerprint run
        # (max_span is the exact table-wide maximum), so this always holds;
        # it is kept so the trace records the JAX package's constraints
        end_slot = np.minimum(left + max_span, T - 1)
        ok_covered = ((left + max_span) >= T) | (sorted_fps[end_slot] != qfp)
        masks = [torch.from_numpy(np.ascontiguousarray(m)) for m in (ok_covered, ok_unsat, ok_unique)]
        if enabled is not None:
            masks = [m | ~enabled for m in masks]
        name = self.schema.name
        cs.check(masks[0], lambda: f"Lookup {name} candidate span exceeded "
                                   f"(fingerprint run longer than {max_span})")
        qd = {k: query[k] for k in subset}
        cs.check(masks[1], lambda: f"Lookup {name} is unsatisfied on inputs {qd}")
        cs.check(masks[2], lambda: f"Lookup {name} is ambiguous on inputs {qd}")
        if cs.hint_record is not None:
            # two-phase hint protocol: ship the resolved row index so the
            # replay does this lookup as a single gather
            cs.hint_record.append({"idx": first_row.astype(np.int32)})
            cs.hint_bits.append("lookup_idx")
        if cs.lookup_log is not None:
            # the logUp query side (parallel/logup_shard.py): the resolved
            # row of each lane and its enable bit.  The JAX package logs the
            # gathered row itself (engine.py:287-297); those values are the
            # host table's row at the index, so the query side is
            # fingerprinted from the table's rows at these indexes
            en = (np.ones((batch,), dtype=bool) if enabled is None
                  else np.broadcast_to(enabled.numpy(), (batch,)).copy())
            cs.lookup_log.append((self.schema.name, first_row.astype(np.int64), en))
        return Row(self, torch.from_numpy(first_row.astype(np.int64)))

    def gather_column(self, name: str, row_idx: torch.Tensor) -> Union[F, Word]:
        """Column ``name`` at the given rows: F.gather on the host in the
        eager pass, a gather-only K4 launch in the replay."""
        v = self.data[name]
        if self.ctx.eager:
            return v.gather(row_idx)
        parts = [v.lo, v.hi] if isinstance(v, Word) else [v]
        _, gathered = lookup_gather_eq([p.limbs for p in parts], [None] * len(parts),
                                       row_idx, want_ok=False)
        out = [F(self.ctx, g, p.bits) for p, g in zip(parts, gathered)]
        return Word(*out) if isinstance(v, Word) else out[0]


class Row:
    """A batch of table rows with attribute access.  Columns that the
    lookup did not already gather are gathered on first access."""

    def __init__(self, table: Table, row_idx, cols: Optional[Dict[str, Union[F, Word]]] = None):
        self._table = table
        self._idx = row_idx
        self._cols = dict(cols or {})

    def __getattr__(self, name):
        d = self.__dict__
        if "_cols" not in d:
            raise AttributeError(name)
        cols = d["_cols"]
        if name not in cols:
            table = d["_table"]
            if name not in table.data:
                raise AttributeError(f"{table.schema.name} row has no column {name}")
            cols[name] = table.gather_column(name, d["_idx"])
        return cols[name]
