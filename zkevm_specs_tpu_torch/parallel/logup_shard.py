"""The lookup argument of a block: logUp partial sums on one device.

Counterpart of ``zkevm_specs_tpu/parallel/logup_shard.py`` at world size
1: the table side and the query side of each lookup family, their logUp
partial sums

    lhs = sum_{queries}  en_i / (alpha - q_i)
    rhs = sum_{rows}     m_j / (alpha - t_j)

and their compare, with no collective (the multi-device form, a sum of
both sides over the ranks, is not ported).

Binding: the QUERY side is fingerprinted from the rows the constraints
consumed, the host table's rows at the indexes the eager pass resolved
(``tables/engine.py``'s lookup log), taken from a copy of the table made
before any tampering; the TABLE side is fingerprinted on the device from
the raw column parts that the check is handed.  A corrupted table part
therefore moves rhs and not lhs, and the identity fails.

On the card the fingerprints run on K4 (the gather by the logged index),
K1 and K3, both partial sums on K13 with K12 between its passes, both
sides' normalisation and reduction on one launch of K2's second entry, and
the compare reads back one bool.

``table_fingerprints`` and ``query_fingerprints_from_log`` (like
``tables/logup.py``'s ``multiset_check`` and ``compute_multiplicities``)
are the JAX module's host helpers, kept as the fixtures that the parity
tests hold against it; the block check fingerprints through
``family_inputs``.  The JAX padding of both sides to a multiple of the
world size pads nothing on one device and returns with the multi-device
form; of it only the rule that a zero query fingerprint becomes 1 acts.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dsl.value import Ctx, F
from ..ops import fr
from ..ops import limbs as L
from ..runtime.kernels import require_device
from ..tables.engine import MAX_PARTS, Table, lookup_gather_eq
from ..tables.logup import fingerprint_fr, logup_partial_sum

# the lookup families the JAX package's ShardedBlockVerifier proves
# (parallel/block_shard.py:39-42)
LOGUP_TABLES = ("rw", "bytecode", "copy", "exp", "keccak", "tx", "block", "sig", "ecc",
                "withdrawal")
# the challenge of a block's check (the JAX verify_block_lookups_logup's)
ALPHA = 0xA1FA


def table_fingerprints(table: Table) -> torch.Tensor:
    """``[n_rows, 16]`` sound Fr fingerprints of every full table row (host
    helper for single-device checks and tests)."""
    ctx = Ctx("cpu", table.n_rows, "eager")
    return fingerprint_fr(ctx, table.schema, tuple(table.schema.columns), table.data)


def part_names(schema) -> List[Tuple[str, str]]:
    """(column, part) of every column part in schema order: "f", or "lo"
    then "hi" for a word column."""
    return [(c, p) for c, spec in schema.columns.items()
            for p in (("lo", "hi") if spec.kind == "word" else ("f",))]


def table_parts(table: Table) -> List[Tuple[int, torch.Tensor]]:
    """The raw column parts of a table with their fingerprint weights,
    ``[(weight, [n_rows, w] limbs), ...]`` in schema order.  Each part keeps
    its column's width; zero-padded to 16 limbs it is the JAX
    ``table_parts`` array."""
    parts = []
    for c, p in part_names(table.schema):
        v = table.data[c]
        limbs = getattr(v, p).limbs if p != "f" else (v if isinstance(v, F) else v.value()).limbs
        parts.append((int(table.schema.weight(c, p)), limbs))
    return parts


def fingerprint_parts(parts: List[Tuple[int, torch.Tensor]],
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_k w_k * part_k`` over the parts' rows, or over their rows at
    ``idx`` (int32 ``[Q]``; a gather-only K4 launch for every 16 parts), as
    ``[rows, 16]`` limbs: the products on K1, the sums on K3."""
    cols = [c for _, c in parts]
    if idx is not None:
        gathered: List[torch.Tensor] = []
        for k in range(0, len(cols), MAX_PARTS):
            chunk = cols[k:k + MAX_PARTS]
            gathered += lookup_gather_eq(chunk, [None] * len(chunk), idx, want_ok=False)[1]
        cols = gathered
    acc = None
    for (w, _), col in zip(parts, cols):
        term = fr.mul(col, Ctx(col.device, 1).const_limbs(w % fr.P, fr.NL))
        acc = term if acc is None else fr.add(acc, term)
    return acc


def _concat_log(logged) -> Tuple[np.ndarray, np.ndarray]:
    return (np.concatenate([i for i, _ in logged]),
            np.concatenate([e for _, e in logged]).astype(bool))


def query_fingerprints_from_log(table: Table, logged) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query side of one family from the lookup log's entries
    ``[(row index, enabled), ...]``: the fingerprints of the table's rows at
    the logged indexes (the rows the constraints consumed) and the enable
    bits, on the table's device."""
    idx, en = _concat_log(logged)
    idx_t = torch.from_numpy(idx.astype(np.int32))
    return fingerprint_parts(table_parts(table), idx_t), torch.from_numpy(en)


def logup_sums(query_fps: torch.Tensor, query_en: torch.Tensor,
               parts: List[Tuple[int, torch.Tensor]], multiplicities: torch.Tensor,
               alpha: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides of the logUp identity, canonical ``[1, 16]`` limbs each:
    the JAX ``sharded_logup_check`` body (logup_shard.py:108-155) at world
    size 1.  The inputs move to ``device`` (no copy where they are there)."""
    dev = require_device(device, "logup_sums")
    # every query fingerprint that is 0 becomes 1 (the JAX package forces
    # its padded lanes nonzero so, and catches real zero fingerprints with
    # them); the table side keeps its zeros: the rule is asymmetric
    q_fps = query_fps.to(dev).clone()
    q_fps[:, 0] += (q_fps == 0).all(dim=1).to(L.DTYPE)
    en = query_en.to(dev).to(L.DTYPE)[:, None]
    alpha_l = L.int_to_limbs(alpha % fr.P, fr.NL).to(dev)
    t_fps = fingerprint_parts([(w, c.to(dev)) for w, c in parts])
    lhs = logup_partial_sum(q_fps, alpha_l, en)
    rhs = logup_partial_sum(t_fps, alpha_l, multiplicities.to(dev))
    # the JAX package sums the raw limbs over the ranks, then normalises
    # (carry_propagate to 17 limbs) and reduces (reduce_wide): both sides in
    # one launch of K2's normalise-and-reduce entry
    both = fr.normalize_reduce(torch.stack([lhs, rhs]), 17)
    return both[:1], both[1:]


def sharded_logup_check(query_fps: torch.Tensor, query_en: torch.Tensor,
                        parts: List[Tuple[int, torch.Tensor]], multiplicities: torch.Tensor,
                        alpha: int, device="cuda") -> bool:
    """The logUp identity of one family on ``device`` ("cuda" unless the
    caller asks for "cpu"; there is no fallback): ``query_fps [Q, 16]``,
    ``query_en [Q]`` bool, the table's column ``parts`` and its
    ``multiplicities [T, <=16]``.  One bool is read back."""
    lhs, rhs = logup_sums(query_fps, query_en, parts, multiplicities, alpha, device)
    return bool(L.eq(lhs, rhs).item())


def block_lookup_log(witness):
    """Run the EVM circuit eagerly once on the host and collect, per table,
    the lookup log ``[(row index, enabled), ...]``; returns (tables, log).
    ``CompiledBlockVerifier.lookup_log`` is the same log, taken by its
    partition pass."""
    from ..circuits.bytecode import assign_keccak_table
    from ..circuits.ecc import ecc_table_rows
    from ..config import DEFAULT_CONFIG
    from ..evm.main import verify_steps
    from ..tables.container import Tables
    from ..witness.typing import copy_circuit_to_table, exp_circuit_to_table

    codes = [bytes(bc.code) for bc in witness.bytecodes]
    kwargs = witness.tables_kwargs()
    kwargs["keccak_table"] = assign_keccak_table(codes + list(witness.sha3_preimages),
                                                 DEFAULT_CONFIG.keccak_randomness)
    if witness.copy_circuit is not None:
        kwargs["copy_table"] = copy_circuit_to_table(witness.copy_circuit)
    if witness.exp_circuit is not None:
        kwargs["exp_table"] = exp_circuit_to_table(witness.exp_circuit)
    if witness.ecc_circuit is not None:
        kwargs["ecc_table"] = ecc_table_rows(witness.ecc_circuit,
                                             DEFAULT_CONFIG.keccak_randomness)
    if witness.sig_rows:
        # the traced ecRecover calls look the sig table up
        kwargs["sig_table"] = [r.table_row() for r in witness.sig_rows]
    tables = Tables(**kwargs)
    log: List[tuple] = []
    verify_steps(tables, list(witness.steps), end_with_last_step=True, lookup_log=log)
    per_table: Dict[str, List[tuple]] = {}
    for name, idx, en in log:
        per_table.setdefault(name, []).append((idx, en))
    return tables, per_table


def family_inputs(table: Table, logged, device, parts=None) -> dict:
    """One family's inputs of the check on ``device``: the multiplicities
    counted on the host from the log (``counts``, numpy; ``host_s``: the
    log's concatenation and the count), the table's parts (``parts`` as
    given, e.g. the columns a block verifier already uploaded, else uploaded
    here) and the query side fingerprinted from them at the logged indexes
    (before anything can tamper with a copy of the parts)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    idx, en = _concat_log(logged)
    counts = np.bincount(idx[en], minlength=table.n_rows)
    host_s = time.perf_counter() - t0
    if parts is None:
        parts = [(w, t.to(dev)) for w, t in table_parts(table)]
    query_fps = fingerprint_parts(parts, torch.from_numpy(idx.astype(np.int32)).to(dev))
    return {"n_rows": table.n_rows, "n_queries": int(idx.shape[0]), "idx": idx, "counts": counts,
            "host_s": host_s, "parts": parts, "query_fps": query_fps,
            "query_en": torch.from_numpy(en).to(dev), "multiplicities": multiplicities(counts, dev)}


def multiplicities(counts: np.ndarray, device) -> torch.Tensor:
    """Per-row counts as Fr limbs (``F.from_ints(..., 64)``: ``[T, 4]``, the
    JAX ``[T, 16]`` without its zero limbs)."""
    return F.from_ints(Ctx("cpu", len(counts)), counts, 64).limbs.to(device)


def block_logup_sums(tables, per_table, tables_names: Tuple[str, ...], device,
                     corrupt_table: Optional[Callable] = None,
                     parts_of: Optional[Callable] = None) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """``{table: (lhs, rhs)}`` of every family of ``tables_names`` in the
    per-table lookup log, each side ``[1, 16]`` canonical limbs on
    ``device`` (see ``verify_block_lookups_logup`` for ``corrupt_table``
    and ``parts_of``)."""
    out = {}
    for name in tables_names:
        if name not in per_table:
            continue
        inp = family_inputs(getattr(tables, name), per_table[name], device,
                            parts_of(name) if parts_of is not None else None)
        parts = inp["parts"]
        if corrupt_table is not None:
            parts = [(w, t.clone()) for w, t in parts]
            corrupt_table(name, parts)
        out[name] = logup_sums(inp["query_fps"], inp["query_en"], parts,
                               inp["multiplicities"], ALPHA, device)
    return out


def verify_block_lookups_logup(witness, tables_names: Tuple[str, ...] = ("rw",),
                               corrupt_table: Optional[Callable] = None, device="cuda",
                               log=None, parts_of: Optional[Callable] = None) -> Dict[str, bool]:
    """The lookup argument of a block witness on ``device`` ("cuda" unless
    the caller asks for "cpu"; there is no fallback): ``{table: ok}`` for
    every family of ``tables_names`` that the block looks up.

    ``log``: (tables, per-table log) of an eager pass already made (a
    ``CompiledBlockVerifier``'s); else ``block_lookup_log`` runs one.
    ``parts_of(name)``: the table's parts already on the device, or None.
    ``corrupt_table(name, parts)`` may tamper in place with a copy of the
    table side's parts (tests of the binding); the query side is
    fingerprinted before it runs."""
    dev = require_device(device, "verify_block_lookups_logup")
    tables, per_table = log if log is not None else block_lookup_log(witness)
    sums = block_logup_sums(tables, per_table, tables_names, dev, corrupt_table, parts_of)
    return {name: bool(L.eq(lhs, rhs).item()) for name, (lhs, rhs) in sums.items()}
