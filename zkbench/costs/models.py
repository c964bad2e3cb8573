"""The least time the card could take for the work of each hand-written
kernel call of a verification: the card's peaks and the kernels' cost
models.

A frozen copy, so that a later change to the port cannot move the
yardstick: from ``zkevm_specs_tpu_torch/runtime/bounds.py`` (the peaks
:21-25, ``bound`` :37-41, ``chain_bound`` :44-52, ``fr_product_ops``
:66-72, ``fr_mul_cost`` :75-82, K7's counts and chain :92-134,
``sponge_cost`` / ``sponge_chain_ms`` :137-148, ``fingerprint_cost`` and
``search_cost`` :156-193, K11 :196-243, ``limb_mul_cost`` :246-254, K2's
entry :257-301, K5 :304-309) and from ``chip_smoke.py`` (``addsub_cost``
:2627-2636, ``gather_cost`` and ``hinted_rows`` :2639-2656,
``sponge_cost_of`` / ``horner_cost`` and K8's counts :2824-2825,
:2943-2957); ``hint_rows`` and ``fingerprint_plain`` from
``zkevm_specs_tpu_torch/tables/engine.py`` :68-73 and :199-208.  K9's
bound is its bytes: the staged leaves read once and the unpacked arena
written once (PERF.md's table, row B11).

A bound is the larger of the bytes a call must move over the memory rate
and the int32 operations it must issue over the integer rate; K2's
normalise-and-reduce entry, K7 and K11 also take their chain, the
dependent steps of one row or lane at ``DEP_LATENCY_CYCLES`` each at the
card's top clock.  Each input byte counts once, each output byte once."""
from __future__ import annotations

import torch

# H100 SXM peaks: HBM3 3.35 TB/s (data sheet); int32 issue 132 SMs x 64
# INT32 lanes x 1.98 GHz boost (Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# an assumption, not measured: the dependent-issue latency of IMAD, IADD3,
# LOP3 and SHF
DEP_LATENCY_CYCLES = 4

# limb_addsub modes (zkevm_specs_tpu_torch/ops/limbs.py:330)
ADD, SUB, FR_ADD, FR_SUB = 0, 1, 2, 3
_SIGN = -(1 << 63)


def bound_ms(bytes_moved, int_ops, chain_ms=0.0) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S * 1e3, int_ops / INT32_OPS_PER_S * 1e3, chain_ms)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


FR_REDC_OPS = 2 * 64 + 8 + 2 * 8
FR_FINAL_OPS = 2 * 8


def fr_product_ops(wa=8, wb=8):
    return 2 * wa * wb + 2 * wb + FR_REDC_OPS + FR_FINAL_OPS


def fr_mul_cost(a_shape, b_shape):
    (ba, na), (bb, nb) = a_shape, b_shape
    rows = max(ba, bb)
    return 8 * (ba * na + bb * nb) + rows * 16 * 8, rows * fr_product_ops(-(-na // 2), -(-nb // 2))


# K7
K7_OPS_PER_ROUND = 5 * 2 * 2 + 5 * (2 + 2) + 25 * 2 + 24 * 2 + 25 * 2 + 2
K7_OPS_PER_BLOCK = 24 * K7_OPS_PER_ROUND + 2 * 17
K7_ROUND_CHAIN = 5          # bounds.keccak_round_chain() of the Keccak rotations


def sponge_cost(absorbed, rows):
    return absorbed * 34 * 8 + rows * 4 + rows * 8 * 8, absorbed * K7_OPS_PER_BLOCK


def sponge_chain_ms(longest, clock_hz):
    return longest * 24 * K7_ROUND_CHAIN * DEP_LATENCY_CYCLES / clock_hz * 1e3


# K6
def fingerprint_plain(parts, coefs):
    acc = None
    for p, limbs in enumerate(parts):
        for k in range(limbs.shape[-1]):
            term = limbs[:, k] * coefs[p, k]
            acc = term if acc is None else acc + term
    return acc


def fingerprint_cost(shapes):
    T = shapes[0][0]
    limbs = sum(w for _, w in shapes)
    return T * limbs * 8 + T * 8, T * limbs * 8


def search_cost(args):
    query, table, coefs, fps, _order, max_span, batch = args
    T = fps.shape[0]
    qfp = fingerprint_plain(query, coefs).expand(batch).contiguous()
    keys, qkeys = fps ^ _SIGN, qfp ^ _SIGN
    left = torch.searchsorted(keys, qkeys, side="left")
    right = torch.searchsorted(keys, qkeys, side="right")
    scanned = int((right - left).clamp(max=max_span).sum())
    row_bytes = sum(8 * t.shape[1] for t in table)
    steps = max(1, (T - 1).bit_length())
    moved = (sum(nbytes(q) for q in query) + min(T, batch * steps) * 8
             + scanned * (8 + row_bytes) + batch * (4 + 3))
    ops = batch * (8 * sum(q.shape[1] for q in query) + 3 * steps) + scanned * 2 * (row_bytes // 8)
    return moved, ops


# K11
WORD_PRODUCT_OPS = 2 * 64 + 2 * 16
PAIR_SUM_OPS = 3 + 2
FR_ADD_OPS = FR_SUB_OPS = 3 * 8
INV128_OPS = fr_product_ops(8, 1)
BELOW_2_72_OPS = 1 + 5
WORD_MUL_LANE_OPS = {
    False: (WORD_PRODUCT_OPS + 2 * PAIR_SUM_OPS + 4 * FR_ADD_OPS + 2 * FR_SUB_OPS
            + 2 * INV128_OPS + 2 * 5 + 2 * BELOW_2_72_OPS),
    True: (WORD_PRODUCT_OPS + 3 * PAIR_SUM_OPS + 5 * FR_ADD_OPS + 3 * FR_SUB_OPS
           + 3 * INV128_OPS + 3 * BELOW_2_72_OPS + 8),
}
CHAIN_T, CHAIN_PAIR, CHAIN_ADD, CHAIN_SUB = 6, 5, 8 + 1 + 1, 8 + 1 + 1
CHAIN_INV128 = 1 + 4 * 3 + CHAIN_ADD
_HALF = CHAIN_ADD + CHAIN_SUB + CHAIN_INV128
WORD_MUL_CHAIN = {False: CHAIN_T + CHAIN_PAIR + 2 * _HALF + CHAIN_ADD,
                  True: CHAIN_T + CHAIN_PAIR + 3 * _HALF + CHAIN_ADD}


def word_mul_cost(shapes, wide):
    batch = max(n for n, _ in shapes)
    moved = sum(n * min(w, 8 if k < 4 else 16) * 8 for k, (n, w) in enumerate(shapes))
    moved += batch * (7 if wide else 4) + (0 if wide else batch * 16 * 8)
    return moved, batch * WORD_MUL_LANE_OPS[bool(wide)]


def chain_ms(steps, clock_hz):
    return steps * DEP_LATENCY_CYCLES / clock_hz * 1e3


# K2
def limb_mul_cost(a_shape, b_shape, out_n):
    (ba, na), (bb, nb) = a_shape, b_shape
    rows = max(ba, bb)
    return 8 * (ba * na + bb * nb) + rows * out_n * 8, rows * (2 * na * nb + 3 * out_n)


CHAIN_REDUCE_ROUND = 3
CHAIN_LO_BELOW_P = 3 * (8 + 1)


def reduce_chain(keep, reduce):
    words = -(-keep // 2)
    ripple = 1 + words + keep % 2
    if not reduce:
        return ripple
    h = max(0, words - 8)
    if h == 0:
        return ripple + CHAIN_LO_BELOW_P
    product = 1 + (8 + h) + 8 * CHAIN_REDUCE_ROUND + CHAIN_ADD
    return ripple + max(product, CHAIN_LO_BELOW_P) + CHAIN_ADD


def reduce_cost(rows, m, keep, reduce):
    moved = rows * min(m, keep) * 8 + rows * (16 if reduce else keep) * 8
    ops = 3 * keep
    if reduce:
        h = max(0, -(-keep // 2) - 8)
        ops += (fr_product_ops(h, 8) if h else 0) + 3 * (8 + 8) + FR_ADD_OPS
    return moved, rows * ops


# K5
ORDER_KEY_LIMBS = 1 + 2 + 10 + 1 + 8 + 8 + 2
ORDER_ROW_OPS = 3 * 17 + 4 + 19 + 2 * 19


def order_cost(n):
    return n * ORDER_KEY_LIMBS * 8 + n, n * ORDER_ROW_OPS


# K3
def addsub_cost(a, b, mode, out_n=0):
    rows = max(a.shape[0], b.shape[0])
    n = max(a.shape[1], b.shape[1])
    out_limbs = {SUB: n, FR_ADD: 16, FR_SUB: 16}.get(mode, out_n)
    moved = nbytes(a, b) + rows * out_limbs * 8 + (rows * 8 if mode == SUB else 0)
    per_row = 3 * max(n, out_limbs) if mode in (ADD, SUB) else 3 * 17 + 3 * 17 + 16
    return moved, rows * per_row


# K4
def hint_rows(idx, n_rows):
    row = idx.long()
    return torch.where(row < 0, row + n_rows, row).clamp(0, n_rows - 1)


def gather_cost(table, query, idx, enabled=None):
    B = idx.shape[0]
    row_bytes = 8 * sum(t.shape[1] for t in table)
    pairs = [(t, q) for t, q in zip(table, query) if q is not None]
    touched = int(torch.unique(hint_rows(idx, table[0].shape[0])).numel())
    moved = (nbytes(idx) + sum(nbytes(q) for _, q in pairs) + touched * row_bytes
             + B * row_bytes + (B if pairs else 0)
             + (nbytes(enabled) if enabled is not None else 0))
    return moved, 2 * B * sum(max(t.shape[1], q.shape[1]) for t, q in pairs)


# K8
K8_OPS_PER_STEP = 2 * 8 + 2
K8_OPS_PER_ROW = 2 * 8 * 8 + 8


def horner_cost(byte_cols, active_cols):
    T, n = byte_cols.shape
    counts = active_cols.sum(dim=0)
    steps, longest = int(counts.sum()), int(counts.max()) if n else 0
    return (2 * T * n + n * 16 * 8 + longest * 32,
            steps * K8_OPS_PER_STEP + n * K8_OPS_PER_ROW)


def call_bound_ms(kernel: str, args, kwargs, clock_hz: float) -> float:
    """The bound of one wrapper call of ``kernel`` at its arguments."""
    if kernel == "fr_mul":
        return bound_ms(*fr_mul_cost(args[0].shape, args[1].shape))
    if kernel == "limb_mul":
        a, b, out_n = args
        return bound_ms(*limb_mul_cost(a.shape, b.shape, out_n))
    if kernel == "limb_reduce":
        x, keep, reduce = args
        return bound_ms(*reduce_cost(x.shape[0], x.shape[1], keep, reduce),
                        chain_ms(reduce_chain(keep, reduce), clock_hz))
    if kernel == "limb_addsub":
        out_n = args[3] if len(args) > 3 else kwargs.get("out_n", 0)
        return bound_ms(*addsub_cost(args[0], args[1], args[2], out_n))
    if kernel == "lookup_gather_eq":
        enabled = args[3] if len(args) > 3 else kwargs.get("enabled")
        return bound_ms(*gather_cost(args[0], args[1], args[2], enabled))
    if kernel == "state_order_lt":
        return bound_ms(*order_cost(args[0].shape[0]))
    if kernel == "lookup_search_eq":
        return bound_ms(*search_cost(args))
    if kernel == "lookup_fingerprint":
        return bound_ms(*fingerprint_cost([t.shape for t in args[0]]))
    if kernel == "keccak_sponge":
        blocks, n_blocks = args
        counts = n_blocks.clamp(0, blocks.shape[1])
        return bound_ms(*sponge_cost(int(counts.sum()), blocks.shape[0]),
                        sponge_chain_ms(int(counts.max()) if counts.numel() else 0, clock_hz))
    if kernel == "horner_rlc":
        return bound_ms(*horner_cost(args[0], args[1]))
    if kernel == "mul_add_words":
        rows = args[0]
        wide = bool(args[1]) if len(args) > 1 else bool(kwargs.get("wide", False))
        return bound_ms(*word_mul_cost([r.shape for r in rows], wide),
                        chain_ms(WORD_MUL_CHAIN[wide], clock_hz))
    raise KeyError(kernel)


def unpack_bound_ms(upload_stats: dict) -> float:
    """K9: the staged leaves read once, the arena written once."""
    return bound_ms(upload_stats["narrow_bytes"] + upload_stats["arena_bytes"], 0)
