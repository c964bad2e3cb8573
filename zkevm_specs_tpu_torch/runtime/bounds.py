"""The least time the card could take for a kernel's work: the card's
peaks and the cost models of K1 (``fr_mul``), K2 (``limb_mul`` and its
normalise-and-reduce entry ``limb_reduce``), K5 (``state_order_lt``), K6
(``lookup_search_eq`` and its fingerprint entry), K7 (``keccak_sponge``)
and K11 (``mul_add_words``).

``chip_smoke.py`` and ``profile_replay.py`` (its ``--keccak``,
``--frmul``, ``--search``, ``--wordmul`` and ``--narrow`` modes) read
their bounds from here, so both state the same model.  A bound is the
larger of the bytes a call must move over the memory rate and the int32
operations it must issue over the card's integer rate; K2's second
entry's, K7's and K11's also take their chain, the dependent steps of one
row or lane at ``DEP_LATENCY_CYCLES`` each.
"""
import subprocess

import torch

from ..ops import keccak as keccak_ops
from ..tables import engine

# H100 SXM peaks used for the bounds: HBM3 3.35 TB/s (data sheet); int32
# ALU issue 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 1.673e13 op/s
# (Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the dependent-issue latency taken for the card's fixed-latency integer
# instructions (IMAD, IADD3, LOP3, SHF): an assumption, not measured here
DEP_LATENCY_CYCLES = 4


def sm_clock_max_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def bound(bytes_moved, int_ops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_bound(bound_ms, bound_by, chain_ms):
    """(bound_ms, bound_by, bound_kind): a ``bound`` with a chain term, the
    dependent steps of one row or lane.  ``bound_ms`` is the larger;
    ``bound_by`` names a chain "operations" (it is dependent ones), and
    ``bound_kind`` says which of bytes, operations and chain sets it."""
    if chain_ms > bound_ms:
        return chain_ms, "operations", "chain"
    return bound_ms, bound_by, bound_by


# The least work of one BN254-Fr product on the card's 32-bit integer
# units, independent of any kernel: an 8 x 32-bit-limb Montgomery product.
# a * b takes 64 limb products, each a mad.lo and a mad.hi (128
# instructions), and two carry words a row (16); the reduction takes the 64
# products m_i * p_j (128), the 8 words m_i = t_i * (-p^-1) mod 2^32 (one
# mul.lo each) and two carry words a row (16); p is subtracted at most once
# (8 subtractions, 8 selects): 312 instructions.
FR_REDC_OPS = 2 * 64 + 8 + 2 * 8
FR_FINAL_OPS = 2 * 8


def fr_product_ops(wa=8, wb=8):
    """int32 instructions of a field product of a wa-word by a wb-word
    operand (32-bit words, 8 for a full element): the limb products' low
    and high words and two carry words a row of a * b, the reduction and
    the final subtraction."""
    return 2 * wa * wb + 2 * wb + FR_REDC_OPS + FR_FINAL_OPS


def fr_mul_cost(a_shape, b_shape):
    """(bytes, int32 operations) of K1 on a ``[Ba, na]`` and a ``[Bb, nb]``
    operand of int64 limbs: both read once, ``[max(Ba, Bb), 16]`` written,
    and a field product (``fr_product_ops``) of the operands' 32-bit words
    a lane."""
    (ba, na), (bb, nb) = a_shape, b_shape
    rows = max(ba, bb)
    return 8 * (ba * na + bb * nb) + rows * 16 * 8, rows * fr_product_ops(-(-na // 2), -(-nb // 2))


# K7: the 32-bit instructions one keccak-f round issues, with the card's
# three-input logic op (LOP3) and a 64-bit rotate as two funnel shifts (SHF;
# no rotation of the permutation is by 32, which would be a free swap):
# theta's column parities 5 x 2 halves x 2 LOP3, its five D lanes 2 SHF +
# 2 LOP3 each, D into the 25 lanes 50 LOP3; rho 24 rotates x 2 SHF; chi
# 25 lanes x 2 halves x 1 LOP3 (a ^ (~b & c)); iota 2.  A block adds the
# 17-lane absorb.
K7_OPS_PER_ROUND = 5 * 2 * 2 + 5 * (2 + 2) + 25 * 2 + 24 * 2 + 25 * 2 + 2
K7_OPS_PER_BLOCK = 24 * K7_OPS_PER_ROUND + 2 * 17


def keccak_round_chain():
    """The least depth of one keccak-f round in the card's 32-bit
    instructions (the two halves of a lane side by side), each issued one
    step after its last operand, every lane ready at step 0.  Rotation
    distributes over XOR, so rho folds into theta: lane i = x + 5y, of
    rotation r, leaves theta and rho as rot(A, r) ^ rot(C[x-1], r) ^
    rot(C[x+1], r + 1):
    - the column parities C[x], two three-input LOP3s (steps 1-2);
    - rot(A, r), one funnel shift (SHF) a half (step 1); rot(C[x-1], r)
      and rot(C[x+1], r + 1), one each (step 3; none where r is 0);
    - the three terms XORed, one LOP3 (step 4);
    - pi, a renaming of lanes, no instruction;
    - chi, B ^ (~B[x+1] & B[x+2]), one LOP3 (step 5);
    - iota: lane 0 (r = 0) forms C[4] ^ RC beside the shifts of step 3 and
      its own B ^ RC at step 4 (B itself still feeds chi of lanes 3 and 4).
    Returns the depth (5)."""
    rot = {x + 5 * y: keccak_ops._ROT[x][y] for x in range(5) for y in range(5)}
    c = [2] * 5
    b = []
    for i in range(25):
        x, r = i % 5, rot[i]
        shift = 1 if r else 0
        b.append(max(shift, c[(x + 4) % 5] + shift, c[(x + 1) % 5] + 1) + 1)
    b0_rc = max(0, c[4] + 1, c[1] + 1) + 1                 # A ^ (C[4] ^ RC) ^ rot(C[1], 1)
    b = [b[s] for s in keccak_ops._PI_SRC]                   # b[d] = rho(a)[source of d]
    out = [max(b0_rc if i == 0 else b[i], b[i - i % 5 + (i + 1) % 5],
               b[i - i % 5 + (i + 2) % 5]) + 1 for i in range(25)]
    return max(out)


K7_ROUND_CHAIN = keccak_round_chain()


def sponge_cost(absorbed, rows):
    """(bytes, int32 operations) of K7 for ``absorbed`` blocks over
    ``rows`` rows: the blocks read once (34 int64 words each), each row's
    block count and its digest (8 int64 words)."""
    return absorbed * 34 * 8 + rows * 4 + rows * 8 * 8, absorbed * K7_OPS_PER_BLOCK


def sponge_chain_ms(longest, clock_hz):
    """K7's chain bound: the longest row's blocks x 24 rounds x
    K7_ROUND_CHAIN dependent instructions at DEP_LATENCY_CYCLES each."""
    return longest * 24 * K7_ROUND_CHAIN * DEP_LATENCY_CYCLES / clock_hz * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# K6: the fingerprint entry and the search, for this run's data

def fingerprint_cost(shapes):
    """(bytes, int32 operations) of K6's fingerprint entry on parts of
    ``[T, w]`` shapes: every limb read once, one u64 fingerprint written, a
    64-bit multiply-add (eight int32 instructions) per limb."""
    T = shapes[0][0]
    limbs = sum(w for _, w in shapes)
    return T * limbs * 8 + T * 8, T * limbs * 8


def search_cost(args):
    """(bytes, int32 operations, candidates scanned) of one K6 search, for
    this run's data: the query read once, the binary search's keys (at most
    every key once), then the candidates that share the query's
    fingerprint (at most ``max_span`` a lane), each slot's key, row index
    and row gathered and compared once, and the four outputs; a
    multiply-add a query limb, three operations a search step, two a
    compared limb."""
    query, table, coefs, fps, order, max_span, batch = args
    T = fps.shape[0]
    qfp = engine.fingerprint_plain(query, coefs).expand(batch).contiguous()
    keys, qkeys = fps ^ engine._SIGN, qfp ^ engine._SIGN
    left = torch.searchsorted(keys, qkeys, side="left")
    right = torch.searchsorted(keys, qkeys, side="right")
    scanned = int((right - left).clamp(max=max_span).sum())
    row_bytes = sum(8 * t.shape[1] for t in table)
    steps = max(1, (T - 1).bit_length())
    moved = (sum(nbytes(q) for q in query) + min(T, batch * steps) * 8
             + scanned * (8 + row_bytes) + batch * (4 + 3))
    ops = batch * (8 * sum(q.shape[1] for q in query) + 3 * steps) + scanned * 2 * (row_bytes // 8)
    return moved, ops, scanned


# K11: the least work of one lane on 32-bit words, independent of the
# kernel.  The seven t_k take the 64 limb products of two 256-bit words (a
# mad.lo and a mad.hi each) and two carry words for each of the 16 64-bit
# pair products; L_h = t_2h + t_2h+1 * 2^64 overlaps in three words and
# carries two; an Fr add or subtract is an 8-word carry chain, p taken off
# or put back, and a select or a mask a word; a product by 2^-128 is a
# field product by a one-word operand (2^-128 in Montgomery form is 2^128,
# one nonzero word: fr_product_ops(8, 1)); the 256 variant's t4 + t5 + t6
# two five-word adds; a range check below 2^72 one compare and five zero
# tests, the 512 variant's t6 + carry_2 == d_hi eight compares.  The
# equalities' product by 2^128 and its Fr add are not counted: in the field
# they hold for every canonical input, so the least work writes them true.
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
# One lane's least dependent steps (each issued a step after its last
# operand): a t_k a product and a five-word carry chain (6); L_h its
# overlap's chain (5); an Fr add its chain, the borrow of s - p one step
# behind and the select (10); an Fr subtract likewise: d = x - y, d + p one
# step behind and the select on the borrow (10); a product by 2^-128 the
# product (1), the four rounds of its reduction whose word is nonzero
# (three each: m, its low product, the carry into the next word), then the
# high half added with p taken off once, one Fr add (10).  The 256 variant
# runs t, L0, + c_lo, - d_lo, * 2^-128, + carry_lo (L1 + c_hi formed
# beside it), - d_hi, * 2^-128, + (t4 + t5 + t6): 107 steps; the 512
# variant the same up to carry_hi, then + L2, - d_lo, * 2^-128, + t6: 150.
CHAIN_T, CHAIN_PAIR, CHAIN_ADD, CHAIN_SUB = 6, 5, 8 + 1 + 1, 8 + 1 + 1
CHAIN_INV128 = 1 + 4 * 3 + CHAIN_ADD
_HALF = CHAIN_ADD + CHAIN_SUB + CHAIN_INV128
WORD_MUL_CHAIN = {False: CHAIN_T + CHAIN_PAIR + 2 * _HALF + CHAIN_ADD,
                  True: CHAIN_T + CHAIN_PAIR + 3 * _HALF + CHAIN_ADD}


def word_mul_cost(shapes, wide):
    """(bytes, int32 operations) of K11 on limb rows of ``[B|1, w]``
    shapes: every row read once (a, b only in the eight limbs of their
    quarters; a [1, w] constant row once in all), the verdict bytes and the
    256 variant's 16 overflow limbs written once, and
    ``WORD_MUL_LANE_OPS`` a lane."""
    batch = max(n for n, _ in shapes)
    moved = sum(n * min(w, 8 if k < 4 else 16) * 8 for k, (n, w) in enumerate(shapes))
    moved += batch * (7 if wide else 4) + (0 if wide else batch * 16 * 8)
    return moved, batch * WORD_MUL_LANE_OPS[bool(wide)]


def word_mul_chain_ms(wide, clock_hz):
    """K11's chain bound: one lane's WORD_MUL_CHAIN dependent steps at
    DEP_LATENCY_CYCLES each and the card's top clock."""
    return WORD_MUL_CHAIN[bool(wide)] * DEP_LATENCY_CYCLES / clock_hz * 1e3


# K2's product: both operands read once (a [1, n] row once), out_n limbs a
# lane written, and a lane's na x nb limb products (a multiply and an add
# each) and out_n carry steps (add, mask, shift)
def limb_mul_cost(a_shape, b_shape, out_n):
    """(bytes, int32 operations) of K2's product on a ``[Ba, na]`` and a
    ``[Bb, nb]`` operand of int64 limbs."""
    (ba, na), (bb, nb) = a_shape, b_shape
    rows = max(ba, bb)
    return 8 * (ba * na + bb * nb) + rows * out_n * 8, rows * (2 * na * nb + 3 * out_n)


# K2's normalise-and-reduce entry (``limb_reduce``), one row's least depth,
# each step issued one step after its last operand, for columns below 2^32
# (the JAX carry_propagate's max_entry_bits).  The ripple on 32-bit words:
# the even columns are words as they stand, the odd ones a funnel shift
# across two words (1 step), then one carry chain over the ceil(keep / 2)
# words of x' and a mask of the top word when keep is odd.  The reduction
# of x' = lo + hi * 2^256 (hi h words): hi * 2^256 mod p a Montgomery
# product by R^2 mod p, the limb products (1), one carry chain merging the
# 8 + h columns, eight reduction rounds of three (m, its low product, the
# carry into the next word) and the high half added with p taken off once
# (an Fr add, CHAIN_ADD); lo below p beside it, three subtractions of 4p,
# 2p, p, each an 8-word chain and a select (27); then one Fr add.
CHAIN_REDUCE_ROUND = 3
CHAIN_LO_BELOW_P = 3 * (8 + 1)


def reduce_chain(keep, reduce):
    """One row's dependent steps in K2's normalise-and-reduce entry."""
    words = -(-keep // 2)
    ripple = 1 + words + keep % 2
    if not reduce:
        return ripple
    h = max(0, words - 8)
    if h == 0:
        return ripple + CHAIN_LO_BELOW_P
    product = 1 + (8 + h) + 8 * CHAIN_REDUCE_ROUND + CHAIN_ADD
    return ripple + max(product, CHAIN_LO_BELOW_P) + CHAIN_ADD


def reduce_chain_ms(keep, reduce, clock_hz):
    """The chain bound of K2's normalise-and-reduce entry at the card's
    top clock."""
    return reduce_chain(keep, reduce) * DEP_LATENCY_CYCLES / clock_hz * 1e3


def reduce_cost(rows, m, keep, reduce):
    """(bytes, int32 operations) of K2's normalise-and-reduce entry on
    ``[rows, m]`` columns: every column read once, the ``keep`` limbs (or,
    reduced, 16) a row written; a row's ripple (three a limb) and, reduced,
    the product of hi by R^2 mod p, the three subtractions with selects and
    one Fr add."""
    moved = rows * min(m, keep) * 8 + rows * (16 if reduce else keep) * 8
    ops = 3 * keep
    if reduce:
        h = max(0, -(-keep // 2) - 8)
        ops += (fr_product_ops(h, 8) if h else 0) + 3 * (8 + 8) + FR_ADD_OPS
    return moved, rows * ops


# K5: a row reads the limbs of its key (tag 1, id 2, address 10, field_tag
# 1, storage key 8 + 8, rw_counter 2) and writes one flag; the least work
# builds each row's key once (the 17-limb add of three a limb, the packing
# of tag and id, the 19 limbs) and compares it with the previous row's
ORDER_KEY_LIMBS = 1 + 2 + 10 + 1 + 8 + 8 + 2
ORDER_ROW_OPS = 3 * 17 + 4 + 19 + 2 * 19


def order_cost(n):
    """(bytes, int32 operations) of K5 at ``n`` rows."""
    return n * ORDER_KEY_LIMBS * 8 + n, n * ORDER_ROW_OPS
