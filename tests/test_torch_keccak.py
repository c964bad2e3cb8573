"""The port's keccak circuit (zkevm_specs_tpu_torch.circuits.keccak) and its
two kernels' plain versions against the JAX package's, tolerance 0: limbs
and digest words equal, fail bits equal lane for lane.

* K7's plain version (``ops.keccak``: ``keccak_f_lanes``,
  ``keccak256_batch_fixed_blocks``, ``keccak_sponge``) against the JAX lane
  functions under numpy on random states, and against ``keccak256`` on the
  pad-boundary lengths;
* K8's plain version (``circuits.keccak.horner_rlc``) against the JAX
  ``_horner_rlc`` under numpy;
* K8's chunked schedule: its plain twin ``horner_rlc_chunked_plain``
  against the JAX ``_horner_rlc`` and the Python-int Horner at chunk
  lengths around T and on non-prefix masks; ``horner_schedule``'s cover of
  every step at the paths' shapes; and the kernels' indexing (stages, the
  block's tree, the combine kernel's folds) replayed on Python ints;
* the circuit through the port's ``verify_keccak_circuit`` (spec mode) and
  ``keccak_kernel(..., device="cpu")()`` against the JAX spec run and the
  JAX ``keccak_kernel(...)()`` jitted on the CPU, on every vector of
  tests/test_keccak_circuit.py and on the builders at a small size;
* ``runtime.convert.to_device`` keeps each extra array's type.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import keccak as jk
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JConstraintSystem
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.ops import fr as jfr
from zkevm_specs_tpu.ops import keccak as jops
from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu.witness.typing import KeccakCircuit as JKeccakCircuit
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import bytecode as pbc
from zkevm_specs_tpu_torch.circuits import keccak as pk
from zkevm_specs_tpu_torch.ops import keccak as pops
from zkevm_specs_tpu_torch.ops.fr import P
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.witness.typing import KeccakCircuit

torch.set_num_threads(1)

R = 987654321                      # tests/test_keccak_circuit.py's randomness
BLOCK_R = 0x64                     # CompiledBlockVerifier's default (config.py)
EDGE_LENGTHS = [0, 1, 135, 136, 137, 271, 272, 300]


def _keccak_rows(datas, r):
    kc, jkc = KeccakCircuit(), JKeccakCircuit()
    for d in datas:
        kc.add(d, r)
        jkc.add(d, r)
    assert kc.rows == jkc.rows
    return kc.rows


def _words(digest_bytes):
    return np.frombuffer(digest_bytes, dtype="<u4").astype(np.int64)


# -- to_device: the extra arrays keep their type --------------------------------

@pytest.mark.parametrize("dtype,want", [
    (np.bool_, torch.bool), (np.uint8, torch.uint8), (np.uint32, torch.int64),
    (np.int32, torch.int32), (np.int64, torch.int64), (np.uint64, torch.int64),
])
def test_to_device_keeps_each_type(dtype, want):
    rng = np.random.RandomState(3)
    if dtype is np.bool_:
        arr = rng.rand(5, 7) < 0.5
    else:
        hi = {np.uint8: 256, np.uint32: 1 << 32, np.int32: 1 << 31}.get(dtype, 1 << 62)
        arr = rng.randint(0, hi, size=(5, 7), dtype=np.int64).astype(dtype)
    if dtype is np.uint64:
        arr[0, 0] = np.uint64((1 << 64) - 1)           # the sign bit of the int64 view
    out = to_device({"a": arr}, "cpu")["a"]
    assert out.dtype == want and out.shape == arr.shape and out.is_contiguous()
    if dtype is np.uint64:
        np.testing.assert_array_equal(out.numpy().view(np.uint64), arr)
    else:
        np.testing.assert_array_equal(out.numpy(), arr)


# -- K7's plain version ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 25), (2, 3, 25)])
def test_keccak_f_lanes_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    lo = rng.randint(0, 1 << 32, size=shape, dtype=np.int64).astype(np.uint32)
    hi = rng.randint(0, 1 << 32, size=shape, dtype=np.int64).astype(np.uint32)
    lo[..., 0] = 0xFFFF_FFFF
    want_lo, want_hi = jops.keccak_f_lanes(np, lo, hi)
    got_lo, got_hi = pops.keccak_f_lanes(torch.from_numpy(lo.astype(np.int64)),
                                         torch.from_numpy(hi.astype(np.int64)))
    np.testing.assert_array_equal(got_lo.numpy(), want_lo.astype(np.int64))
    np.testing.assert_array_equal(got_hi.numpy(), want_hi.astype(np.int64))


def test_keccak256_batch_fixed_blocks_matches_jax():
    rng = np.random.RandomState(11)
    blocks = rng.randint(0, 1 << 32, size=(5, 3, 34), dtype=np.int64).astype(np.uint32)
    want = jops.keccak256_batch_fixed_blocks(np, blocks)
    got = pops.keccak256_batch_fixed_blocks(torch.from_numpy(blocks.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sponge_and_batch_hash_on_the_pad_boundaries():
    rng = np.random.RandomState(5)
    datas = [rng.bytes(n) for n in EDGE_LENGTHS]
    raw, lens, padded, n_blocks = pops.pad_blocks(datas)
    for i, d in enumerate(datas):                       # the pad equals the JAX _pad's
        assert padded[i, :n_blocks[i] * pops.RATE].tobytes() == jk._pad(d)
        assert not padded[i, n_blocks[i] * pops.RATE:].any()
        assert raw[i, :len(d)].tobytes() == d and not raw[i, len(d):].any()
    np.testing.assert_array_equal(n_blocks, [1, 1, 1, 2, 2, 2, 3, 3])
    blocks = torch.from_numpy(padded.view("<u4").astype(np.int64).reshape(len(datas), -1, 34))
    digest = pops.keccak_sponge(blocks, torch.from_numpy(n_blocks.astype(np.int32)))
    hashed = pops.keccak256_batch(datas)
    for i, d in enumerate(datas):
        want = pops.keccak256(d)
        assert want == jops.keccak256(d) == hashed[i]
        np.testing.assert_array_equal(digest[i].numpy(), _words(want))


def test_sponge_stops_each_row_at_its_own_block_count():
    """Rows of 1, 2 and 3 blocks in one batch: the sponge's digest of each
    is the one-row hash, and the JAX absorb loop's digest (all rows run
    through 3 blocks, masked) agrees."""
    rng = np.random.RandomState(8)
    datas = [rng.bytes(n) for n in (10, 200, 300, 135, 271, 0)]
    _, cols, extra = pk.build_keccak_inputs(datas, _keccak_rows(datas, R))
    ext = to_device(extra, "cpu")
    digest = pops.keccak_sponge(ext["blocks"], ext["n_blocks"])
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(digest[i].numpy(), _words(pops.keccak256(d)))
    word = pk._digest_to_word(cols["output"].lo.ctx, digest)
    jctx, jcols, jextra = jk.build_keccak_inputs(datas, _keccak_rows(datas, R))
    jdigest = np.stack([_words(jops.keccak256(d)) for d in datas]).astype(np.uint32)
    jword = jk._digest_to_word(jctx, jdigest)
    np.testing.assert_array_equal(word.lo.limbs.numpy(), jword.lo.limbs)
    np.testing.assert_array_equal(word.hi.limbs.numpy(), jword.hi.limbs)
    for k, v in jextra.items():
        assert v.dtype == extra[k].dtype
        np.testing.assert_array_equal(extra[k], v)


def test_sponge_wrapper_checks_its_inputs():
    blocks = torch.zeros((2, 1, 34), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        pops.keccak_sponge(blocks, torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        pops.keccak_sponge(blocks[:, :, :33], torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        pops.keccak_sponge(blocks.to("meta"), torch.ones(2, dtype=torch.int32).to("meta"))


# -- K7's warp kernel: one row a warp, walked on Python ints -------------------------

K7_SOURCE = (Path(pops.__file__).resolve().parents[1] / "csrc" / "keccak_sponge.cu").read_text()
M32 = 0xFFFF_FFFF
WARP = 32


def _c_array(source, name):
    """The integers of ``name[...] = {...}`` in a CUDA source."""
    m = re.search(re.escape(name) + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", source)
    assert m, f"{name} not found"
    return [int(t.strip().rstrip("ul").rstrip("ULL"), 0)
            for t in m.group(1).replace("\n", " ").split(",") if t.strip()]


WEST, EAST = _c_array(K7_SOURCE, "c_theta_west"), _c_array(K7_SOURCE, "c_theta_east")
RHO_ROT, PI_SRC = _c_array(K7_SOURCE, "c_rho_rot"), _c_array(K7_SOURCE, "c_pi_src")
CHI1, CHI2 = _c_array(K7_SOURCE, "c_chi_src1"), _c_array(K7_SOURCE, "c_chi_src2")
K7_RC = _c_array(K7_SOURCE, "c_rc")


COL_PITCH = int(re.search(r"#define KECCAK_COL_PITCH (\d+)", K7_SOURCE).group(1))
COL_WORDS = int(re.search(r"#define KECCAK_COL_WORDS (\d+)", K7_SOURCE).group(1))
M64 = (1 << 64) - 1


def _col_slot(t):
    """Where thread t stores its lane for theta: column-major at COL_PITCH
    lanes a column; threads 25-31 past the columns."""
    return COL_PITCH * (t % 5) + t // 5 if t < 25 else 5 * COL_PITCH + t - 25


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << (s & 31)."""
    return ((((hi << 32) | lo) << (s & 31)) >> 32) & M32


def _rho(x, r, swap):
    """The warp kernel's branchless rho by r mod 32 with swap = (r >= 32):
    the halves swapped, then one funnel shift a half."""
    lo, hi = x & M32, x >> 32
    a, c = (hi, lo) if swap else (lo, hi)
    return _fsl(c, a, r) | _fsl(a, c, r) << 32


def _warp_round(st, rc):
    """One round of keccak_sponge_warp_kernel on the 32 threads' 64-bit
    lanes, store by store and load by load through the two shared-memory
    buffers (a load reads what the warp stored before its __syncwarp)."""
    cols = [None] * COL_WORDS
    for t in range(WARP):                               # theta's exchange
        assert cols[_col_slot(t)] is None
        cols[_col_slot(t)] = st[t]
    new = []
    for t in range(WARP):
        west, east = COL_PITCH * WEST[t], COL_PITCH * EAST[t]
        cw = ce = 0
        for k in range(5):                              # 16 + 16 + 8 bytes a column
            assert west + k < 5 * COL_PITCH and east + k < 5 * COL_PITCH
            cw ^= cols[west + k]
            ce ^= cols[east + k]
        new.append(st[t] ^ cw ^ ((ce << 1 | ce >> 63) & M64))
    # pi + chi's exchange
    rho = [_rho(new[t], RHO_ROT[t] & 31, RHO_ROT[t] >= 32) for t in range(WARP)]
    return [rho[PI_SRC[t]] ^ (~rho[CHI1[t]] & rho[CHI2[t]] & M64) ^ (rc if t == 0 else 0)
            for t in range(WARP)]


def _warp_keccak_f(lanes):
    st = list(lanes) + [0] * (WARP - 25)
    for rc in K7_RC:
        st = _warp_round(st, rc)
    return st[:25]


def test_k7_round_constants_and_tables():
    """The source's round constants are the specification's; every
    thread's loads read a lane of the warp (threads 0-24 only the 25
    lanes; 25-31 hold none); the column layout gives every thread its own
    slot, puts each column on a 16-byte boundary (its first two pairs
    16-byte loads) and fits KECCAK_COL_WORDS."""
    assert K7_RC == list(pops._RC)
    for table in (WEST, EAST, RHO_ROT, PI_SRC, CHI1, CHI2):
        assert len(table) == WARP
    for t in range(WARP):
        assert 0 <= WEST[t] < 5 and 0 <= EAST[t] < 5
        assert all(0 <= r < (25 if t < 25 else WARP) for r in (PI_SRC[t], CHI1[t], CHI2[t])), t
    assert sorted(PI_SRC[:25]) == list(range(25))
    assert all(0 <= r < 64 for r in RHO_ROT)
    slots = [_col_slot(t) for t in range(WARP)]
    assert len(set(slots)) == WARP and max(slots) < COL_WORDS
    assert COL_PITCH >= 5 and COL_PITCH % 2 == 0 and 5 * COL_PITCH <= COL_WORDS
    assert {_col_slot(x + 5 * y) for x in range(5) for y in range(5)} == {
        COL_PITCH * x + y for x in range(5) for y in range(5)}


@pytest.mark.parametrize("r", range(64))
def test_k7_branchless_rotation_equals_rotl64(r):
    rng = np.random.RandomState(r)
    for v in [0, (1 << 64) - 1, 1, 1 << 63] + [int(x) for x in
                                              rng.randint(0, 1 << 62, size=6, dtype=np.int64)]:
        v |= (r & 1) << 62
        assert _rho(v, r & 31, r >= 32) == pops._rotl(v, r), (r, hex(v))


@pytest.mark.parametrize("state", ["zeros", "ones", "seed0", "seed1", "seed2"])
def test_k7_warp_round_model_equals_keccak_f(state):
    """The warp's 24 rounds on the source's tables give keccak_f's state."""
    if state == "zeros":
        lanes = [0] * 25
    elif state == "ones":
        lanes = [(1 << 64) - 1] * 25
    else:
        rng = np.random.RandomState(int(state[-1]))
        lanes = [int.from_bytes(rng.bytes(8), "little") for _ in range(25)]
    assert _warp_keccak_f(lanes) == pops.keccak_f(lanes)


def test_k7_warp_sponge_model_equals_keccak256():
    """The warp kernel's absorb (threads 0-16 take words 2t, 2t + 1 of a
    block), permutation and digest (threads 0-3 write lo, hi) on rows of
    0, 135, 136 and 300 bytes."""
    rng = np.random.RandomState(9)
    datas = [rng.bytes(n) for n in (0, 135, 136, 300)]
    _, _, padded, n_blocks = pops.pad_blocks(datas)
    words = padded.view("<u4").astype(np.int64).reshape(len(datas), -1, 34)
    for d, row, nb in zip(datas, words, n_blocks):
        lanes = [0] * 25
        for b in range(nb):
            for t in range(17):
                lanes[t] ^= int(row[b, 2 * t]) | int(row[b, 2 * t + 1]) << 32
            lanes = _warp_keccak_f(lanes)
        digest = [w for t in range(4) for w in (lanes[t] & M32, lanes[t] >> 32)]
        np.testing.assert_array_equal(digest, _words(pops.keccak256(d)))


def test_k7_switch_over_is_a_row_count():
    m = re.search(r"#define KECCAK_COOP_ROWS (\d+)", K7_SOURCE)
    assert m and int(m.group(1)) >= 1
    assert "if (n < KECCAK_COOP_ROWS) {" in K7_SOURCE


def _rotl(v, r):
    return (v << r | v >> (64 - r)) & M64 if r else v


def _least_depth_round(a, rc):
    """A round in the form that ``runtime.bounds.keccak_round_chain``
    counts: rho folded into theta's XOR, lane 0's round constant into a
    copy of C[4] and its own B, then pi and chi."""
    rot = [pops._ROT[i % 5][i // 5] for i in range(25)]
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
    b = [_rotl(a[i], rot[i]) ^ _rotl(c[(i + 4) % 5], rot[i]) ^ _rotl(c[(i + 1) % 5], rot[i] + 1)
         for i in range(25)]
    b0_rc = a[0] ^ (c[4] ^ rc) ^ _rotl(c[1], 1)
    b = [b[s] for s in pops._PI_SRC]
    return [(b0_rc if i == 0 else b[i]) ^ (~b[i - i % 5 + (i + 1) % 5] & b[i - i % 5 + (i + 2) % 5])
            for i in range(25)]


@pytest.mark.parametrize("state", ["zeros", "ones", "seed0", "seed1"])
def test_k7_chain_bound_form_equals_keccak_f(state):
    """The round whose depth bounds K7 (5 dependent instructions) computes
    keccak-f: 24 rounds of it give keccak_f's state."""
    from zkevm_specs_tpu_torch.runtime import bounds

    if state in ("zeros", "ones"):
        lanes = [0 if state == "zeros" else M64] * 25
    else:
        rng = np.random.RandomState(10 + int(state[-1]))
        lanes = [int.from_bytes(rng.bytes(8), "little") for _ in range(25)]
    want = pops.keccak_f(lanes)
    for rc in pops._RC:
        lanes = _least_depth_round(lanes, rc)
    assert lanes == want
    assert bounds.K7_ROUND_CHAIN == bounds.keccak_round_chain() == 5


# -- K8's plain version ---------------------------------------------------------

def _rlc_case(seed, T, n, prefix=True):
    rng = np.random.RandomState(seed)
    byte_cols = rng.randint(0, 256, size=(T, n)).astype(np.uint8)
    lens = rng.randint(0, T + 1, size=n)
    lens[:3] = [0, T, 1][:n]
    active = (np.arange(T)[:, None] < lens[None, :]) if prefix else (rng.rand(T, n) < 0.6)
    return byte_cols, active


def _horner_ints(byte_cols, active, r):
    T, n = byte_cols.shape
    out = []
    for i in range(n):
        acc = 0
        for j in range(T):
            if active[j, i]:
                acc = (acc * r + int(byte_cols[j, i])) % P
        out.append(acc)
    return out


@pytest.mark.parametrize("r_limbs", [1, 2, 14])
@pytest.mark.parametrize("prefix", [True, False])
def test_horner_rlc_matches_jax(r_limbs, prefix):
    byte_cols, active = _rlc_case(r_limbs * 3 + prefix, 40, 9, prefix)
    r = (int.from_bytes(np.random.RandomState(r_limbs).bytes(32), "little") % (1 << (16 * r_limbs))
         ) | (1 << (16 * r_limbs - 1))
    want = jk._horner_rlc(JCtx(np, 9, "eager"), byte_cols, active, r)
    got = pk.horner_rlc(torch.from_numpy(byte_cols), torch.from_numpy(active), r)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert JL.limbs_to_ints(want) == _horner_ints(byte_cols, active, r)


def test_horner_rlc_at_a_16_limb_r():
    """At r >= 2^224 the JAX step's sum is wider than reduce_wide's 32-limb
    input and it asserts (ROADMAP §C); the port caps the widths at 32 limbs
    (the value is below p^2) and equals the JAX field multiply-add scan and
    the Python-int Horner."""
    byte_cols, active = _rlc_case(16, 30, 7)
    r = (P - 12345) % P
    with pytest.raises(AssertionError):
        jk._horner_rlc(JCtx(np, 7, "eager"), byte_cols, active, r)
    acc = np.zeros((7, 16), dtype=np.uint32)
    r_row = JL.int_to_limbs(r, 16)[None, :]
    for j in range(byte_cols.shape[0]):
        nxt = jfr.add(np, jfr.mul(np, acc, r_row),
                      JL.pad_limbs(np, byte_cols[j][:, None].astype(np.uint32), 16))
        acc = np.where(active[j][:, None], nxt, acc)
    got = pk.horner_rlc(torch.from_numpy(byte_cols), torch.from_numpy(active), r + P)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.int64))
    assert JL.limbs_to_ints(acc) == _horner_ints(byte_cols, active, r)


def test_horner_rlc_wrapper_checks_its_inputs():
    byte_cols = torch.zeros((4, 3), dtype=torch.uint8)
    active = torch.ones((4, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="uint8"):
        pk.horner_rlc(byte_cols.to(torch.int64), active, 5)
    with pytest.raises(ValueError, match="bool"):
        pk.horner_rlc(byte_cols, active[:3], 5)
    with pytest.raises(ValueError):
        pk.horner_rlc(byte_cols.to("meta"), active.to("meta"), 5)


# -- K8's chunked schedule ------------------------------------------------------------

def _mask_case(seed, T, n, kind):
    """Bytes and a mask: "random" (non-prefix, with an all-inactive and an
    all-active row) or "prefix"."""
    byte_cols, active = _rlc_case(seed, T, n, prefix=kind == "prefix")
    if kind == "random":
        active[:, 1] = False
        active[:, 2] = True
    return byte_cols, active


@pytest.mark.parametrize("kind", ["random", "prefix"])
@pytest.mark.parametrize("chunk", [1, 3, 7, "T-1", "T", "T+1"])
def test_horner_rlc_chunked_plain_matches_jax(chunk, kind):
    """The chunked schedule's plain twin (chunk scans, counts, r^c from the
    power table, in-order combines) equals the JAX ``_horner_rlc`` limb for
    limb and the Python-int Horner, at every chunk length around T."""
    T, n = 23, 6
    byte_cols, active = _mask_case(len(kind), T, n, kind)
    c = {"T-1": T - 1, "T": T, "T+1": T + 1}.get(chunk, chunk)
    r = 0x1234_5678_9ABC_DEF0_1357
    want = jk._horner_rlc(JCtx(np, n, "eager"), byte_cols, active, r)
    got = pk.horner_rlc_chunked_plain(torch.from_numpy(byte_cols), torch.from_numpy(active), r, c)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert JL.limbs_to_ints(want) == _horner_ints(byte_cols, active, r)


@pytest.mark.parametrize("chunk", [1, 3, 7, 29, 30, 31])
def test_horner_rlc_chunked_plain_at_a_16_limb_r(chunk):
    """The twin at r >= 2^224 (the case of ``test_horner_rlc_at_a_16_limb_r``)
    equals the JAX field multiply-add scan and the Python-int Horner."""
    byte_cols, active = _mask_case(16, 30, 7, "random")
    r = (P - 12345) % P
    acc = np.zeros((7, 16), dtype=np.uint32)
    r_row = JL.int_to_limbs(r, 16)[None, :]
    for j in range(byte_cols.shape[0]):
        nxt = jfr.add(np, jfr.mul(np, acc, r_row),
                      JL.pad_limbs(np, byte_cols[j][:, None].astype(np.uint32), 16))
        acc = np.where(active[j][:, None], nxt, acc)
    got = pk.horner_rlc_chunked_plain(torch.from_numpy(byte_cols), torch.from_numpy(active),
                                      r + P, chunk)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.int64))
    assert JL.limbs_to_ints(acc) == _horner_ints(byte_cols, active, r)


def _stage_reads(T, n, s, rg, cg, stage):
    """The (step, row, thread) triples that block (rg, cg) of K8's chunk
    kernel stages in stage ``stage``, by the kernel's element order
    (csrc/horner_rlc.cu): element e = (chunk in block, line, row in block)."""
    R, Kb, S = s.rows_per_block, s.chunks_per_block, s.stage
    e = np.arange(S * R * Kb)
    er, q = e % R, e // R
    line, ekb = q % S, q // S
    step = stage * S + line
    ch = cg * Kb + ekb
    j = ch * s.chunk + step
    row = rg * R + er
    ok = (step < s.chunk) & (ch < s.chunks) & (j < T) & (row < n)
    return j[ok], row[ok], (ekb * R + er)[ok]


# the K8 shapes of the paths: the ALU block's keccak table, the arithmetic
# block's, the SHA3 mix, the withdrawal circuit, the tx and sig checks'
# [64, n] key bytes (the SSTORE block's 7 txs, the ALU block's 8, the
# arithmetic block's 40, the 1428-transfer block, the CPU comparison's 4);
# and edges
SCHEDULE_SHAPES = [(66001, 8), (24162, 40), (300, 65536), (42, 16), (0, 3), (1, 1), (70000, 1),
                   (1025, 40000), (64, 7), (64, 8), (64, 40), (64, 1428), (64, 4), (64, 2)]


@pytest.mark.parametrize("T,n", SCHEDULE_SHAPES)
def test_horner_schedule_covers_every_step(T, n):
    """``horner_schedule`` gives a valid cut: chunks cover [0, T) and C
    fits the power table; blocks fit 256 threads and cover every (row,
    chunk); the chunk kernel's stages read every step of every row exactly
    once, into the thread that owns its row and chunk; and the work fills
    at least half the card unless the steps run out."""
    s = pk.horner_schedule(T, n)
    threads = s.rows_per_block * s.chunks_per_block
    assert 1 <= s.chunk <= pk.HORNER_MAX_CHUNK and (s.chunks - 1) * s.chunk < max(T, 1)
    assert s.chunks * s.chunk >= T
    assert 1 <= threads <= pk.HORNER_BLOCK and 1 <= s.stage <= pk.HORNER_MAX_STAGE
    assert s.groups == -(-s.chunks // s.chunks_per_block)
    assert s.launches == (1 if s.groups == 1 else 2)
    assert s.groups <= s.combine_threads <= pk.HORNER_BLOCK
    assert 2 * n * s.chunks >= min(pk.HORNER_TARGET_ITEMS, n * T) \
        or s.chunk == pk.HORNER_MAX_CHUNK
    if n >= pk.HORNER_TARGET_ITEMS and T <= pk.HORNER_MAX_CHUNK:
        assert (s.chunk, s.chunks) == (max(T, 1), 1)       # one thread a row
    reads = np.zeros((T, n), dtype=np.int64)
    row_groups = -(-n // s.rows_per_block)
    for rg in range(row_groups):
        for cg in range(s.groups):
            for stage in range(-(-s.chunk // s.stage)):
                j, row, t = _stage_reads(T, n, s, rg, cg, stage)
                np.add.at(reads, (j, row), 1)
                assert np.array_equal(rg * s.rows_per_block + t % s.rows_per_block, row)
                assert np.array_equal((cg * s.chunks_per_block + t // s.rows_per_block)
                                      * s.chunk, j - (j % s.chunk))
    assert (reads == 1).all()


def _combine_ints(a, b):
    return (a[0] * b[1] + b[0]) % P, a[1] * b[1] % P


def _tree_ints(pairs):
    """The kernels' in-order tree: each level halves the sequence, position
    i taking the pairs at 2i and 2i + 1 (or the lone last one)."""
    pairs = list(pairs)
    while len(pairs) > 1:
        pairs = [_combine_ints(*pairs[i:i + 2]) if i + 1 < len(pairs) else pairs[i]
                 for i in range(0, len(pairs), 2)]
    return pairs[0]


def _kernel_on_ints(byte_cols, active, r, s, combine_threads=None):
    """K8's two kernels step by step on Python ints: each block's staged
    elements, its threads' chunk scans and counts, its tree, then (with
    more than one group) the combine kernel's per-thread folds and tree,
    at ``combine_threads`` threads (the launch's ``s.combine_threads``
    unless given: fewer fold several groups a thread, as more than 256
    groups do on the card)."""
    T, n = byte_cols.shape
    R, Kb = s.rows_per_block, s.chunks_per_block
    pairs = {}
    for rg in range(-(-n // R)):
        for cg in range(s.groups):
            acc = [[0, 0] for _ in range(R * Kb)]          # (h, c) of each thread
            for stage in range(-(-s.chunk // s.stage)):
                for j, row, t in zip(*_stage_reads(T, n, s, rg, cg, stage)):
                    if active[j, row]:
                        acc[t] = [(acc[t][0] * r + int(byte_cols[j, row])) % P, acc[t][1] + 1]
            for rr in range(R):
                row = rg * R + rr
                count = min(Kb, s.chunks - cg * Kb)
                if row < n:
                    pairs[row, cg] = _tree_ints([(acc[kb * R + rr][0], pow(r, acc[kb * R + rr][1], P))
                                                 for kb in range(count)])
    out = []
    for row in range(n):
        g = [pairs[row, cg] for cg in range(s.groups)]
        per = -(-s.groups // (combine_threads or s.combine_threads))
        runs = [g[i:i + per] for i in range(0, s.groups, per)]
        folded = []
        for run in runs:
            x = run[0]
            for y in run[1:]:
                x = _combine_ints(x, y)
            folded.append(x)
        out.append(_tree_ints(folded)[0])
    return out


@pytest.mark.parametrize("case", [
    "scheduled", "groups_folded", "stages", "rows_and_chunks"])
def test_horner_kernel_schedule_on_python_ints(case):
    """The kernels' indexing, stage by stage and tree by tree, on Python
    ints at small shapes: the schedule ``horner_schedule`` gives, and cuts
    that exercise what the card's shapes do at full size (several chunk
    groups folded per combine thread, partial stages, several rows and
    chunks in a block with a ragged last chunk) equal the Python-int
    Horner on a non-prefix mask."""
    T, n = {"scheduled": (40, 5), "groups_folded": (61, 3), "stages": (150, 3),
            "rows_and_chunks": (29, 7)}[case]
    byte_cols, active = _mask_case(T, T, n, "random")
    r = (P - 987654321) % P
    combine = None
    if case == "scheduled":
        s = pk.horner_schedule(T, n)
    else:
        chunk, R, Kb = {"groups_folded": (2, 1, 4), "stages": (70, 2, 2),
                        "rows_and_chunks": (4, 3, 3)}[case]
        s = pk.HornerSchedule(chunk, -(-T // chunk), R, Kb)
        combine = 2 if case == "groups_folded" else None
    if case == "stages":
        assert s.chunk % s.stage and s.chunk > 2 * s.stage     # a partial last stage
    assert _kernel_on_ints(byte_cols, active, r, s, combine) == _horner_ints(byte_cols, active, r)


def test_horner_constants_match_the_kernel_source():
    """The schedule's block and stage sizes are the kernel's, which
    derives stage, groups and combine threads from them itself."""
    src = (Path(pk.__file__).parents[1] / "csrc" / "horner_rlc.cu").read_text()
    assert f"constexpr int MAX_THREADS = {pk.HORNER_BLOCK};" in src
    assert f"constexpr int MAX_STAGE = {pk.HORNER_MAX_STAGE};" in src


# -- the circuit ------------------------------------------------------------------

def _vector(name):
    """(preimages, keccak rows, r, expected to pass) of one vector of
    tests/test_keccak_circuit.py."""
    if name == "ok":
        datas = [b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 300]
        return datas, _keccak_rows(datas, R), R, True
    if name == "bad_output":
        rows = _keccak_rows([b"abc"], R)
        rows[-1]["output"] ^= 1
        return [b"abc"], rows, R, False
    if name == "bad_rlc":
        rows = _keccak_rows([b"abcdef"], R)
        rows[-1]["input_rlc"] = rows[-1]["input_rlc"] + 1
        return [b"abcdef"], rows, R, False
    if name == "wrong_preimage":
        return [b"abd"], _keccak_rows([b"abc"], R), R, False
    # mixed: rows of 1, 2 and 3 blocks in one batch, the 3-block one wrong
    rng = np.random.RandomState(21)
    datas = [rng.bytes(n) for n in (10, 200, 300, 136, 272, 0)]
    rows = _keccak_rows(datas, R)
    rows[2]["output"] ^= 1 << 200
    return datas, rows, R, False


def _raises(verify, *args):
    try:
        verify(*args)
    except AssertionError as e:
        return str(e)
    return None


def _both(datas, rows, r):
    got = pk.keccak_kernel(datas, rows, r, device="cpu")().numpy()
    want = np.asarray(jk.keccak_kernel(datas, rows, r)())
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", ["ok", "bad_output", "bad_rlc", "wrong_preimage", "mixed"])
def test_vector_matches_jax(name):
    datas, rows, r, ok = _vector(name)
    fail = _both(datas, rows, r)
    assert (not fail.any()) == ok
    if name == "mixed":
        assert np.flatnonzero(fail).tolist() == [2]
    port_msg = _raises(pk.verify_keccak_circuit, datas, rows, r)
    jax_msg = _raises(jk.verify_keccak_circuit, datas, rows, r)
    assert port_msg == jax_msg and (port_msg is None) == ok
    pk.verify_keccak_circuit(datas, rows, r, success=ok)


@pytest.mark.parametrize("corrupt", [None, "output", "input_rlc"])
def test_sha3_mix_matches_jax(corrupt):
    datas, rows, r = workloads.build_keccak_sha3_mix(
        256, seed=2, corrupt_row=None if corrupt is None else 100, corrupt=corrupt or "output",
        r=BLOCK_R)
    fail = _both(datas, rows, r)
    assert np.flatnonzero(fail).tolist() == ([] if corrupt is None else [100])
    if corrupt is None:
        jk.verify_keccak_circuit(datas, rows, r)
        pk.verify_keccak_circuit(datas, rows, r)


@pytest.mark.parametrize("corrupt", [None, "input_rlc"])
def test_alu_block_matches_jax(corrupt):
    codes, rows, r = workloads.build_keccak_alu_block(
        2, 12, seed=3, corrupt_row=None if corrupt is None else 1, corrupt=corrupt or "output",
        r=BLOCK_R)
    fail = _both(codes, rows, r)
    assert np.flatnonzero(fail).tolist() == ([] if corrupt is None else [1])


def test_builders_at_their_drawn_randomness():
    """The builders' own r is 16 limbs, past the JAX step's reach: the port
    passes every row, catches the corrupted one alone, and its table rows
    are ``assign_keccak_table``'s."""
    datas, rows, r = workloads.build_keccak_sha3_mix(64, seed=4)
    assert r == workloads.draw_randomness(np.random.RandomState(4)) and r.bit_length() > 224
    assert rows == pbc.assign_keccak_table(datas, r)
    assert not pk.keccak_kernel(datas, rows, r, device="cpu")().any()
    _, bad, _ = workloads.build_keccak_sha3_mix(64, seed=4, corrupt_row=9, corrupt="input_rlc")
    assert torch.nonzero(pk.keccak_kernel(datas, bad, r, device="cpu")()).flatten().tolist() == [9]
    codes, rows, r = workloads.build_keccak_alu_block(1, 30, seed=4, corrupt_row=0)
    assert r == workloads.draw_randomness(np.random.RandomState(4))
    assert pk.keccak_kernel(codes, rows, r, device="cpu")().tolist() == [True]


def _horner_by_field_ops(ctx, byte_cols, active_cols, r):
    """The JAX ``_horner_rlc`` scan with the field's own multiply and add
    (``ops/fr.py`` ``mul``/``add``), which take an r of any width."""
    acc = np.zeros((byte_cols.shape[1], 16), dtype=np.uint32)
    r_row = JL.int_to_limbs(r % P, 16)[None, :]
    for j in range(byte_cols.shape[0]):
        byte = JL.pad_limbs(np, byte_cols[j][:, None].astype(np.uint32), 16)
        acc = np.where(active_cols[j][:, None], jfr.add(np, jfr.mul(np, acc, r_row), byte), acc)
    return acc


@pytest.mark.parametrize("builder,corrupt", [
    ("sha3_mix", None), ("sha3_mix", "output"), ("sha3_mix", "input_rlc"),
    ("alu_block", None), ("alu_block", "input_rlc"),
])
def test_builders_at_their_drawn_randomness_match_the_jax_circuit(monkeypatch, builder, corrupt):
    """At the builders' own 254-bit r the whole circuit is held lane for
    lane against the JAX circuit in spec mode, whose Horner scan is done by
    ``fr.mul``/``fr.add`` there (its ``_horner_rlc`` stops at r < 2^224)."""
    corrupt_row = None if corrupt is None else 5
    if builder == "sha3_mix":
        datas, rows, r = workloads.build_keccak_sha3_mix(
            48, seed=6, corrupt_row=corrupt_row, corrupt=corrupt or "output")
    else:
        datas, rows, r = workloads.build_keccak_alu_block(
            2, 12, seed=6, corrupt_row=None if corrupt is None else 1, corrupt=corrupt or "output")
    assert r.bit_length() > 224
    monkeypatch.setattr(jk, "_horner_rlc", _horner_by_field_ops)
    jctx, jcols, jextra = jk.build_keccak_inputs(datas, [r_ for r_ in rows if r_["state_tag"] == 2])
    jcs = JConstraintSystem(jctx)
    jk.check_keccak(jctx, jcs, jcols, {}, {"r": r}, jextra)
    want = np.asarray(jcs.fail)
    got = pk.keccak_kernel(datas, rows, r, device="cpu")().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.flatnonzero(got).tolist() == (
        [] if corrupt is None else [corrupt_row if builder == "sha3_mix" else 1])


def test_sha3_mix_lengths():
    lengths = workloads.sha3_mix_lengths(1024, np.random.RandomState(0))
    values, counts = np.unique(lengths, return_counts=True)
    got = dict(zip(values.tolist(), counts.tolist()))
    assert got.pop(64) == 512 and got.pop(32) == 256
    assert sorted(got) == list(workloads.PAD_EDGE_LENGTHS) and sum(got.values()) == 256
    assert max(got.values()) - min(got.values()) <= 1
    assert lengths[:8].tolist() != sorted(lengths[:8].tolist())   # drawn order
    datas, rows, _ = workloads.build_keccak_sha3_mix(48, seed=1)
    assert [len(d) for d in datas] == [row["input_len"] for row in rows]


# -- the device context --------------------------------------------------------------

def test_device_context_reads_nothing_back(monkeypatch):
    """A device check (here on CPU tensors) never takes a host path: no
    tensor value is read back while it runs, in the kernels' wrappers or
    around them."""
    datas, rows, r, _ = _vector("mixed")
    kernel = pk.keccak_kernel(datas, rows, r, device="cpu")
    args = kernel.device_args()
    assert args[2]["byte_cols"].dtype == torch.uint8
    assert args[2]["active_cols"].dtype == torch.bool
    assert args[2]["blocks"].dtype == torch.int64 and args[2]["n_blocks"].dtype == torch.int32

    def host_read(*a, **k):
        raise AssertionError("a tensor value was read back during a device check")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    fail = kernel(args)
    monkeypatch.undo()
    assert np.flatnonzero(fail.numpy()).tolist() == [2]


def test_default_device_is_the_card_and_never_falls_back():
    datas, rows, r, _ = _vector("ok")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pk.keccak_kernel(datas, rows, r)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pk.keccak_kernel([], [], r)
    assert pk.keccak_kernel([], [], r, device="cpu") is None
