"""The CUDA kernels against their plain PyTorch versions on the card,
over every mode and operand width class they take, bit-exact (they are
integer functions).  Marked ``cuda``: each test skips where no CUDA device
is present, and runs on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a CUDA machine
need not have.)
"""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.ops import word_mul
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables import logup

from word_mul_cases import CASES as WORD_MUL_CASES
from word_mul_cases import make_case

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROWS = 1000     # not a multiple of the 256-thread block


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(rng, rows, n, bits, dev):
    vals = [int.from_bytes(rng.bytes(40), "little") % (1 << bits) for _ in range(rows)]
    edges = [0, 1, (1 << bits) - 1, fr.P - 1 if bits >= 254 else 1, (1 << bits) >> 1]
    vals[:len(edges)] = [e % (1 << bits) for e in edges][:rows]
    if bits >= 254:
        vals = [v % fr.P for v in vals]
    return L.ints_to_limbs(vals, n).to(dev)


def _operands(seed, na, nb, broadcast, dev, bits_a=None, bits_b=None):
    rng = np.random.RandomState(seed)
    a = _limbs(rng, ROWS, na, bits_a or 16 * na, dev)
    b = _limbs(rng, ROWS, nb, bits_b or 16 * nb, dev)
    if broadcast == "b":
        b = b[3:4]
    elif broadcast == "a":
        a = a[4:5]
    return a, b


def _equal(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("na,nb,out_n", [(1, 1, 1), (2, 2, 4), (3, 5, 8), (4, 4, 8), (8, 8, 16),
                                         (16, 8, 16), (16, 16, 32), (17, 16, 17), (17, 17, 34),
                                         (9, 16, 20), (4, 4, 2), (16, 4, 34)])
def test_limb_mul(dev, na, nb, out_n, broadcast):
    a, b = _operands(na * 37 + nb, na, nb, broadcast, dev)
    _equal(L.limb_mul(a, b, out_n), L.mul_plain(a, b, out_n))


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("mode,na,nb,out_n", [
    (L.ADD, 1, 1, 1), (L.ADD, 1, 2, 2), (L.ADD, 2, 2, 4), (L.ADD, 8, 16, 16), (L.ADD, 16, 16, 17),
    (L.ADD, 17, 17, 17), (L.ADD, 16, 16, 8),
    (L.SUB, 1, 1, 0), (L.SUB, 2, 4, 0), (L.SUB, 16, 16, 0), (L.SUB, 17, 17, 0), (L.SUB, 16, 8, 0),
    (L.FR_ADD, 16, 16, 0), (L.FR_ADD, 4, 16, 0), (L.FR_ADD, 17, 1, 0),
    (L.FR_SUB, 16, 16, 0), (L.FR_SUB, 1, 16, 0), (L.FR_SUB, 16, 4, 0),
])
def test_limb_addsub(dev, mode, na, nb, out_n, broadcast):
    fr_bits = 254 if mode in (L.FR_ADD, L.FR_SUB) else None
    a, b = _operands(mode * 100 + na * 7 + nb, na, nb, broadcast, dev,
                     bits_a=None if na > 16 or not fr_bits else min(fr_bits, 16 * na),
                     bits_b=None if nb > 16 or not fr_bits else min(fr_bits, 16 * nb))
    _equal(L.limb_addsub(a, b, mode, out_n), L.addsub_plain(a, b, mode, out_n))


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("na,nb", [(16, 16), (4, 16), (16, 1), (8, 8), (1, 1)])
def test_fr_mul(dev, na, nb, broadcast):
    a, b = _operands(na * 11 + nb, na, nb, broadcast, dev,
                     bits_a=min(254, 16 * na), bits_b=min(254, 16 * nb))
    _equal(fr.fr_mul(a, b), fr.fr_mul_plain(a, b))
    p1 = fr.from_ints([fr.P - 1] * 7, dev)
    _equal(fr.fr_mul(p1, p1), fr.fr_mul_plain(p1, p1))


@pytest.mark.parametrize("with_enabled", [None, "lanes", "row"])
def test_lookup_gather_eq(dev, with_enabled):
    rng = np.random.RandomState(5)
    n_rows = 3000
    widths = [2, 1, 16, 8, 8]
    table = [torch.from_numpy(rng.randint(0, 1 << 16, size=(n_rows, w))).to(dev) for w in widths]
    table[2][:, 2:] = 0                                 # a wide column holding narrow values
    idx = torch.from_numpy(rng.randint(-3, n_rows + 3, size=ROWS).astype(np.int32)).to(dev)
    rows = idx.long().clamp(0, n_rows - 1)
    query = [table[0][rows].clone(), table[1][rows[:1]].clone(), table[2][rows][:, :2].clone(),
             table[3][rows].clone(), None]
    query[0][::7, 0] += 1                               # some lanes mismatch
    enabled = None
    if with_enabled == "lanes":
        enabled = torch.from_numpy(rng.rand(ROWS) < 0.5).to(dev)
    elif with_enabled == "row":
        enabled = torch.tensor([False], device=dev)
    got = engine.lookup_gather_eq(table, query, idx, enabled)
    want = engine.lookup_gather_eq_plain(table, query, idx, enabled)
    _equal([got[0], *got[1]], [want[0], *want[1]])
    ok, gathered = engine.lookup_gather_eq(table, [None] * 5, idx, want_ok=False)
    assert ok is None
    _equal(gathered, engine.lookup_gather_eq_plain(table, [None] * 5, idx)[1])


def test_counts_rise_only_where_a_kernel_launches(dev):
    a = torch.ones((4, 4), dtype=torch.int64, device=dev)
    before = L.LAUNCHES["limb_mul"]
    L.limb_mul(a, a, 8)
    L.limb_mul(a.cpu(), a.cpu(), 8)
    assert L.LAUNCHES["limb_mul"] == before + 1
    with pytest.raises(ValueError):
        L.limb_mul(a, a.cpu(), 8)


# -- K1 at the bytecode circuit's shape: a one-limb constant multiplier ----------

@pytest.mark.parametrize("value", [1, 2, 0xFFFF])
def test_fr_mul_one_limb_constant(dev, value):
    a, _ = _operands(value % 97, 16, 1, None, dev, bits_a=254)
    b = L.int_to_limbs(value, 1)[None, :].to(dev)
    _equal(fr.fr_mul(a, b), fr.fr_mul_plain(a, b))


# -- K5: the state circuit's ordering check ---------------------------------------

def _order_cols(seed, dev):
    """The key columns of ROWS rows at their declared widths, neighbours
    sharing prefixes, with the edge values id = MAX_ID, address = 2^160-1,
    storage_key = 2^256-1 and rw_counter = 2^32-1."""
    rng = np.random.RandomState(seed)

    def col(bits, n, edge):
        vals = [int.from_bytes(rng.bytes(40), "little") % (1 << bits) for _ in range(ROWS)]
        vals[5:9] = [edge] * 4
        vals[300:400] = [vals[299]] * 100
        return L.ints_to_limbs(vals, n)

    tag = L.ints_to_limbs([int(t) for t in rng.randint(1, 12, size=ROWS)], 1)
    tag[::50] = 1                                       # Start rows
    sk = col(256, 16, (1 << 256) - 1)
    cols = [tag, col(28, 2, (1 << 28) - 1), col(160, 16, (1 << 160) - 1), col(16, 1, 0xFFFF),
            sk[:, :8].contiguous(), sk[:, 8:].contiguous(), col(32, 2, (1 << 32) - 1)]
    return [c.to(dev) for c in cols]


@pytest.mark.parametrize("seed", [0, 1])
def test_state_order_lt(dev, seed):
    from zkevm_specs_tpu_torch.circuits import state

    cols = _order_cols(seed, dev)
    before = L.LAUNCHES["state_order_lt"]
    got = state.state_order_lt(*cols)
    assert L.LAUNCHES["state_order_lt"] == before + 1
    _equal(got, state.state_order_lt_plain(*cols))
    assert got.any() and not got.all()


# -- K6: the fingerprint search ---------------------------------------------------

def _search_case(dev, n_rows=3000, span_run=3):
    """A table of three parts (2, 16 and 8 limbs), its host index, and
    ROWS queries: most copy a row, every 7th differs, and a run of
    ``span_run`` rows shares the first two parts."""
    rng = np.random.RandomState(17)
    table = [rng.randint(0, 1 << 16, size=(n_rows, w)).astype(np.int64) for w in (2, 16, 8)]
    table[1][:, 10:] = 0
    run = [10, 500, 2000][:span_run]
    for p in (0, 1):
        table[p][run] = table[p][run[0]]
    coefs = torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, size=(3, 16)).astype(np.int64))
    table_t = [torch.from_numpy(t) for t in table]
    fps = engine.fingerprint_plain(table_t, coefs)
    order = torch.sort(fps ^ engine._SIGN, stable=True).indices
    sorted_fps = fps[order].contiguous()
    picks = rng.randint(0, n_rows, size=ROWS)
    picks[:4] = run[0]
    query = [t[picks].clone() for t in table_t]
    query[2][::7, 0] += 1
    query[1] = query[1][:, :10].contiguous()           # a narrower query than its column
    to = lambda ts: [t.to(dev) for t in ts]            # noqa: E731
    return to(query), to(table_t), coefs.to(dev), sorted_fps.to(dev), order.to(dev)


@pytest.mark.parametrize("subset", ["all", "first_two"])
@pytest.mark.parametrize("max_span", [1, 2, 3, 8])
def test_lookup_search_eq(dev, subset, max_span):
    query, table, coefs, fps, order = _search_case(dev)
    if subset == "first_two":                          # the span-3 run is ambiguous here
        table_c = [t.cpu() for t in table[:2]]
        coefs = coefs[:2].contiguous()
        fps_rows = engine.fingerprint_plain(table_c, coefs.cpu())
        order = torch.sort(fps_rows ^ engine._SIGN, stable=True).indices
        fps = fps_rows[order].contiguous().to(dev)
        order = order.to(dev)
        query, table = query[:2], table[:2]
    args = (query, table, coefs, fps, order, max_span, ROWS)
    before = L.LAUNCHES["lookup_search_eq"]
    got = engine.lookup_search_eq(*args)
    assert L.LAUNCHES["lookup_search_eq"] == before + 1
    want = engine.lookup_search_eq_plain(*args)
    _equal(list(got), list(want))
    if subset == "first_two":
        assert bool(got[2][:4].all()) == (max_span < 2)    # ambiguous once 2 are scanned
        assert bool(got[3][:4].all()) == (max_span >= 3)   # covered only with span >= 3
    # a broadcast [1, w] query row
    row_query = [q[:1].contiguous() for q in query]
    args = (row_query, table, coefs, fps, order, max_span, ROWS)
    _equal(list(engine.lookup_search_eq(*args)), list(engine.lookup_search_eq_plain(*args)))


def test_lookup_fingerprint(dev):
    _, table, coefs, _, _ = _search_case(dev)
    before = L.LAUNCHES["lookup_fingerprint"]
    got = engine.lookup_fingerprint(table, coefs)
    assert L.LAUNCHES["lookup_fingerprint"] == before + 1
    _equal(got, engine.fingerprint_plain(table, coefs))


# -- K1 after its arithmetic moved to csrc/fr_arith.cuh ----------------------------

def test_fr_mul_equals_python_ints(dev):
    rng = np.random.RandomState(31)
    a_vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(ROWS)]
    b_vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(ROWS)]
    a_vals[:4] = [0, 1, fr.P - 1, fr.P - 1]
    b_vals[:4] = [fr.P - 1, fr.P - 1, fr.P - 1, 1]
    got = fr.fr_mul(fr.from_ints(a_vals, dev), fr.from_ints(b_vals, dev))
    torch.cuda.synchronize()
    assert fr.to_ints(got) == [a * b % fr.P for a, b in zip(a_vals, b_vals)]


# -- K7: the keccak sponge ----------------------------------------------------------

def _sponge_case(kind):
    from zkevm_specs_tpu_torch.ops import keccak

    rng = np.random.RandomState(41)
    if kind == "edges":
        lengths = [0, 1, 135, 136, 137, 271, 272, 300]
    else:                               # ROWS rows of 1 to 4 blocks in one batch
        lengths = rng.randint(0, 4 * 136, size=ROWS).tolist()
    datas = [rng.bytes(n) for n in lengths]
    _, _, padded, n_blocks = keccak.pad_blocks(datas)
    blocks = torch.from_numpy(padded.view("<u4").astype(np.int64).reshape(len(datas), -1, 34))
    return datas, blocks, torch.from_numpy(n_blocks.astype(np.int32))


@pytest.mark.parametrize("kind", ["edges", "mixed"])
def test_keccak_sponge(dev, kind):
    from zkevm_specs_tpu_torch.ops import keccak

    datas, blocks, n_blocks = _sponge_case(kind)
    blocks, n_blocks = blocks.to(dev), n_blocks.to(dev)
    before = L.LAUNCHES["keccak_sponge"]
    got = keccak.keccak_sponge(blocks, n_blocks)
    assert L.LAUNCHES["keccak_sponge"] == before + 1
    _equal(got, keccak.keccak_sponge_plain(blocks, n_blocks))
    words = got.cpu().numpy().astype("<u4")
    assert [w.tobytes() for w in words] == [keccak.keccak256(d) for d in datas]


def test_keccak_sponge_clamps_the_block_count(dev):
    from zkevm_specs_tpu_torch.ops import keccak

    _, blocks, n_blocks = _sponge_case("edges")
    n_blocks = torch.tensor([0, -3, 1, 2, 9, 3, 100, 1], dtype=torch.int32)
    blocks, n_blocks = blocks.to(dev), n_blocks.to(dev)
    _equal(keccak.keccak_sponge(blocks, n_blocks), keccak.keccak_sponge_plain(blocks, n_blocks))


# -- K8: the byte-RLC Horner scan ---------------------------------------------------

@pytest.mark.parametrize("mask", ["prefix", "random"])
@pytest.mark.parametrize("r_limbs", [1, 16])
def test_horner_rlc(dev, r_limbs, mask):
    from zkevm_specs_tpu_torch.circuits import keccak

    rng = np.random.RandomState(r_limbs + len(mask))
    T = 70
    byte_cols = torch.from_numpy(rng.randint(0, 256, size=(T, ROWS)).astype(np.uint8))
    if mask == "prefix":
        lens = rng.randint(0, T + 1, size=ROWS)
        lens[:2] = [0, T]
        active = torch.from_numpy(np.arange(T)[:, None] < lens[None, :])
    else:
        active = torch.from_numpy(rng.rand(T, ROWS) < 0.7)
    r = fr.P - 1 - int(rng.randint(1 << 30)) if r_limbs == 16 else 0x64
    byte_cols, active = byte_cols.to(dev), active.to(dev)
    before = L.LAUNCHES["horner_rlc"]
    got = keccak.horner_rlc(byte_cols, active, r)
    assert L.LAUNCHES["horner_rlc"] == before + 1
    _equal(got, keccak.horner_rlc_plain(byte_cols, active, r))


# -- K9 and K10: the block verifier's upload and verdict gather -----------------------

def _leaves(kind, seed=0):
    """Host leaves of the block verifier's kinds: 16-bit limb tensors and
    numpy uint32 columns (narrowed to u8/u16 by their maximum, or kept at
    int64 past 2^16), u64 fingerprints, int32 and int64 columns, bool and
    uint8 columns; with empty and one-element leaves."""
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 7, 4096, 4097, 10_000]
    out = []
    for i, n in enumerate(sizes):
        if kind == "u8":
            out.append(torch.from_numpy(rng.randint(0, 256, size=(n, 1)).astype(np.int64)))
        elif kind == "u16":
            out.append(rng.randint(0, 1 << 16, size=n).astype(np.uint32))
        else:
            out += [torch.from_numpy(rng.randint(0, 1 << 16, size=(n, 2)).astype(np.int64)),
                    rng.randint(0, 200, size=n).astype(np.uint32),
                    torch.from_numpy(rng.randint(-2**62, 2**62, size=n, dtype=np.int64)),
                    rng.randint(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2) + np.uint64(i % 2),
                    rng.randint(-2**31, 2**31, size=n).astype(np.int32),
                    rng.rand(n) < 0.5,
                    torch.from_numpy(rng.randint(0, 256, size=n).astype(np.uint8))]
    return out


@pytest.mark.parametrize("kind", ["u8", "u16", "mixed"])
def test_leaf_unpack(dev, kind):
    from zkevm_specs_tpu_torch.runtime import transfer
    from zkevm_specs_tpu_torch.runtime.convert import to_device

    leaves = _leaves(kind, seed=len(kind))
    before = L.LAUNCHES["leaf_unpack"]
    got, plan = transfer.upload(leaves, dev)
    assert L.LAUNCHES["leaf_unpack"] == before + 1
    torch.cuda.synchronize()
    for g, leaf in zip(got, leaves):
        want = to_device(leaf, dev)
        assert g.dtype == want.dtype and g.shape == want.shape and torch.equal(g, want)
    # every leaf of the arena against K9's plain version on the same staged buffers
    staged = transfer.stage(plan, dev)
    args = (staged[:4], staged[4], len(plan.segs), plan.arena_bytes)
    _equal(transfer.leaf_views(transfer.leaf_unpack(*args), plan),
           transfer.leaf_views(transfer.leaf_unpack_plain(*args), plan))


@pytest.mark.parametrize("lengths", [[1], [0, 1, 5], [1000, 1, 1 << 20, 3, 4097]])
def test_verdict_pack(dev, lengths):
    from zkevm_specs_tpu_torch.runtime import transfer

    rng = np.random.RandomState(len(lengths))
    fails = [torch.from_numpy(rng.rand(n) < 0.3).to(dev) for n in lengths]
    before = L.LAUNCHES["verdict_pack"]
    got = transfer.verdict_pack(fails)
    assert L.LAUNCHES["verdict_pack"] == before + 1
    _equal(got, transfer.verdict_pack_plain(fails))


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", WORD_MUL_CASES)
def test_mul_add_words(dev, case, wide):
    rows, _, _ = make_case(case, wide, n=ROWS)
    rows = [r.to(dev) for r in rows]
    before = L.LAUNCHES["mul_add_words"]
    ok, overflow = word_mul.mul_add_words(rows, wide)
    assert L.LAUNCHES["mul_add_words"] == before + 1
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    _equal(ok, want_ok.expand(ok.shape))
    if wide:
        assert overflow is None
    else:
        _equal(overflow, want_over.expand(overflow.shape))


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", ["random_valid", "random_fields", "constants"])
def test_mul_add_words_at_group_lanes(dev, case, wide):
    """At the MUL group's 131072 lanes."""
    rows, _, _ = make_case(case, wide, n=131072, seed=1)
    rows = [r.to(dev) for r in rows]
    ok, overflow = word_mul.mul_add_words(rows, wide)
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    _equal(ok, want_ok.expand(ok.shape))
    if not wide:
        _equal(overflow, want_over.expand(overflow.shape))


def _small_block(kind="alu"):
    from zkevm_specs_tpu_torch import workloads

    return workloads.build_alu_block(2, 6) if kind == "alu" else workloads.build_arith_block(2, 2)


@pytest.mark.parametrize("kind", ["alu", "arith"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_block_graph_replay_equals_per_kernel_pass(dev, corrupt, kind):
    from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

    w = _small_block(kind)
    if corrupt:
        name = "ADD" if kind == "alu" else "MULMOD"
        next(s for s in w.steps if s.execution_state.name == name).gas_left += 1
    bv = CompiledBlockVerifier(w)                       # device "cuda"
    prepared = bv.prepare()
    per_kernel = bv.run_device(prepared)
    assert bv.run_device_combined(prepared) == per_kernel       # captures, then replays
    captured = prepared["graph"]["launches"]
    assert captured["verdict_pack"] == 1 and "leaf_unpack" not in captured
    before = L.LAUNCHES.copy()
    assert bv.run_device_combined(prepared) == per_kernel       # a replay alone
    assert L.LAUNCHES == before, "a graph replay goes through no kernel wrapper"
    on_cpu = CompiledBlockVerifier(w, device="cpu")
    assert on_cpu.run_device(on_cpu.prepare()) == per_kernel
    assert bool(per_kernel) == corrupt


# -- K12 (field inverse) and K13 (batch inverse, logUp partial sum) ------------------

def _fr_values(rng, n, zero_at=None):
    vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(n)]
    edges = [1, 2, fr.P - 1, fr.P - 2, 1 << 128]
    vals[:min(n, len(edges))] = edges[:n]
    vals = [v or 1 for v in vals]
    if zero_at is not None:
        vals[{"first": 0, "middle": n // 2, "last": n - 1}[zero_at]] = 0
    return vals


@pytest.mark.parametrize("rows,width", [(1, 16), (1000, 16), (1000, 4), (300, 1)])
def test_fr_inv(dev, rows, width):
    rng = np.random.RandomState(rows + width)
    vals = [v % (1 << (16 * width)) for v in _fr_values(rng, rows)]
    vals[rows // 2] = 0
    a = L.ints_to_limbs(vals, width).to(dev)
    before = L.LAUNCHES["fr_inv"]
    got = fr.inv(a)
    assert L.LAUNCHES["fr_inv"] == before + 1
    _equal(got, fr.inv_plain(a))
    assert fr.to_ints(got.cpu()) == [pow(v, fr.P - 2, fr.P) for v in vals]


# n = 1, a chunk (16), past it, and sizes that are no multiple of a chunk or
# of a 128-thread block
@pytest.mark.parametrize("zero_at", [None, "first", "middle", "last"])
@pytest.mark.parametrize("n", [1, 16, 17, 1000, 4097])
def test_batch_inverse(dev, n, zero_at):
    vals = _fr_values(np.random.RandomState(n), n, zero_at)
    x = L.ints_to_limbs(vals, 16).to(dev)
    before = L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"]
    got = logup.batch_inverse(x)
    assert (L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"]) == (before[0] + 2, before[1] + 1)
    _equal(got, logup.batch_inverse_plain(x))
    want = ([0] * n if zero_at else [pow(v, fr.P - 2, fr.P) for v in vals])
    assert fr.to_ints(got.cpu()) == want


@pytest.mark.parametrize("mult", [None, "en", "counts"])
@pytest.mark.parametrize("n", [1, 17, 1000, 4097])
def test_logup_partial_sum(dev, n, mult):
    rng = np.random.RandomState(n + 7)
    fps = L.ints_to_limbs(_fr_values(rng, n), 16).to(dev)
    alpha = L.int_to_limbs(0xA1FA, 16).to(dev)
    m = {None: None, "en": torch.from_numpy(rng.randint(0, 2, size=(n, 1))),
         "counts": torch.from_numpy(rng.randint(0, 1 << 16, size=(n, 4)))}[mult]
    m = None if m is None else m.to(dev)
    got = logup.logup_partial_sum(fps, alpha, m)
    _equal(got, logup.logup_partial_sum_plain(fps, alpha, m))
    # alpha equal to one fingerprint: a zero denominator zeroes the sum
    at = fps[n // 2].clone()
    zero = logup.logup_partial_sum(fps, at, m)
    _equal(zero, logup.logup_partial_sum_plain(fps, at, m))
    assert not bool(zero.any())
