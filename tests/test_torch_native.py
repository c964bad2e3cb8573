"""The port's native host library (zkevm_specs_tpu_torch.runtime.native)
against the JAX package's, tolerance 0: each wrapper equal to the JAX
wrapper of the same name and to the port's Python path (the port with its
library made unavailable), on tests/test_native.py's cases and the edges
(coordinates at or past p, infinity, k >= 2^256, a G2 point outside the
subgroup, a key off the curve in ``verify_batch``); the port's dispatch
sites (keccak, secp256k1, BN254) equal to the JAX ones; and the library
built from csrc/'s sources into build/native/, with nothing written into
csrc/.  Where no C compiler exists the tests skip inside, as
tests/test_native.py does."""
import random
import shutil

import pytest
import torch

from zkevm_specs_tpu.ops import keccak as jkeccak
from zkevm_specs_tpu.ops.ecc import bn254 as jbn
from zkevm_specs_tpu.ops.ecc import secp256k1 as jec
from zkevm_specs_tpu.runtime import native as jnative
from zkevm_specs_tpu_torch.ops import keccak as pkeccak
from zkevm_specs_tpu_torch.ops.ecc import bn254 as pbn
from zkevm_specs_tpu_torch.ops.ecc import secp256k1 as pec
from zkevm_specs_tpu_torch.runtime import native

torch.set_num_threads(1)


def _need_native():
    if shutil.which(native.compiler()) is None or not native.native_available():
        pytest.skip("no C compiler: the native library cannot be built")
    if not jnative.native_available():
        pytest.skip("the JAX package's native library is not built")


def _py(fn, *args):
    """``fn(*args)`` with the port's library unavailable."""
    with native.disabled():
        return fn(*args)


# -- keccak ---------------------------------------------------------------------

def _preimages():
    rng = random.Random(5)
    return ([b"", b"abc", b"\x00" * 136, b"q" * 137, bytes(range(256)) * 3, b"d" * 500]
            + [bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 301))) for _ in range(64)])


def test_keccak_wrappers_match_jax_and_python():
    _need_native()
    datas = _preimages()
    want = [jkeccak._keccak256_py(d) for d in datas]
    assert [native.keccak256_native(d) for d in datas] == want
    assert [jnative.keccak256_native(d) for d in datas] == want
    assert [pkeccak._keccak256_py(d) for d in datas] == want
    assert native.keccak256_batch_native(datas) == jnative.keccak256_batch_native(datas) == want
    assert pkeccak.keccak256_batch(datas) == _py(pkeccak.keccak256_batch, datas) == want
    assert native.keccak256_batch_native([]) == []


def test_keccak_dispatch_on_a_memo_miss():
    _need_native()
    data = b"a preimage no other test hashes"
    pkeccak._keccak256.cache_clear()
    assert pkeccak.keccak256(data) == jkeccak.keccak256(data) == pkeccak._keccak256_py(data)


# -- secp256k1 -------------------------------------------------------------------

def _double_mul_cases():
    rng = random.Random(42)
    cases = []
    for _ in range(10):
        pk = pec.mul(pec.G, rng.randrange(1, pec.N))
        cases.append((rng.randrange(0, pec.N), rng.randrange(0, pec.N), pk))
    k = 12345
    pk = pec.mul(pec.G, k)
    cases += [(0, 7, pk), (7, 0, pk), (0, 0, pk), (pec.N - k, 1, pk)]   # the last sums to infinity
    return cases


def test_secp256k1_double_mul_matches_jax_and_python():
    _need_native()
    for u1, u2, pk in _double_mul_cases():
        want = jec.add(jec.mul(jec.G, u1), jec.mul(pk, u2))
        assert native.secp256k1_double_mul_native(u1, u2, *pk) == want
        assert jnative.secp256k1_double_mul_native(u1, u2, *pk) == want
        assert pec._double_mul(u1, u2, pk) == _py(pec._double_mul, u1, u2, pk) == want


def _verify_rows():
    rng = random.Random(43)
    rows = []
    for i in range(12):
        sk = rng.randrange(1, pec.N)
        pk = pec.mul(pec.G, sk)
        h = rng.randrange(1, pec.N)
        _v, r, s = pec.sign(h, sk, rng.randrange(1, pec.N))
        if i % 3 == 0:
            s = (s + 1) % pec.N
        rows.append((h, r, s, pk))
    h, r, s, pk = rows[1]
    rows += [(h, r, s, (pk[0], pk[1] + 1)),     # a key off the curve
             (h, r, s, None),                   # no key
             (h, 0, s, pk), (h, r, pec.N, pk),  # r = 0, s = N
             (h + (1 << 256), r, s, pk)]        # a hash past 2^256
    return rows


def test_secp256k1_verify_batch_matches_jax_and_python():
    _need_native()
    rows = _verify_rows()
    want = [jec.verify(h, r, s, pk) for h, r, s, pk in rows[:-1]]
    got = pec.verify_batch(rows)
    assert got == jec.verify_batch(rows)
    assert got[:-1] == want
    # a hash past 2^256 is taken mod 2^256 by the library (as by the JAX
    # wrapper) and whole by the Python path: only there may they differ
    assert got[:-1] == _py(pec.verify_batch, rows)[:-1]
    h, r, s, pk = rows[-1]
    assert got[-1] == jec.verify(h % (1 << 256), r, s, pk)
    usable = [pk is not None and pec.is_on_curve(pk) for *_, pk in rows]
    native_rows = [(h, r, s, pk if ok else pec.G) for ok, (h, r, s, pk) in zip(usable, rows)]
    assert (native.secp256k1_verify_batch_native(native_rows)
            == jnative.secp256k1_verify_batch_native(native_rows))
    assert got[12:14] == [False, False]


# -- BN254 -----------------------------------------------------------------------

def _g1_cases():
    g = pbn.G1
    p = pbn.g1_mul(g, 31337)
    return [(g, p), (p, (p[0], pbn.P - p[1])), (None, p), (p, None), (None, None), (p, p),
            ((g[0] + pbn.P, g[1]), p),                       # a coordinate past p
            ((p[0], p[1] + pbn.P), (g[0], g[1] + pbn.P)),    # both past p
            ((pbn.P, 2), g)]                                 # x at p


def test_bn254_g1_add_matches_jax_and_python():
    _need_native()
    for a, b in _g1_cases():
        got = native.bn254_g1_add_native(a, b)
        assert got == jnative.bn254_g1_add_native(a, b)
        assert pbn.g1_add(a, b) == jbn.g1_add(a, b) == got
        assert _py(pbn.g1_add, a, b) == got


def test_bn254_g1_add_past_p_differs_from_python_as_in_jax():
    """Two points whose x agree mod p but not as integers (one past p): the
    library reduces first and doubles, the Python formulas take the
    chord through a zero denominator.  Both packages' libraries agree, and
    both packages' Python paths agree."""
    _need_native()
    g = pbn.G1
    past = (g[0] + pbn.P, g[1])
    got = pbn.g1_add(past, g)
    assert got == jbn.g1_add(past, g) == native.bn254_g1_add_native(past, g) == pbn.g1_mul(g, 2)
    with native.disabled(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", True)
        py = pbn.g1_add(past, g)
        assert py == jbn.g1_add(past, g) != got


def test_bn254_g1_mul_matches_jax_and_python():
    _need_native()
    rng = random.Random(7)
    pts = [pbn.G1, pbn.g1_mul(pbn.G1, 99), (pbn.G1[0] + pbn.P, pbn.G1[1]), None]
    ks = [0, 1, 2, pbn.R - 1, pbn.R, rng.getrandbits(254), 2**256 - 1]
    for pt in pts:
        for k in ks:
            got = native.bn254_g1_mul_native(pt, k)
            assert got == jnative.bn254_g1_mul_native(pt, k)
            assert pbn.g1_mul(pt, k) == jbn.g1_mul(pt, k) == got
            # the library reduces a coordinate past p; the Python path (the
            # JAX module's affine loop for such a point) can return it as
            # given (k = 1 returns the input): equal mod p
            py = _py(pbn.g1_mul, pt, k)
            assert (py if py is None else (py[0] % pbn.P, py[1] % pbn.P)) == got
    # k >= 2^256: both packages take their Python path; the wrappers take k
    # mod 2^256 alike
    for k in (2**256, 2**256 + 5):
        assert pbn.g1_mul(pbn.G1, k) == jbn.g1_mul(pbn.G1, k) == _py(pbn.g1_mul, pbn.G1, k)
        assert native.bn254_g1_mul_native(pbn.G1, k) == jnative.bn254_g1_mul_native(pbn.G1, k)


def test_bn254_g1_msm_matches_jax_and_python():
    _need_native()
    rng = random.Random(9)
    pts = [pbn.g1_mul(pbn.G1, i + 2) for i in range(4)] + [None]
    ks = [rng.getrandbits(128) for _ in range(4)] + [5]
    want = None
    for q, k in zip(pts, ks):
        want = _py(pbn.g1_add, want, _py(pbn.g1_mul, q, k))
    assert native.bn254_g1_msm_native(pts, ks) == jnative.bn254_g1_msm_native(pts, ks) == want
    assert native.bn254_g1_msm_native([], []) is None


def _fq2_pow(a, e):
    out = pbn.FQ2.one()
    while e:
        if e & 1:
            out = out * a
        a = a * a
        e >>= 1
    return out


def _g2_off_subgroup():
    """A point on the twist curve that is not in the order-r subgroup:
    the first x = k + u with x^3 + b2 a square in FQ2."""
    p = pbn.P
    for k in range(1, 100):
        x = pbn.FQ2([k, 1])
        a = x * x * x + pbn.B2
        a1 = _fq2_pow(a, (p - 3) // 4)
        alpha = a1 * a1 * a
        x0 = a1 * a
        if alpha == pbn.FQ2([p - 1, 0]):
            y = pbn.FQ2([0, 1]) * x0
        else:
            y = _fq2_pow(alpha + pbn.FQ2.one(), (p - 1) // 2) * x0
        if y * y == a:
            return (x, y)
    raise AssertionError("no point found")


def _jax_g2(pt):
    return (jbn.FQ2(list(pt[0].c)), jbn.FQ2(list(pt[1].c)))


def test_bn254_g2_subgroup_matches_jax_and_python():
    _need_native()
    member = pbn.g2_mul(pbn.G2, 12345)
    outsider = _g2_off_subgroup()
    assert pbn.g2_is_on_curve(outsider)
    for pt, want in ((member, True), (outsider, False)):
        coords = (pt[0].c[0], pt[0].c[1], pt[1].c[0], pt[1].c[1])
        assert native.bn254_g2_subgroup_native(*coords) is want
        assert jnative.bn254_g2_subgroup_native(*coords) is want
        assert pbn.g2_in_subgroup(pt) is want
        assert jbn.g2_in_subgroup(_jax_g2(pt)) is want
        assert _py(pbn.g2_in_subgroup, pt) is want
    assert native.bn254_g2_subgroup_native(0, 0, 0, 0) is True   # infinity


def _pairing_cases():
    g1, g2 = pbn.G1, pbn.G2
    neg = (g1[0], pbn.P - g1[1])
    a = 9876543210
    a_p, a_q = pbn.g1_mul(g1, a), pbn.g2_mul(g2, a)
    return [([(g1, g2), (neg, g2)], True),
            ([(a_p, g2), (neg, a_q)], True),
            ([(g1, g2), (g1, g2)], False),
            ([], True),
            ([(None, g2), (g1, None)], True),
            ([(a_p, g2), (neg, a_q), (g1, g2), (neg, g2)], True),    # 4 pairs
            ([(a_p, g2), (neg, a_q), (g1, g2), (g1, g2)], False)]


def test_bn254_pairing_check_matches_jax_and_python():
    _need_native()
    for pairs, want in _pairing_cases():
        wire = [(pt, None if q is None else ((q[0].c[0], q[0].c[1]), (q[1].c[0], q[1].c[1])))
                for pt, q in pairs]
        assert native.bn254_pairing_check_native(wire) is want
        assert jnative.bn254_pairing_check_native(wire) is want
        assert pbn.pairing_check(pairs) is want
        jpairs = [(pt, None if q is None else _jax_g2(q)) for pt, q in pairs]
        assert jbn.pairing_check(jpairs) is want
        if len(pairs) <= 2:
            assert _py(pbn.pairing_check, pairs) is want


# -- the library's build -----------------------------------------------------------

def test_library_builds_into_build_native_and_not_csrc(tmp_path, monkeypatch):
    if shutil.which(native.compiler()) is None:
        pytest.skip("no C compiler: the native library cannot be built")
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    before = sorted((p.name, p.stat().st_mtime_ns) for p in native.CSRC.iterdir())
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    path = native.require_native()
    assert path.parent == tmp_path / "native" and path.exists()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [path.name]
    assert native.keccak256_native(b"abc") == jkeccak._keccak256_py(b"abc")
    assert sorted((p.name, p.stat().st_mtime_ns) for p in native.CSRC.iterdir()) == before


def test_require_native_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native host library is unavailable"):
        native.require_native()
    assert native.keccak256_native(b"") is None
    assert native.secp256k1_double_mul_native(1, 1, *pec.G) is False
    assert native.bn254_g1_add_native(pbn.G1, None) is False
    assert native.bn254_pairing_check_native([]) is None
