"""secp256k1 ECDSA on Python ints: sign, verify and public-key recovery.

Counterpart of ``zkevm_specs_tpu/ops/ecc/secp256k1.py`` (reference:
src/zkevm_specs/util/ec.py:59-117, which delegates to eth_keys): Jacobian
double-and-add over the secp256k1 prime field, G's multiples from a table
of its 4-bit windows, and u1 G + u2 Q summed before the one inversion (the
same points as the JAX module's affine sum, in about 60 % of its time).  The tracer signs with it,
the tx circuit recovers each sender's key with it, and the tx and sig
circuits take their ECDSA verdicts from ``verify_batch``.  ``_double_mul``
and ``verify_batch`` go to the native library (``runtime/native.py``)
where it loads, as in the JAX module.  Everything runs on the host, as in
the JAX package (``circuits/sig.py``): the circuits
constrain the verdict bit, not the curve arithmetic.
"""
from __future__ import annotations

from typing import Optional, Tuple

# curve: y^2 = x^3 + 7 over F_p
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (Gx, Gy)

Point = Optional[Tuple[int, int]]  # None = infinity


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def add(p1: Point, p2: Point) -> Point:
    """Affine addition."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


_J_INF = (0, 1, 0)  # Jacobian infinity (Z == 0)


def _jdouble(p):
    """Jacobian doubling (a = 0 curve): 2M + 5S, no inversion."""
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return _J_INF
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return (X3, Y3, Z3)


def _jadd(p, q):
    """Jacobian addition: 11M + 5S, no inversion."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return _J_INF
        return _jdouble(p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = 2 * H * Z1 * Z2 % P
    return (X3, Y3, Z3)


def _to_affine(acc) -> Point:
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = _inv(Z, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _jmul(p: Point, k: int):
    """k * p in Jacobian coordinates by double-and-add (k already mod N)."""
    acc = _J_INF
    addend = (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = _jadd(acc, addend)
        addend = _jdouble(addend)
        k >>= 1
    return acc


_G_TABLE = []  # _G_TABLE[i][d] = d * 16^i * G (Jacobian, Z = 1), built on first use


def _jmul_g(k: int):
    """k * G in Jacobian coordinates from the fixed-base table of G's
    multiples: one addition a nonzero 4-bit digit of k, no doubling."""
    if not _G_TABLE:
        base = G
        for _ in range(64):
            row, pt = [None], None
            for _d in range(15):
                pt = add(pt, base)
                row.append((pt[0], pt[1], 1))
            _G_TABLE.append(row)
            base = add(pt, base)  # 16 * base
    acc = _J_INF
    i = 0
    while k:
        d = k & 15
        if d:
            acc = _jadd(acc, _G_TABLE[i][d])
        k >>= 4
        i += 1
    return acc


def mul(p: Point, k: int) -> Point:
    """k * p, one field inversion in all (G's multiples from a table)."""
    k %= N
    if p is None or k == 0:
        return None
    return _to_affine(_jmul_g(k) if p == G else _jmul(p, k))


def is_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 7) % P == 0


def sign(msg_hash: int, priv_key: int, k: int) -> Tuple[int, int, int]:
    """Signing with the caller's nonce k.  Returns (v, r, s) with v in
    {0, 1} (the recovery id), plus 2 when R's x is at least N."""
    R = mul(G, k)
    assert R is not None
    r = R[0] % N
    assert r != 0
    s = (_inv(k, N) * (msg_hash + r * priv_key)) % N
    assert s != 0
    v = R[1] & 1
    if R[0] >= N:
        v |= 2
    return v, r, s


def _double_mul(u1: int, u2: int, p: Point) -> Point:
    """u1 * G + u2 * p: by the native library where it loads (the JAX
    module's dispatch), else summed in Jacobian coordinates (one
    inversion)."""
    from ...runtime.native import secp256k1_double_mul_native

    native = secp256k1_double_mul_native(u1, u2, p[0], p[1])
    if native is not False:
        return native
    return _to_affine(_jadd(_jmul_g(u1 % N), _jmul(p, u2 % N)))


def recover(msg_hash: int, v: int, r: int, s: int) -> Point:
    """The public key of a signature; None when it is invalid (eth_keys'
    ``ecdsa_recover``)."""
    if not (1 <= r < N and 1 <= s < N and v in (0, 1, 2, 3)):
        return None
    x = r + N * (v >> 1)
    if x >= P:
        return None
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if (y * y) % P != y_sq:
        return None
    if (y & 1) != (v & 1):
        y = P - y
    r_inv = _inv(r, N)
    # Q = r^-1 (s R - z G)
    u1 = (-msg_hash * r_inv) % N
    u2 = (s * r_inv) % N
    return _double_mul(u1, u2, (x, y))


def verify(msg_hash: int, r: int, s: int, pubkey: Point) -> bool:
    """ECDSA verification (eth_keys' ``ecdsa_verify``)."""
    if pubkey is None or not is_on_curve(pubkey):
        return False
    if not (1 <= r < N and 1 <= s < N):
        return False
    w = _inv(s, N)
    R = _double_mul((msg_hash * w) % N, (r * w) % N, pubkey)
    if R is None:
        return False
    return R[0] % N == r


def verify_batch(rows) -> list:
    """The verdict of each row ``(msg_hash, r, s, pubkey)``, in one call of
    the native library where it loads, else ``verify``'s.  A row whose key
    is None or off the curve is False before any curve arithmetic: the
    native call takes G in its place, and its verdict is masked (the JAX
    module's rule)."""
    from ...runtime.native import secp256k1_verify_batch_native

    usable = [p is not None and is_on_curve(p) for _, _, _, p in rows]
    out = secp256k1_verify_batch_native([(h, r, s, p if ok else G)
                                         for ok, (h, r, s, p) in zip(usable, rows)])
    if out is not None:
        return [ok and v for ok, v in zip(usable, out)]
    return [ok and verify(h, r, s, p) for ok, (h, r, s, p) in zip(usable, rows)]


def pubkey_bytes(pubkey: Point) -> bytes:
    """64-byte uncompressed encoding (x || y, big-endian)."""
    assert pubkey is not None
    return pubkey[0].to_bytes(32, "big") + pubkey[1].to_bytes(32, "big")


def priv_to_pub(priv_key: int) -> Point:
    return mul(G, priv_key)
