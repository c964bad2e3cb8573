"""BN254 (alt_bn128) curve arithmetic on Python ints, with the optimal-ate
pairing.

Counterpart of ``zkevm_specs_tpu/ops/ecc/bn254.py`` (reference:
src/zkevm_specs/util/ec.py:120-199, which delegates to py_ecc): the base
field, the FQ2/FQ12 tower, G1/G2 addition, scalar multiplication, on-curve
and subgroup tests, the Miller loop over the 6t+2 ate count and the naive
final exponentiation.  G1's scalar multiplication runs in Jacobian
coordinates (one inversion at the end) and FQ2's inverse by its conjugate;
both give the affine points and inverses of the JAX module's formulas.
The ecc circuit (precompiles 0x06-0x08) and the tracer call it; everything
runs on the host, as in the JAX package, whose circuit constrains the
host's verdict bit, not the curve arithmetic.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# the base field and the curve order
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

G1 = (1, 2)


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


# -- the polynomial extension fields (py_ecc's tower) --------------------------

class Poly:
    """An element of F_p[x]/(modulus), coefficients little-endian."""

    __slots__ = ("c",)
    DEGREE = 0
    MOD_COEFFS: Tuple[int, ...] = ()

    def __init__(self, coeffs):
        assert len(coeffs) == self.DEGREE
        self.c = [x % P for x in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.DEGREE - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.DEGREE)

    def __eq__(self, other):
        return self.c == other.c

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.c, other.c)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.c, other.c)])

    def __neg__(self):
        return type(self)([-a for a in self.c])

    def scalar_mul(self, k: int):
        return type(self)([a * k for a in self.c])

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scalar_mul(other)
        d = self.DEGREE
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.c):
            if a == 0:
                continue
            for j, b in enumerate(other.c):
                prod[i + j] += a * b
        # reduce by x^d = -MOD_COEFFS
        for i in range(2 * d - 2, d - 1, -1):
            top = prod[i]
            if top == 0:
                continue
            prod[i] = 0
            for j, m in enumerate(self.MOD_COEFFS):
                if m:
                    prod[i - d + j] -= top * m
        return type(self)(prod[:d])

    def inv(self):
        """The inverse by the extended Euclidean algorithm over F_p[x]."""
        d = self.DEGREE
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.c) + [0]
        high = list(self.MOD_COEFFS) + [1]

        def deg(poly):
            for i in range(len(poly) - 1, -1, -1):
                if poly[i]:
                    return i
            return 0

        def poly_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            out = [0] * len(a)
            inv_b = _inv(b[degb])
            for i in range(dega - degb, -1, -1):
                out[i] = temp[degb + i] * inv_b % P
                for j in range(degb + 1):
                    temp[i + j] -= out[i] * b[j]
                temp = [x % P for x in temp]
            return [x % P for x in out]

        while deg(low):
            q = poly_div(high, low)
            nm, new = list(hm), list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * q[j]
                    new[i + j] -= low[i] * q[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = _inv(low[0])
        return type(self)([x * inv_low0 for x in lm[:d]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self.scalar_mul(_inv(other))
        return self * other.inv()

    def is_zero(self):
        return all(x == 0 for x in self.c)

    def __repr__(self):
        return f"{type(self).__name__}({self.c})"


class FQ2(Poly):
    DEGREE = 2
    MOD_COEFFS = (1, 0)  # u^2 = -1

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scalar_mul(other)
        a0, a1 = self.c
        b0, b1 = other.c
        return FQ2([a0 * b0 - a1 * b1, a0 * b1 + a1 * b0])

    def inv(self):
        """(a - b u) / (a^2 + b^2): the unique inverse the generic one gives."""
        a, b = self.c
        t = _inv((a * a + b * b) % P)
        return FQ2([a * t, -b * t])


class FQ12(Poly):
    DEGREE = 12
    MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 - 18 w^6 + 82


# -- G1 (over F_p) -------------------------------------------------------------

PointG1 = Optional[Tuple[int, int]]


def g1_is_on_curve(pt: PointG1) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g1_add(p1: PointG1, p2: PointG1) -> PointG1:
    """Affine addition (the points need not be on the curve: the formulas
    are the JAX module's)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _jdouble(p):
    """Jacobian doubling (a = 0): no inversion."""
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return (0, 1, 0)
    A = X1 * X1 % P
    Bs = Y1 * Y1 % P
    C = Bs * Bs % P
    D = 2 * ((X1 + Bs) * (X1 + Bs) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    return (X3, Y3, 2 * Y1 * Z1 % P)


def _jadd(p, q):
    """Jacobian addition: no inversion."""
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
        return _jdouble(p) if S1 == S2 else (0, 1, 0)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def g1_mul(pt: PointG1, k: int) -> PointG1:
    """k * pt by double-and-add: in Jacobian coordinates for a point on the
    curve with reduced coordinates, else (the precompile's invalid inputs)
    by the JAX module's affine loop, whose results such points keep."""
    if pt is None or k == 0:
        return None
    if not (pt[0] < P and pt[1] < P and g1_is_on_curve(pt)):
        result: PointG1 = None
        addend = pt
        while k:
            if k & 1:
                result = g1_add(result, addend)
            addend = g1_add(addend, addend)
            k >>= 1
        return result
    acc, addend = (0, 1, 0), (pt[0] % P, pt[1] % P, 1)
    while k:
        if k & 1:
            acc = _jadd(acc, addend)
        addend = _jdouble(addend)
        k >>= 1
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = _inv(Z)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


# -- G2 (over F_p2) ------------------------------------------------------------

PointG2 = Optional[Tuple[FQ2, FQ2]]

B2 = FQ2([3, 0]) / FQ2([9, 1])  # b / (9 + u)

G2: PointG2 = (
    FQ2([
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ]),
    FQ2([
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ]),
)


def g2_is_on_curve(pt: PointG2) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B2).is_zero()


def g2_add(p1: PointG2, p2: PointG2) -> PointG2:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1 * x1).scalar_mul(3) / (y1.scalar_mul(2))
    else:
        lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _g2_jdouble(p):
    """Jacobian doubling over F_p2 (a = 0): no inversion."""
    X1, Y1, Z1 = p
    if Z1.is_zero() or Y1.is_zero():
        return None
    A = X1 * X1
    Bs = Y1 * Y1
    C = Bs * Bs
    t = X1 + Bs
    D = (t * t - A - C).scalar_mul(2)
    E = A.scalar_mul(3)
    X3 = E * E - D.scalar_mul(2)
    Y3 = E * (D - X3) - C.scalar_mul(8)
    return (X3, Y3, (Y1 * Z1).scalar_mul(2))


def _g2_jadd(p, q):
    """Jacobian addition over F_p2: no inversion (None: infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1
    Z2Z2 = Z2 * Z2
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        return _g2_jdouble(p) if S1 == S2 else None
    H = U2 - U1
    I = (H * H).scalar_mul(4)
    J = H * I
    r = (S2 - S1).scalar_mul(2)
    V = U1 * I
    X3 = r * r - J - V.scalar_mul(2)
    Y3 = r * (V - X3) - (S1 * J).scalar_mul(2)
    Z3 = (Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2
    return (X3, Y3, Z3 * H)


def g2_mul(pt: PointG2, k: int) -> PointG2:
    """k * pt by double-and-add: in Jacobian coordinates (one inversion)
    for a point on the curve, else by the JAX module's affine loop, whose
    results an off-curve point keeps."""
    if pt is not None and g2_is_on_curve(pt):
        acc, addend = None, (pt[0], pt[1], FQ2.one())
        while k:
            if k & 1:
                acc = _g2_jadd(acc, addend)
            addend = _g2_jdouble(addend)
            if addend is None:
                break
            k >>= 1
        if acc is None:
            return None
        X, Y, Z = acc
        zi = Z.inv()
        zi2 = zi * zi
        return (X * zi2, Y * zi2 * zi)
    result: PointG2 = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


def g2_in_subgroup(pt: PointG2) -> bool:
    """Membership of the order-r subgroup (the ecPairing precompile's)."""
    return g2_mul(pt, R) is None


# -- the pairing ----------------------------------------------------------------

W = FQ12([0, 1] + [0] * 10)
W2 = W * W
W3 = W2 * W


def _twist(pt: PointG2):
    """A G2 point mapped into E(F_p12) (the untwist)."""
    if pt is None:
        return None
    x, y = pt
    # coefficients in the 1, u basis, embedded through w^2 and w^3
    xc = [x.c[0] - 9 * x.c[1], x.c[1]]
    yc = [y.c[0] - 9 * y.c[1], y.c[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * W2, ny * W3)


def _cast_g1(pt: PointG1):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1).scalar_mul(3) / y1.scalar_mul(2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _fq12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1 * x1).scalar_mul(3) / y1.scalar_mul(2)
    else:
        lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def fq12_pow(x: FQ12, n: int) -> FQ12:
    result = FQ12.one()
    base = x
    while n:
        if n & 1:
            result = result * base
        base = base * base
        n >>= 1
    return result


_FROB: List[FQ12] = []


def frobenius(x: FQ12) -> FQ12:
    """x^p: the coefficients are in F_p, so x^p = sum c_i (w^p)^i, a linear
    map whose 12 images of w^i are computed once."""
    if not _FROB:
        wp = fq12_pow(W, P)
        acc = FQ12.one()
        for _ in range(12):
            _FROB.append(acc)
            acc = acc * wp
    out = [0] * 12
    for c, img in zip(x.c, _FROB):
        if c:
            for j, v in enumerate(img.c):
                out[j] += c * v
    return FQ12(out)


def _line_and_add(p1, p2, t):
    """(_linefunc(p1, p2, t), _fq12_add(p1, p2)) with one division where
    the two share the slope (a chord, or a tangent off the x axis)."""
    x1, y1 = p1
    x2, y2 = p2
    if not (x1 == x2):
        lam = (y2 - y1) / (x2 - x1)
    elif y1 == y2 and not (y1 + y2).is_zero():
        lam = (x1 * x1).scalar_mul(3) / y1.scalar_mul(2)
    else:
        return _linefunc(p1, p2, t), _fq12_add(p1, p2)
    xt, yt = t
    x3 = lam * lam - x1 - x2
    return lam * (xt - x1) - (yt - y1), (x3, lam * (x1 - x3) - y1)


def _miller_loop(Q, Pt) -> FQ12:
    if Q is None or Pt is None:
        return FQ12.one()
    Rq = Q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        line, Rq = _line_and_add(Rq, Rq, Pt)
        f = f * f * line
        if ATE_LOOP_COUNT & (2**i):
            line, Rq = _line_and_add(Rq, Q, Pt)
            f = f * line
    # the Frobenius terms
    Q1 = (frobenius(Q[0]), frobenius(Q[1]))
    nQ2 = (frobenius(Q1[0]), -frobenius(Q1[1]))
    line, Rq = _line_and_add(Rq, Q1, Pt)
    f = f * line
    return f * _linefunc(Rq, nQ2, Pt)


# (p^12 - 1) / r = (p^6 - 1)(p^2 + 1) * (p^4 - p^2 + 1) / r
_HARD_EXPONENT, _rem = divmod(P**4 - P**2 + 1, R)
assert _rem == 0


def final_exponentiate(f: FQ12) -> FQ12:
    """f^((p^12 - 1) / r): the easy part by Frobenius maps and one
    inversion, the hard part (p^4 - p^2 + 1) / r by squaring."""
    g = f
    for _ in range(6):
        g = frobenius(g)
    g = g * f.inv()                              # f^(p^6 - 1)
    g = frobenius(frobenius(g)) * g              # ^(p^2 + 1)
    return fq12_pow(g, _HARD_EXPONENT)


def pairing(Q: PointG2, Pt: PointG1) -> FQ12:
    """e(P, Q) before the final exponentiation (compose products first)."""
    assert g1_is_on_curve(Pt)
    assert g2_is_on_curve(Q)
    return _miller_loop(_twist(Q), _cast_g1(Pt))


def pairing_check(pairs: List[Tuple[PointG1, PointG2]]) -> bool:
    """prod e(P_i, Q_i) == 1: the ecPairing precompile's predicate."""
    f = FQ12.one()
    for Pt, Q in pairs:
        f = f * pairing(Q, Pt)
    return final_exponentiate(f) == FQ12.one()
