"""BLS12-381 aggregate signatures, pure Python.

Fills the reference's open trust boundary: `src/proofs/trust/mod.rs:58,72`
leaves F3 certificate signature verification as TODOs and `src/cert.rs:52-64`
is a placeholder. This module provides the minimum-BLS scheme go-f3 style
certificates need: G1 public keys (48-byte compressed), G2 signatures
(96-byte compressed), same-message aggregation (every signer signs the gpbft
payload), verified with two pairings.

Performance stance: certificate verification runs ONCE per proof bundle, so
this is deliberately straightforward big-int Python (a pairing is ~0.5 s)
rather than a native or vectorized path — the hot loops of this framework
are elsewhere.

Implementation notes (the pairing is the canonical optimal ate, and
hash-to-G2 is RFC 9380 SSWU; NOTES_r05.md records the offline
verification):

* Field tower: Fp2 = Fp[u]/(u²+1), Fp6 = Fp2[v]/(v³-ξ) with ξ = u+1,
  Fp12 = Fp6[w]/(w²-v). CANONICAL optimal-ate: Miller loop over |x| (the
  BLS parameter 0xd201000000010000) with affine line functions, the
  negative-x conjugation of the Miller value, and final exponentiation by
  the integer (p¹²-1)/r.
* Hash-to-G2 is RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_: hash_to_field
  (expand_message_xmd/SHA-256, L=64, m=2, count=2), simplified SWU on the
  3-isogenous curve E2', the 3-isogeny back to E2 (constants vendored from
  RFC 9380 App. E.3), and Budroni–Pintore cofactor clearing through the ψ
  endomorphism (whose constants are DERIVED at import, not vendored).
  Offline verification (tests/test_bls_sswu.py): SSWU outputs satisfy
  E2', the isogeny maps onto E2 and is a group homomorphism whose kernel
  x-coordinates are 3-division-polynomial roots of E2', outputs are
  r-torsion, and the ψ-clearing equals the spec's h_eff scalar multiple —
  two independently-derived clearings agreeing. Byte-level RFC vectors
  remain unfetchable in this zero-egress environment; these checks pin
  the construction up to the RFC's kernel choice.
* DSTs default to the BLS POP ciphersuite strings
  (``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_`` /
  ``BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_``) — the suite go-f3's
  blssig verifier uses.
* The G2 cofactor is derived at import from p, r and the G1 cofactor via
  the CM/twist order relations and checked (twist order divisible by r,
  cleared points r-torsion) rather than hard-coded.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

__all__ = [
    "PRIME",
    "CURVE_ORDER",
    "g1_generator",
    "g2_generator",
    "sk_to_pk",
    "sign",
    "verify",
    "aggregate_signatures",
    "aggregate_pubkeys",
    "verify_aggregate_same_message",
    "pop_prove",
    "pop_verify",
    "g1_compress",
    "g1_decompress",
    "g2_compress",
    "g2_decompress",
    "hash_to_g2",
    "pairing",
]

# --- parameters --------------------------------------------------------------

PRIME = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
CURVE_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_BLS_X = 0xD201000000010000  # |x|; x itself is negative
_H1 = 0x396C8C005555E1568C00AAAB0000AAAB  # G1 cofactor

_P = PRIME
_B = 4  # E: y^2 = x^3 + 4

_G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
_G2 = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# --- Fp ---------------------------------------------------------------------


def _inv(a: int) -> int:
    return pow(a, _P - 2, _P)


# --- Fp2 = Fp[u]/(u^2+1): (c0, c1) ------------------------------------------


def _f2_add(a, b):
    return ((a[0] + b[0]) % _P, (a[1] + b[1]) % _P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % _P, (a[1] - b[1]) % _P)


def _f2_neg(a):
    return ((-a[0]) % _P, (-a[1]) % _P)


def _f2_mul(a, b):
    a0b0 = a[0] * b[0]
    a1b1 = a[1] * b[1]
    return ((a0b0 - a1b1) % _P, ((a[0] + a[1]) * (b[0] + b[1]) - a0b0 - a1b1) % _P)


def _f2_sqr(a):
    return _f2_mul(a, a)


def _f2_scalar(a, k: int):
    return ((a[0] * k) % _P, (a[1] * k) % _P)


def _f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % _P
    ninv = _inv(norm)
    return ((a[0] * ninv) % _P, ((-a[1]) * ninv) % _P)


_F2_ZERO = (0, 0)
_F2_ONE = (1, 0)
_XI = (1, 1)  # u + 1


def _f2_mul_xi(a):
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % _P, (a[0] + a[1]) % _P)


def _f2_is_larger(y) -> bool:
    """Lexicographic 'larger y' predicate over Fp2 (c1 first, then c0) —
    the single source of the compressed-point sign convention for
    compress, decompress, and hash-to-curve."""
    return y[1] > (_P - 1) // 2 or (y[1] == 0 and y[0] > (_P - 1) // 2)


def _f2_sqrt(a):
    """Square root in Fp2 by the complex method (p ≡ 3 mod 4); None if
    ``a`` is not a square."""
    c0, c1 = a
    if c1 == 0:
        s = pow(c0, (_P + 1) // 4, _P)
        if s * s % _P == c0:
            return (s, 0)
        # c0 is a non-residue: sqrt is purely imaginary, (t u)^2 = -t^2
        t = pow((-c0) % _P, (_P + 1) // 4, _P)
        if (t * t) % _P == (-c0) % _P:
            return (0, t)
        return None
    norm = (c0 * c0 + c1 * c1) % _P
    s = pow(norm, (_P + 1) // 4, _P)
    if (s * s) % _P != norm:
        return None
    inv2 = _inv(2)
    for sign in (s, (-s) % _P):
        re2 = (c0 + sign) * inv2 % _P
        re = pow(re2, (_P + 1) // 4, _P)
        if (re * re) % _P != re2 or re == 0:
            continue
        im = c1 * _inv(2 * re % _P) % _P
        cand = (re, im)
        if _f2_sqr(cand) == (c0 % _P, c1 % _P):
            return cand
    return None


# --- Fp6 = Fp2[v]/(v^3 - xi): (c0, c1, c2) ----------------------------------


def _f6_add(a, b):
    return (_f2_add(a[0], b[0]), _f2_add(a[1], b[1]), _f2_add(a[2], b[2]))


def _f6_sub(a, b):
    return (_f2_sub(a[0], b[0]), _f2_sub(a[1], b[1]), _f2_sub(a[2], b[2]))


def _f6_neg(a):
    return (_f2_neg(a[0]), _f2_neg(a[1]), _f2_neg(a[2]))


def _f6_mul(a, b):
    t0 = _f2_mul(a[0], b[0])
    t1 = _f2_mul(a[1], b[1])
    t2 = _f2_mul(a[2], b[2])
    c0 = _f2_add(t0, _f2_mul_xi(_f2_sub(_f2_mul(_f2_add(a[1], a[2]), _f2_add(b[1], b[2])), _f2_add(t1, t2))))
    c1 = _f2_add(
        _f2_sub(_f2_mul(_f2_add(a[0], a[1]), _f2_add(b[0], b[1])), _f2_add(t0, t1)),
        _f2_mul_xi(t2),
    )
    c2 = _f2_add(_f2_sub(_f2_mul(_f2_add(a[0], a[2]), _f2_add(b[0], b[2])), _f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _f6_mul_v(a):
    # v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
    return (_f2_mul_xi(a[2]), a[0], a[1])


def _f6_inv(a):
    c0 = _f2_sub(_f2_sqr(a[0]), _f2_mul_xi(_f2_mul(a[1], a[2])))
    c1 = _f2_sub(_f2_mul_xi(_f2_sqr(a[2])), _f2_mul(a[0], a[1]))
    c2 = _f2_sub(_f2_sqr(a[1]), _f2_mul(a[0], a[2]))
    t = _f2_add(
        _f2_mul_xi(_f2_add(_f2_mul(a[2], c1), _f2_mul(a[1], c2))), _f2_mul(a[0], c0)
    )
    tinv = _f2_inv(t)
    return (_f2_mul(c0, tinv), _f2_mul(c1, tinv), _f2_mul(c2, tinv))


_F6_ZERO = (_F2_ZERO, _F2_ZERO, _F2_ZERO)
_F6_ONE = (_F2_ONE, _F2_ZERO, _F2_ZERO)


# --- Fp12 = Fp6[w]/(w^2 - v): (c0, c1) --------------------------------------


def _f12_add(a, b):
    return (_f6_add(a[0], b[0]), _f6_add(a[1], b[1]))


def _f12_sub(a, b):
    return (_f6_sub(a[0], b[0]), _f6_sub(a[1], b[1]))


def _f12_mul(a, b):
    t0 = _f6_mul(a[0], b[0])
    t1 = _f6_mul(a[1], b[1])
    c0 = _f6_add(t0, _f6_mul_v(t1))
    c1 = _f6_sub(
        _f6_mul(_f6_add(a[0], a[1]), _f6_add(b[0], b[1])), _f6_add(t0, t1)
    )
    return (c0, c1)


def _f12_sqr(a):
    return _f12_mul(a, a)


def _f12_inv(a):
    t = _f6_inv(_f6_sub(_f6_mul(a[0], a[0]), _f6_mul_v(_f6_mul(a[1], a[1]))))
    return (_f6_mul(a[0], t), _f6_neg(_f6_mul(a[1], t)))


def _f12_pow(a, e: int):
    out = _F12_ONE
    base = a
    while e:
        if e & 1:
            out = _f12_mul(out, base)
        base = _f12_sqr(base)
        e >>= 1
    return out


_F12_ZERO = (_F6_ZERO, _F6_ZERO)
_F12_ONE = (_F6_ONE, _F6_ZERO)


def _fp_to_f12(x: int):
    return (((x % _P, 0), _F2_ZERO, _F2_ZERO), _F6_ZERO)


def _f2_to_f12(x):
    return ((x, _F2_ZERO, _F2_ZERO), _F6_ZERO)


# w = (0, 1) in Fp12-over-Fp6; w^2 = v
_W = (_F6_ZERO, _F6_ONE)
_W2 = (( _F2_ZERO, _F2_ONE, _F2_ZERO), _F6_ZERO)  # v
_W3 = (_F6_ZERO, (_F2_ZERO, _F2_ONE, _F2_ZERO))  # v w
_W2_INV = _f12_inv(_W2)
_W3_INV = _f12_inv(_W3)


# --- curve arithmetic (generic affine over any of the fields) ---------------


class _Ops:
    """Field operation bundle so one affine point implementation serves
    Fp (G1), Fp2 (G2 twist) and Fp12 (pairing) points."""

    def __init__(self, add, sub, neg, mul, sqr, inv, zero, one, scalar):
        self.add, self.sub, self.neg = add, sub, neg
        self.mul, self.sqr, self.inv = mul, sqr, inv
        self.zero, self.one, self.scalar = zero, one, scalar


_OPS1 = _Ops(
    lambda a, b: (a + b) % _P,
    lambda a, b: (a - b) % _P,
    lambda a: (-a) % _P,
    lambda a, b: (a * b) % _P,
    lambda a: (a * a) % _P,
    _inv,
    0,
    1,
    lambda a, k: (a * k) % _P,
)
_OPS2 = _Ops(_f2_add, _f2_sub, _f2_neg, _f2_mul, _f2_sqr, _f2_inv, _F2_ZERO, _F2_ONE, _f2_scalar)
_OPS12 = _Ops(
    _f12_add,
    _f12_sub,
    lambda a: (_f6_neg(a[0]), _f6_neg(a[1])),
    _f12_mul,
    _f12_sqr,
    _f12_inv,
    _F12_ZERO,
    _F12_ONE,
    lambda a, k: _f12_mul(a, _fp_to_f12(k)),
)

# points are (x, y) tuples or None for infinity


def _pt_double(ops: _Ops, pt):
    if pt is None:
        return None
    x, y = pt
    if y == ops.zero:
        return None
    lam = ops.mul(ops.scalar(ops.sqr(x), 3), ops.inv(ops.scalar(y, 2)))
    x3 = ops.sub(ops.sqr(lam), ops.scalar(x, 2))
    y3 = ops.sub(ops.mul(lam, ops.sub(x, x3)), y)
    return (x3, y3)


def _pt_add(ops: _Ops, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _pt_double(ops, p)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sqr(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_neg(ops: _Ops, p):
    return None if p is None else (p[0], ops.neg(p[1]))


def _pt_mul(ops: _Ops, p, k: int):
    if k < 0:
        return _pt_mul(ops, _pt_neg(ops, p), -k)
    out = None
    add = p
    while k:
        if k & 1:
            out = _pt_add(ops, out, add)
        add = _pt_double(ops, add)
        k >>= 1
    return out


def _on_g1(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + _B)) % _P == 0


_B2 = _f2_scalar(_XI, _B)  # twist constant: 4(u+1)


def _on_g2_twist(p) -> bool:
    if p is None:
        return True
    x, y = p
    return _f2_sub(_f2_sqr(y), _f2_add(_f2_mul(_f2_sqr(x), x), _B2)) == _F2_ZERO


# --- derived G2 cofactor ----------------------------------------------------


def _derive_h2() -> int:
    """G2 cofactor from first principles (see module docstring): compute
    the two sextic-twist orders from the Frobenius trace and pick the one
    divisible by r; sanity-checked at import by the subgroup tests below."""
    n1 = _H1 * CURVE_ORDER
    t1 = _P + 1 - n1
    t2 = t1 * t1 - 2 * _P  # trace over Fp2
    # CM: t2^2 - 4 p^2 = -3 f^2
    f2 = (4 * _P * _P - t2 * t2) // 3
    f = _isqrt(f2)
    assert f * f == f2, "CM discriminant not a perfect square"
    for n in (
        _P * _P + 1 - (t2 + 3 * f) // 2,
        _P * _P + 1 - (t2 - 3 * f) // 2,
    ):
        if n % CURVE_ORDER == 0:
            return n // CURVE_ORDER
    raise AssertionError("no sextic twist order divisible by r")


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


_H2 = _derive_h2()


# --- pairing ----------------------------------------------------------------


def _untwist(q):
    """E'(Fp2) → E(Fp12): (x', y') ↦ (x'·w⁻², y'·w⁻³)."""
    if q is None:
        return None
    return (_f12_mul(_f2_to_f12(q[0]), _W2_INV), _f12_mul(_f2_to_f12(q[1]), _W3_INV))


def _line(ops: _Ops, p1, p2, at):
    """Evaluate the line through p1, p2 (or the tangent when equal) at
    ``at`` — all in E(Fp12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = at
    if x1 != x2:
        lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    elif y1 == y2:
        lam = ops.mul(ops.scalar(ops.sqr(x1), 3), ops.inv(ops.scalar(y1, 2)))
    else:  # vertical
        return ops.sub(xt, x1)
    return ops.sub(ops.sub(yt, y1), ops.mul(lam, ops.sub(xt, x1)))


_FINAL_EXP = (_P**12 - 1) // CURVE_ORDER


def pairing(p_g1, q_g2):
    """The canonical optimal-ate bilinear map G1 × G2 → Fp12 (Miller loop
    over |x| with the negative-x conjugation, final exponentiation by the
    integer (p¹²-1)/r).

    ``p_g1``: affine point on E(Fp) in the r-torsion; ``q_g2``: affine
    point on the twist E'(Fp2) in the r-torsion. Returns an Fp12 element.
    """
    if p_g1 is None or q_g2 is None:
        return _F12_ONE
    ops = _OPS12
    p12 = (_fp_to_f12(p_g1[0]), _fp_to_f12(p_g1[1]))
    q12 = _untwist(q_g2)
    t = q12
    f = _F12_ONE
    for bit in bin(_BLS_X)[3:]:
        f = _f12_mul(_f12_sqr(f), _line(ops, t, t, p12))
        t = _pt_double(ops, t)
        if bit == "1":
            f = _f12_mul(f, _line(ops, t, q12, p12))
            t = _pt_add(ops, t, q12)
    # x is NEGATIVE: the canonical optimal ate conjugates the Miller value
    # (f_{x} = conj(f_{|x|}) up to vertical lines the final exponentiation
    # kills). conj = p⁶-Frobenius: (c0, c1) → (c0, -c1) over Fp6.
    f = (f[0], _f6_neg(f[1]))
    return _f12_pow(f, _FINAL_EXP)


# --- point (de)compression (ZCash BLS12-381 format) -------------------------


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0] + [0] * 47)
    x, y = p
    flags = 0x80 | (0x20 if y > (_P - 1) // 2 else 0)
    raw = x.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g1_decompress(data: bytes):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= _P:
        raise ValueError("G1 x out of range")
    y2 = (x * x * x + _B) % _P
    y = pow(y2, (_P + 1) // 4, _P)
    if (y * y) % _P != y2:
        raise ValueError("G1 x is not on the curve")
    if bool(flags & 0x20) != (y > (_P - 1) // 2):
        y = (-y) % _P
    point = (x, y)
    if _pt_mul(_OPS1, point, CURVE_ORDER) is not None:
        raise ValueError("G1 point not in the r-torsion subgroup")
    return point


def g2_compress(q) -> bytes:
    if q is None:
        return bytes([0xC0] + [0] * 95)
    (x0, x1), y = q
    flags = 0x80 | (0x20 if _f2_is_larger(y) else 0)
    raw = x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g2_decompress(data: bytes):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= _P or x1 >= _P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y2 = _f2_add(_f2_mul(_f2_sqr(x), x), _B2)
    y = _f2_sqrt(y2)
    if y is None:
        raise ValueError("G2 x is not on the twist")
    if bool(flags & 0x20) != _f2_is_larger(y):
        y = _f2_neg(y)
    point = (x, y)
    if _pt_mul(_OPS2, point, CURVE_ORDER) is not None:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return point


# --- hash to G2 --------------------------------------------------------------

# The BLS proof-of-possession ciphersuite DSTs (RFC 9380 / draft-bls-sig) —
# the suite go-f3's blssig verifier uses, making signatures interoperable.
DEFAULT_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


def _expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        raise ValueError("DST too long")
    h = hashlib.sha256
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (length + b_in_bytes - 1) // b_in_bytes
    if ell > 255:
        raise ValueError("expand_message_xmd output too long")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b = length.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    out = b""
    b_prev = h(b0 + b"\x01" + dst_prime).digest()
    out += b_prev
    for i in range(2, ell + 1):
        b_prev = h(bytes(a ^ b for a, b in zip(b0, b_prev)) + bytes([i]) + dst_prime).digest()
        out += b_prev
    return out[:length]


# --- RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_ -------------------------------
#
# hash_to_field → simplified SWU on the 3-isogenous curve E2' → 3-isogeny
# back to E2 → Budroni–Pintore cofactor clearing via the ψ endomorphism.
# The SSWU/isogeny constants are vendored from RFC 9380 §8.8.2 / App. E.3;
# tests/test_bls_sswu.py re-derives their load-bearing properties offline
# (E2' is 3-isogenous to E2, the map is a homomorphism landing on E2, its
# kernel x-coordinate is a 3-division-polynomial root, outputs are
# r-torsion, and the ψ-based clearing equals the spec's h_eff scalar).

# E2': y² = x³ + A'x + B' over Fp2 — the SSWU target curve
_SSWU_A = (0, 240)
_SSWU_B = (1012, 1012)
_SSWU_Z = ((-2) % _P, (-1) % _P)  # Z = -(2 + I)

# 3-isogeny E2' → E2, x = x_num/x_den, y = y' · y_num/y_den (App. E.3)
_ISO3_X_NUM = (
    (
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    (
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    (
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
)
_ISO3_X_DEN = (  # x_den = x'² + k_(2,1)·x' + k_(2,0)
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    (
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
)
_ISO3_Y_NUM = (
    (
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    (
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    (
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
)
_ISO3_Y_DEN = (  # y_den = x'³ + k_(4,2)·x'² + k_(4,1)·x' + k_(4,0)
    (
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    (
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
)


def _f2_is_square(a) -> bool:
    """Quadratic-residue test via the norm map: a ∈ Fp2 is a square iff
    N(a) = a·ā = c0²+c1² is a square in Fp (N(a)^((p-1)/2) = a^((p²-1)/2))."""
    if a == _F2_ZERO:
        return True
    norm = (a[0] * a[0] + a[1] * a[1]) % _P
    return pow(norm, (_P - 1) // 2, _P) == 1


def _f2_sgn0(a) -> int:
    """RFC 9380 §4.1 sgn0 for Fp2 (m=2)."""
    sign_0 = a[0] & 1
    zero_0 = a[0] == 0
    return sign_0 | (zero_0 & (a[1] & 1))


_SSWU_NEG_B_OVER_A = None  # (-B/A, B/(Z·A)) — computed on first map call


def _sswu_g2(u):
    """Simplified SWU map Fp2 → E2' (RFC 9380 §6.6.2). Output is on E2'
    (y² = x³ + A'x + B'), deterministic in u."""
    global _SSWU_NEG_B_OVER_A
    A, B, Z = _SSWU_A, _SSWU_B, _SSWU_Z
    if _SSWU_NEG_B_OVER_A is None:
        _SSWU_NEG_B_OVER_A = (
            _f2_mul(_f2_neg(B), _f2_inv(A)),
            _f2_mul(B, _f2_inv(_f2_mul(Z, A))),
        )
    u2 = _f2_sqr(u)
    zu2 = _f2_mul(Z, u2)
    tv1 = _f2_add(_f2_sqr(zu2), zu2)  # Z²u⁴ + Zu²
    if tv1 == _F2_ZERO:
        x1 = _SSWU_NEG_B_OVER_A[1]
    else:
        x1 = _f2_mul(_SSWU_NEG_B_OVER_A[0], _f2_add(_F2_ONE, _f2_inv(tv1)))
    gx1 = _f2_add(_f2_add(_f2_mul(_f2_sqr(x1), x1), _f2_mul(A, x1)), B)
    if _f2_is_square(gx1):
        x, y = x1, _f2_sqrt(gx1)
    else:
        x2 = _f2_mul(zu2, x1)
        gx2 = _f2_add(_f2_add(_f2_mul(_f2_sqr(x2), x2), _f2_mul(A, x2)), B)
        x, y = x2, _f2_sqrt(gx2)
    assert y is not None, "SSWU: no root on either candidate (unreachable)"
    if _f2_sgn0(u) != _f2_sgn0(y):
        y = _f2_neg(y)
    return x, y


def _iso3_eval(coeffs, x):
    acc = _F2_ZERO
    for k in reversed(coeffs):
        acc = _f2_add(_f2_mul(acc, x), k)
    return acc


def _iso3_map(p):
    """The 3-isogeny E2' → E2 (rational map from the vendored table).
    Denominator zeros map to the point at infinity (the isogeny kernel)."""
    x, y = p
    x_den = _iso3_eval((*_ISO3_X_DEN, _F2_ONE), x)
    y_den = _iso3_eval((*_ISO3_Y_DEN, _F2_ONE), x)
    if x_den == _F2_ZERO or y_den == _F2_ZERO:
        return None
    x_out = _f2_mul(_iso3_eval(_ISO3_X_NUM, x), _f2_inv(x_den))
    y_out = _f2_mul(_f2_mul(y, _iso3_eval(_ISO3_Y_NUM, x)), _f2_inv(y_den))
    return x_out, y_out


# ψ: the untwist-Frobenius-twist endomorphism of E2. Its two Fp2 constants
# are DERIVED at import (no vendored values): candidates are powers of
# 1/ξ, selected by requiring ψ to (a) map E2 to E2 and (b) act on G2 as
# multiplication by the Frobenius eigenvalue t-1 = x (checked on the
# generator). Used by the Budroni–Pintore cofactor clearing.
def _derive_psi_constants():
    exp_x = (_P - 1) // 3
    exp_y = (_P - 1) // 2
    xi = (1, 1)
    base_x = _f2_pow(xi, exp_x)
    base_y = _f2_pow(xi, exp_y)
    candidates_x = (base_x, _f2_inv(base_x))
    candidates_y = (base_y, _f2_inv(base_y), _f2_neg(base_y), _f2_neg(_f2_inv(base_y)))
    gen = _G2
    eigen = _pt_mul(_OPS2, gen, (-_BLS_X) % CURVE_ORDER)  # [x]gen, x negative
    for cx in candidates_x:
        for cy in candidates_y:
            q = (_f2_mul(cx, _f2_conj(gen[0])), _f2_mul(cy, _f2_conj(gen[1])))
            if not _on_g2_twist(q):
                continue
            if q == eigen:
                return cx, cy
    raise AssertionError("psi constant derivation failed")


def _f2_conj(a):
    return (a[0], (-a[1]) % _P)


def _f2_pow(a, e: int):
    out = _F2_ONE
    base = a
    while e:
        if e & 1:
            out = _f2_mul(out, base)
        base = _f2_sqr(base)
        e >>= 1
    return out


_PSI_CX, _PSI_CY = None, None  # derived lazily (first hash/clearing call)


def _psi(p):
    global _PSI_CX, _PSI_CY
    if _PSI_CX is None:
        _PSI_CX, _PSI_CY = _derive_psi_constants()
    if p is None:
        return None
    return (_f2_mul(_PSI_CX, _f2_conj(p[0])), _f2_mul(_PSI_CY, _f2_conj(p[1])))


def clear_cofactor_g2(p):
    """Budroni–Pintore fast cofactor clearing for G2 (RFC 9380 App. G.3):
    [h_eff]P computed as [x²-x-1]P + [x-1]ψ(P) + ψ²([2]P), x the (negative)
    BLS parameter. Output is in the r-torsion subgroup G2."""
    if p is None:
        return None
    big_x = _BLS_X  # |x|
    t1 = _pt_mul(_OPS2, p, big_x * big_x + big_x - 1)  # [x²-x-1]P (x<0)
    t2 = _pt_neg(_OPS2, _pt_mul(_OPS2, _psi(p), big_x + 1))  # [x-1]ψ(P)
    t3 = _psi(_psi(_pt_double(_OPS2, p)))  # ψ²([2]P)
    return _pt_add(_OPS2, _pt_add(_OPS2, t1, t2), t3)


def _hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    """RFC 9380 §5.2 hash_to_field for Fp2 (m=2, L=64)."""
    length = count * 2 * 64
    uniform = _expand_message_xmd(msg, dst, length)
    out = []
    for i in range(count):
        c0 = int.from_bytes(uniform[i * 128 : i * 128 + 64], "big") % _P
        c1 = int.from_bytes(uniform[i * 128 + 64 : i * 128 + 128], "big") % _P
        out.append((c0, c1))
    return out


def hash_to_g2(msg: bytes, dst: bytes = DEFAULT_DST):
    """RFC 9380 hash_to_curve for BLS12381G2_XMD:SHA-256_SSWU_RO_:
    two field elements → SSWU on E2' → 3-isogeny to E2 → add → clear
    cofactor. Deterministic; output in G2."""
    u0, u1 = _hash_to_field_fp2(msg, dst, 2)
    q0 = _iso3_map(_sswu_g2(u0))
    q1 = _iso3_map(_sswu_g2(u1))
    return clear_cofactor_g2(_pt_add(_OPS2, q0, q1))


# --- the signature scheme ----------------------------------------------------


def g1_generator():
    return _G1


def g2_generator():
    return _G2


def sk_to_pk(sk: int):
    """Public key = sk·G1 (Filecoin orientation: 48-byte G1 pubkeys)."""
    if not 0 < sk < CURVE_ORDER:
        raise ValueError("secret key out of range")
    return _pt_mul(_OPS1, _G1, sk)


def sign(sk: int, msg: bytes, dst: bytes = DEFAULT_DST):
    """Signature = sk·H(msg) ∈ G2."""
    if not 0 < sk < CURVE_ORDER:
        raise ValueError("secret key out of range")
    return _pt_mul(_OPS2, hash_to_g2(msg, dst), sk)


def verify(pk, msg: bytes, sig, dst: bytes = DEFAULT_DST) -> bool:
    """e(pk, H(msg)) == e(G1, sig)."""
    if pk is None or sig is None:
        return False
    return pairing(pk, hash_to_g2(msg, dst)) == pairing(_G1, sig)


def aggregate_signatures(sigs: Sequence):
    out = None
    for s in sigs:
        out = _pt_add(_OPS2, out, s)
    return out


def aggregate_pubkeys(pks: Sequence):
    out = None
    for p in pks:
        out = _pt_add(_OPS1, out, p)
    return out


def verify_aggregate_same_message(
    pks: Sequence, msg: bytes, agg_sig, dst: bytes = DEFAULT_DST
) -> bool:
    """All of ``pks`` signed the SAME message (the F3 certificate case:
    every signer signs the gpbft decide payload).

    Identity (infinity) public keys are REJECTED, per BLS KeyValidate: an
    identity key contributes nothing to the aggregate, so accepting one
    would let its table power count toward quorum without a signature.

    SECURITY: same-message aggregation is sound ONLY against keys with a
    verified proof of possession (`pop_verify`) — without PoP, a rogue key
    pk_evil = t·G1 − Σ pk_honest lets one participant forge the whole
    aggregate. Callers at a trust boundary must validate PoPs (the F3
    certificate path does, mirroring the POP ciphersuite go-f3 uses)."""
    if not pks or agg_sig is None:
        return False
    if any(pk is None for pk in pks):
        return False
    agg_pk = aggregate_pubkeys(pks)
    if agg_pk is None:
        return False
    return pairing(agg_pk, hash_to_g2(msg, dst)) == pairing(_G1, agg_sig)


# standard PoP DST of the BLS POP ciphersuite (go-f3 parity)
POP_DST = b"BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


def pop_prove(sk: int) -> "tuple":
    """Proof of possession: sign one's own compressed public key under the
    dedicated PoP domain tag. Registering a PoP is what makes
    same-message aggregation rogue-key safe (an attacker cannot produce a
    PoP for pk_evil = t·G1 − Σ pk_honest without its discrete log)."""
    pk = sk_to_pk(sk)
    return sign(sk, g1_compress(pk), POP_DST)


def pop_verify(pk, pop) -> bool:
    """Check a proof of possession for ``pk``."""
    if pk is None or pop is None:
        return False
    return verify(pk, g1_compress(pk), pop, POP_DST)
