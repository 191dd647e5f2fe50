"""Host-side exact arithmetic for BGN over a type-A1 composite-order pairing group.

Pure-Python big-integer implementation of every mathematical object in the
system: prime generation, A1 pairing parameter search, F_p / F_p^2 arithmetic,
the supersingular curve E: y^2 = x^3 + x over F_p, and the Tate pairing with
distortion map.  This module plays the role PBC's C parameter generator plays
for the reference implementation (reference: bgn.go:93 `pbc.GenerateA1`,
bgn.go:101 `pbc.NewPairing`), and doubles as the *golden model* the device
kernels are tested against.

Group-theory background (mirrors PBC "type A1" construction):
  - n = q1*q2 with q1, q2 random primes of key_bits/2 bits each
    (reference: bgn.go:151-168 `newPrimeTuple`).
  - l is the smallest positive multiple of 4 such that p = l*n - 1 is prime;
    then p == 3 (mod 4) automatically since n is odd (PBC a1_param
    construction; the reference string-parses l out of the params at
    bgn.go:583-593).
  - E: y^2 = x^3 + x over F_p is supersingular with #E(F_p) = p + 1 = l*n.
  - G1 is the order-n subgroup of E(F_p); random sampling multiplies a random
    curve point by the cofactor l (PBC curve_random semantics).
  - GT is the order-n subgroup of F_p2^*; F_p2 = F_p[i]/(i^2+1) (valid since
    p == 3 mod 4).
  - The symmetric pairing is e(P, Q) = f_{n,P}(phi(Q))^((p^2-1)/n) with the
    distortion map phi(x, y) = (-x, i*y).  (p^2-1)/n = (p-1)*l, and
    z^(p-1) = conj(z)/z in F_p2, so the final exponentiation is one
    conjugate-divide followed by a small power l.

Everything here is host code on Python ints; no JAX.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

Fp2 = Tuple[int, int]  # a + b*i
Point = Optional[Tuple[int, int]]  # affine (x, y) or None for the identity O

# ---------------------------------------------------------------------------
# Primality / prime generation
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
                 127, 131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181,
                 191, 193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251]


def is_probable_prime(n: int, rounds: int = 40, rng=None) -> bool:
    """Miller-Rabin primality test (mirrors crypto/rand.Prime's guarantees).

    Uses the native accelerator (csrc/hostmath_accel.cpp, `make native`)
    when present; the outcome is deterministic either way, so keygen
    reproducibility under a seeded rng is unaffected."""
    if n < 2:
        return False
    from .utils import native
    nat = native.is_probable_prime(n, rounds)
    if nat is not None:
        return nat
    for sp in _SMALL_PRIMES:
        if n % sp == 0:
            return n == sp
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        if rng is None:
            a = 2 + secrets.randbelow(n - 3)
        else:
            a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_prime(bits: int, rng=None) -> int:
    """Random prime with exactly `bits` bits (top bit set), like rand.Prime
    (reference: bgn.go:153)."""
    if bits < 2:
        raise ValueError("bits must be >= 2")
    while True:
        if rng is None:
            cand = secrets.randbits(bits)
        else:
            cand = rng.getrandbits(bits)
        cand |= (1 << (bits - 1)) | 1  # exact bit length, odd
        if is_probable_prime(cand):
            return cand


# ---------------------------------------------------------------------------
# A1 pairing parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class A1Params:
    """Type-A1 pairing parameters for composite order n = q1*q2.

    Mirrors the data PBC's `GenerateA1` produces (reference bgn.go:93) plus
    the factorization the BGN keygen holds on the side.
    """

    q1: int  # prime factor (the secret key, reference SecretKey.Key bgn.go:59)
    q2: int  # prime factor
    n: int   # group order, n = q1*q2
    l: int   # cofactor: p + 1 = l*n, l a multiple of 4
    p: int   # field prime, p == 3 (mod 4)

    @property
    def pbits(self) -> int:
        return self.p.bit_length()


def find_cofactor(n: int, start_l: int = 4) -> int:
    """Smallest l = 4k with p = l*n - 1 prime (PBC a1 param search).

    The native path (csrc) screens candidates with an incremental
    small-prime sieve before any big-number work."""
    from .utils import native
    nat = native.find_cofactor(n, start_l)
    if nat is not None:
        return nat
    l = start_l
    while True:
        p = l * n - 1
        if is_probable_prime(p):
            return l
        l += 4


def gen_a1_params(key_bits: int, rng=None) -> A1Params:
    """Generate A1 params: two key_bits/2-bit primes and the cofactor.

    Mirrors NewKeyGen's parameter phase (reference bgn.go:82-109)."""
    if key_bits < 16:
        raise ValueError("key bits must be >= 16 bits in length")
    if key_bits % 2 != 0:
        raise ValueError("key bits must be divisible by 2")
    q1 = gen_prime(key_bits // 2, rng)
    q2 = gen_prime(key_bits // 2, rng)
    n = q1 * q2
    l = find_cofactor(n)
    p = l * n - 1
    assert p % 4 == 3
    return A1Params(q1=q1, q2=q2, n=n, l=l, p=p)


# ---------------------------------------------------------------------------
# F_p^2 arithmetic: a + b*i with i^2 = -1 (p == 3 mod 4)
# ---------------------------------------------------------------------------


def fp2_mul(x: Fp2, y: Fp2, p: int) -> Fp2:
    a, b = x
    c, d = y
    t0 = a * c % p
    t1 = b * d % p
    # (a+b)(c+d) - t0 - t1 = ad + bc  (Karatsuba)
    t2 = (a + b) * (c + d) % p
    return ((t0 - t1) % p, (t2 - t0 - t1) % p)


def fp2_sqr(x: Fp2, p: int) -> Fp2:
    a, b = x
    return ((a + b) * (a - b) % p, 2 * a * b % p)


def fp2_conj(x: Fp2, p: int) -> Fp2:
    a, b = x
    return (a, (-b) % p)


def fp2_inv(x: Fp2, p: int) -> Fp2:
    a, b = x
    norm = (a * a + b * b) % p
    ninv = pow(norm, p - 2, p)
    return (a * ninv % p, (-b) * ninv % p)


def fp2_pow(x: Fp2, e: int, p: int) -> Fp2:
    if e < 0:
        return fp2_pow(fp2_inv(x, p), -e, p)
    r: Fp2 = (1, 0)
    base = x
    while e:
        if e & 1:
            r = fp2_mul(r, base, p)
        base = fp2_sqr(base, p)
        e >>= 1
    return r


FP2_ONE: Fp2 = (1, 0)


# ---------------------------------------------------------------------------
# Curve E: y^2 = x^3 + x over F_p (a=1, b=0), affine arithmetic
# ---------------------------------------------------------------------------


def on_curve(P: Point, p: int) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - (x * x * x + x)) % p == 0


def ec_neg(P: Point, p: int) -> Point:
    if P is None:
        return None
    return (P[0], (-P[1]) % p)


def ec_add(P: Point, Q: Point, p: int) -> Point:
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + 1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_dbl(P: Point, p: int) -> Point:
    return ec_add(P, P, p)


def ec_mul(k: int, P: Point, p: int) -> Point:
    """Scalar multiplication (double-and-add, host side)."""
    if P is None or k == 0:
        return None
    if k < 0:
        return ec_mul(-k, ec_neg(P, p), p)
    R: Point = None
    base = P
    while k:
        if k & 1:
            R = ec_add(R, base, p)
        base = ec_dbl(base, p)
        k >>= 1
    return R


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod p for p == 3 (mod 4); None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    r = pow(a, (p + 1) // 4, p)
    if r * r % p != a:
        return None
    return r


def random_curve_point(params: A1Params, rng=None) -> Tuple[int, int]:
    """Random point of the order-n subgroup G1.

    PBC's element_random on a curve group picks a random curve point and
    multiplies by the cofactor l, so G1.Rand() lands in the order-n
    subgroup (used by findGenerator, reference bgn.go:170-192)."""
    p = params.p
    while True:
        if rng is None:
            x = secrets.randbelow(p)
            sign = secrets.randbelow(2)
        else:
            x = rng.randrange(p)
            sign = rng.randrange(2)
        rhs = (x * x * x + x) % p
        y = sqrt_mod(rhs, p)
        if y is None:
            continue
        if sign:
            y = (-y) % p
        P = ec_mul(params.l, (x, y), p)
        if P is not None:
            return P


def find_generator(params: A1Params, rng=None) -> Tuple[int, int]:
    """Find a generator of the order-n subgroup.

    Mirrors findGenerator (reference bgn.go:170-192): sample random points
    of the order-n subgroup, reject if P^q1 == O or P^n != O."""
    p, n, q1 = params.p, params.n, params.q1
    while True:
        P = random_curve_point(params, rng)
        if ec_mul(q1, P, p) is None:
            continue
        if ec_mul(n, P, p) is not None:
            continue
        return P


# ---------------------------------------------------------------------------
# Tate pairing with distortion map
# ---------------------------------------------------------------------------


def _line_value(V: Tuple[int, int], lam: int, xq: int, yq: int, p: int) -> Fp2:
    """Evaluate the line of slope lam through V at phi(Q) = (-xq, i*yq).

    l(x, y) = (y - y_V) - lam*(x - x_V); at phi(Q) the real part is
    -y_V - lam*(-xq - x_V) and the imaginary part is yq."""
    xv, yv = V
    re = (-yv - lam * ((-xq - xv) % p)) % p
    return (re, yq % p)


def tate_miller(P: Point, Q: Point, params: A1Params) -> Fp2:
    """Miller loop f_{n,P}(phi(Q)) with denominator elimination.

    Vertical lines evaluate into F_p and are killed by the final
    exponentiation, so they are skipped; the final addition step (V = -P,
    vertical) is elided entirely."""
    p, n = params.p, params.n
    if P is None or Q is None:
        return FP2_ONE
    xq, yq = Q
    f: Fp2 = FP2_ONE
    V: Point = P
    bits = bin(n)[3:]  # bits below the MSB
    last = len(bits) - 1
    for idx, b in enumerate(bits):
        # --- doubling step ---
        if V is None:
            break
        xv, yv = V
        if yv == 0:
            # 2-torsion: tangent is vertical -> eliminated
            f = fp2_sqr(f, p)
            V = None
        else:
            lam = (3 * xv * xv + 1) * pow(2 * yv, -1, p) % p
            f = fp2_mul(fp2_sqr(f, p), _line_value(V, lam, xq, yq, p), p)
            V = ec_dbl(V, p)
        if b == "1":
            if idx == last:
                # final addition: V = -P, line vertical -> eliminated
                V = None
                continue
            if V is None:
                continue
            xv, yv = V
            xp_, yp_ = P
            if xv == xp_:
                # V == +-P mid-loop: vertical or tangent; vertical eliminated
                if (yv + yp_) % p == 0:
                    V = None
                    continue
                lam = (3 * xv * xv + 1) * pow(2 * yv, -1, p) % p
            else:
                lam = (yp_ - yv) * pow(xp_ - xv, -1, p) % p
            f = fp2_mul(f, _line_value(V, lam, xq, yq, p), p)
            V = ec_add(V, P, p)
    return f


def final_exponentiation(f: Fp2, params: A1Params) -> Fp2:
    """f^((p^2-1)/n) = (conj(f)/f)^l."""
    p = params.p
    w = fp2_mul(fp2_conj(f, p), fp2_inv(f, p), p)
    return fp2_pow(w, params.l, p)


def tate_pairing(P: Point, Q: Point, params: A1Params) -> Fp2:
    """Full symmetric pairing e(P, Q) (reference: Element.Pair, bgn.go:300)."""
    if P is None or Q is None:
        return FP2_ONE
    return final_exponentiation(tate_miller(P, Q, params), params)


# ---------------------------------------------------------------------------
# Host-side golden BGN scheme (slow, exact; the oracle for device kernels)
# ---------------------------------------------------------------------------


@dataclass
class GoldenKey:
    """A fully host-side BGN key (golden model of reference bgn.go:65-138)."""

    params: A1Params
    P: Tuple[int, int]   # generator of G1 (order n)
    Q: Tuple[int, int]   # generator of the order-q1 subgroup
    R: int               # Q = (P^R)^q2 (reference SecretKey.R)
    msg_space: int

    @property
    def n(self) -> int:
        return self.params.n

    def gt_base(self) -> Fp2:
        """e(P, P), the GT generator used for L2 operations."""
        return tate_pairing(self.P, self.P, self.params)


def golden_keygen(key_bits: int, msg_space: int, rng=None) -> GoldenKey:
    """Host golden keygen mirroring NewKeyGen (reference bgn.go:65-138)."""
    params = gen_a1_params(key_bits, rng)
    if params.q1 < msg_space or params.q2 < msg_space:
        raise ValueError("Message space is greater than the group order!")
    P0 = find_generator(params, rng)
    # P = P^(4l), extra cofactor clearing (reference bgn.go:113)
    P = ec_mul(4 * params.l, P0, params.p)
    R = (rng.randrange(params.n) if rng is not None
         else secrets.randbelow(params.n))
    Q = ec_mul(params.q2, ec_mul(R, P, params.p), params.p)
    assert P is not None and Q is not None
    return GoldenKey(params=params, P=P, Q=Q, R=R, msg_space=msg_space)


def golden_encrypt(key: GoldenKey, m: int, r: int) -> Point:
    """C = P^m * Q^r (reference EncryptWithRandomness, bgn.go:340-353)."""
    p = key.params.p
    return ec_add(ec_mul(m, key.P, p), ec_mul(r, key.Q, p), p)


def golden_decrypt_l1(key: GoldenKey, C: Point) -> Optional[int]:
    """BSGS decryption of an L1 ciphertext; None if out of range.

    Mirrors decrypt (bgn.go:218-250) + getDL (gsbs.go:54-106) semantics."""
    p, q1 = key.params.p, key.params.q1
    csk = ec_mul(q1, C, p)
    gsk = ec_mul(q1, key.P, p)
    m = _golden_bsgs(csk, gsk,
                     lambda a, b: ec_add(a, b, p),
                     lambda a: ec_neg(a, p),
                     None, key.msg_space)
    return m


def golden_decrypt_l2(key: GoldenKey, c: Fp2) -> Optional[int]:
    p, q1 = key.params.p, key.params.q1
    csk = fp2_pow(c, q1, p)
    gsk = fp2_pow(key.gt_base(), q1, p)
    return _golden_bsgs(csk, gsk,
                        lambda a, b: fp2_mul(a, b, p),
                        lambda a: fp2_inv(a, p),
                        FP2_ONE, key.msg_space)


def _golden_bsgs(csk, gsk, op, inv, identity, msg_space: int) -> Optional[int]:
    """Baby-step giant-step with the reference's exact indexing.

    Table: gen^(j+1) -> j for j in 0..bound_t where bound_t =
    ceil(sqrt(msg_space)) + 1 (gsbs.go:44); lookup loop bound =
    ceil(sqrt(msg_space)) (gsbs.go:60); hit => m = i*bound + j + 1
    (gsbs.go:98); negative values by retrying the inverse (bgn.go:235-242)."""
    import math
    if csk == identity:
        return 0
    # exact ceil(sqrt()) via isqrt (float sqrt drifts beyond 2^53)
    bound = math.isqrt(msg_space - 1) + 1 if msg_space > 1 else 1
    bound_t = bound + 1
    table = {}
    aux = gsk
    for j in range(bound_t + 1):
        table[aux] = j
        aux = op(aux, gsk)
    gamma = _golden_pow(gsk, bound, op, identity)
    gamma_inv = inv(gamma)
    for sign in (1, -1):
        aux = csk if sign == 1 else inv(csk)
        for i in range(bound + 1):
            if aux in table:
                return sign * (i * bound + table[aux] + 1)
            aux = op(aux, gamma_inv)
    return None


def _golden_pow(g, e, op, identity):
    r = identity
    base = g
    while e:
        if e & 1:
            r = op(r, base)
        base = op(base, base)
        e >>= 1
    return r
