"""Miller loop over the RNS field representation (fieldcore/rns.py).

Same contract and mathematical semantics as ops/pairing.py:miller_loop (the
batched replacement for PBC's Tate pairing, reference bgn.go:300), but
every F_p element lives as a [2k, batch] float32 residue vector and every
modular multiplication routes its O(k^2) base-extension work through bf16
matmuls.  Conversion limb<->RNS happens once per pairing at
entry/exit; the scan interior is pure RNS.

Static bound discipline (values < bound*p, headroom h >= 1024):
loop invariants X, Y < 27p, Z < 6p, f_re, f_im < 9p; affine inputs < 3p
(they arrive through to_rns_mont).  Every r_mul's bound product is checked
at trace time against h; the worst case is HH = H*H at 30*30 = 900.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fieldcore import limbs as lb
from ..fieldcore import rns as rn
from ..fieldcore.montgomery import MontCtx
from ..fieldcore.rns import RNSCtx, RVal
from .curve import AffinePoint

# Loop-invariant bounds (multiples of p), audited in the module docstring.
_BX, _BY, _BZ, _BF = 27, 27, 6, 9


def _pt(v):
    """Wrap a point-coordinate residue array with its bound (affine inputs
    arrive through to_rns_mont: bound 3)."""
    return RVal(v, 3)


def _neg_coord(rns, v):
    """Residues of (3p - value) for a bound-3 coordinate array: the
    y-coordinate of the negated point, still bound 3 (value in (0, 3p)).
    Works on raw [2k, *batch] arrays."""
    bshape = (1,) * (v.ndim - 1)
    kp3 = rns.kp[:, 3].reshape((-1,) + bshape)
    m = rns.m.reshape((-1,) + bshape)
    t = kp3 - v
    return jnp.where(t < 0, t + m, t)


def _dbl_step(rns: RNSCtx, X, Y, Z, fr, fi, xb, yb):
    """Fused Jacobian doubling + tangent line + f <- f^2 * line.

    Raw-array in/out (scan-carry friendly); bounds are the invariants.
    Muls are grouped by dependency layer through r_mul_many so each layer
    is ONE stacked matmul (5 layers for the whole step)."""
    X, Y, Z = RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)
    FR, FI = RVal(fr, _BF), RVal(fi, _BF)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    XX, ZZ, YY, YZ, t2, ab, sq_re = muls(
        (X, X), (Z, Z), (Y, Y), (Y, Z), (X, Z), (FR, FI),
        (add(FR, FI), sub(FR, FI)))
    Z3 = add(YZ, YZ)
    sq_im = add(ab, ab)

    ZZZ, ZZZZ, YYYY, T = muls((Z, ZZ), (ZZ, ZZ), (YY, YY), (X, YY))
    M = add(add(XX, add(XX, XX)), ZZZZ)
    S = add(T, T)
    S = add(S, S)                                  # 4 X Y^2

    MM, t1, Z3ZZZ, Z3Y = muls((M, M), (ZZZ, xb), (Z3, ZZZ), (Z3, Y))
    X3 = sub(sub(MM, S), S)
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)

    MSX3, Mt, l_im = muls((M, sub(S, X3)), (M, add(t1, t2)), (Z3ZZZ, yb))
    Y3 = sub(MSX3, Y8)
    l_re = sub(Mt, Z3Y)

    m0, m1, m2 = muls((sq_re, l_re), (sq_im, l_im),
                      (add(sq_re, sq_im), add(l_re, l_im)))
    f_re = sub(m0, m1)
    f_im = sub(sub(m2, m0), m1)

    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    assert f_re.bound <= _BF and f_im.bound <= _BF
    return X3.v, Y3.v, Z3.v, f_re.v, f_im.v


def _add_step(rns: RNSCtx, X1, Y1, Z1, fr, fi, ax, ay, xb, yb):
    """Fused mixed addition + line through V,A + f <- f * line."""
    X1, Y1, Z1 = RVal(X1, _BX), RVal(Y1, _BY), RVal(Z1, _BZ)
    FR, FI = RVal(fr, _BF), RVal(fi, _BF)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    (ZZ,) = muls((Z1, Z1))
    U2, ZZZ = muls((ax, ZZ), (Z1, ZZ))
    (S2,) = muls((ay, ZZZ))
    H = sub(U2, X1)
    R = sub(S2, Y1)
    HH, RR, Z3, Rx = muls((H, H), (R, R), (Z1, H), (R, add(xb, ax)))
    HHH, V, Z3ya, l_im = muls((H, HH), (X1, HH), (Z3, ay), (Z3, yb))
    X3 = sub(sub(sub(RR, HHH), V), V)
    l_re = sub(Rx, Z3ya)
    RVX3, Y1HHH = muls((R, sub(V, X3)), (Y1, HHH))
    Y3 = sub(RVX3, Y1HHH)

    m0, m1, m2 = muls((FR, l_re), (FI, l_im),
                      (add(FR, FI), add(l_re, l_im)))
    f_re = sub(m0, m1)
    f_im = sub(sub(m2, m0), m1)

    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    assert f_re.bound <= _BF and f_im.bound <= _BF
    return X3.v, Y3.v, Z3.v, f_re.v, f_im.v


def _dbl_pt(rns: RNSCtx, X, Y, Z):
    """Jacobian doubling (a = 1 curve), no line math; same formulas and
    bound invariants as _dbl_step (mirrors ops/curve.py:dbl)."""
    X, Y, Z = RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    XX, YY, ZZ = muls((X, X), (Y, Y), (Z, Z))
    YYYY, ZZZZ, T, YZ = muls((YY, YY), (ZZ, ZZ), (X, YY), (Y, Z))
    M = add(add(XX, add(XX, XX)), ZZZZ)
    S = add(T, T)
    S = add(S, S)
    (MM,) = muls((M, M))
    X3 = sub(sub(MM, S), S)
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)
    (MSX3,) = muls((M, sub(S, X3)))
    Y3 = sub(MSX3, Y8)
    Z3 = add(YZ, YZ)
    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    return X3.v, Y3.v, Z3.v


def _add_pt(rns: RNSCtx, X1, Y1, Z1, ax, ay):
    """Mixed addition v + a, no line math, NO completeness selects.

    Valid when v != +-a and neither is the identity -- guaranteed inside
    a shared-MSB-first ladder over a prime exponent for points of order
    q1/q2/n (partial multiples of the base never hit +-1 except at the
    first add, which operates on 2a: see scalar_mul_rns).  Mirrors
    ops/curve.py:madd's main path (reference Element.PowBig,
    bgn.go:222-223)."""
    X1, Y1, Z1 = RVal(X1, _BX), RVal(Y1, _BY), RVal(Z1, _BZ)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def add(u, v):
        return rn.r_add(rns, u, v)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    (ZZ,) = muls((Z1, Z1))
    U2, ZZZ = muls((ax, ZZ), (Z1, ZZ))
    (S2,) = muls((ay, ZZZ))
    H = sub(U2, X1)
    R = sub(S2, Y1)
    HH, RR, Z3 = muls((H, H), (R, R), (Z1, H))
    HHH, V = muls((H, HH), (X1, HH))
    X3 = sub(sub(sub(RR, HHH), V), V)
    RVX3, Y1HHH = muls((R, sub(V, X3)), (Y1, HHH))
    Y3 = sub(RVX3, Y1HHH)
    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ
    return X3.v, Y3.v, Z3.v


def add_jac_rns(rns: RNSCtx, p1, p2):
    """Jacobian p1 + p2 on raw residues (bounds <= (27, 27, 6) each, an
    all-zero Z marks the identity, as normalize_rns reads it).

    Identity operands are exact (flag selects); the remaining degenerate
    case p1 == +-p2 is NOT handled and returns the identity.  Callers use
    it only where that case needs a discrete log nobody knows: p1 = P^m
    against a fresh p2 = Q^r (encrypt, L1 re-randomization), which meet
    with probability <= 2/q1 per lane."""
    X1, Y1, Z1 = RVal(p1[0], _BX), RVal(p1[1], _BY), RVal(p1[2], _BZ)
    X2, Y2, Z2 = RVal(p2[0], _BX), RVal(p2[1], _BY), RVal(p2[2], _BZ)

    def muls(*pairs):
        return rn.r_mul_many(rns, pairs)

    def sub(u, v):
        return rn.r_sub(rns, u, v)

    Z1Z1, Z2Z2, Z1Z2 = muls((Z1, Z1), (Z2, Z2), (Z1, Z2))
    U1, U2, Z1c, Z2c = muls((X1, Z2Z2), (X2, Z1Z1), (Z1, Z1Z1), (Z2, Z2Z2))
    S1, S2 = muls((Y1, Z2c), (Y2, Z1c))
    H = sub(U2, U1)
    R = sub(S2, S1)
    HH, RR, Z3 = muls((H, H), (R, R), (Z1Z2, H))
    HHH, V = muls((H, HH), (U1, HH))
    X3 = sub(sub(sub(RR, HHH), V), V)
    RVX3, S1HHH = muls((R, sub(V, X3)), (S1, HHH))
    Y3 = sub(RVX3, S1HHH)
    assert X3.bound <= _BX and Y3.bound <= _BY and Z3.bound <= _BZ

    dead1 = jnp.all(p1[2] == 0.0, axis=0)[None]
    dead2 = jnp.all(p2[2] == 0.0, axis=0)[None]
    # dead1 -> p2 (the identity again when both are dead); dead2 -> p1
    return tuple(jnp.where(dead1, b, jnp.where(dead2, a, s))
                 for a, b, s in zip(p1, p2, (X3.v, Y3.v, Z3.v)))


def affine_to_rns(ctx: MontCtx, rns: RNSCtx, a):
    """Limb-Montgomery AffinePoint [L, *batch] -> raw Jacobian residues
    (X, Y, Z) over the flattened batch, Z = 1 (Z = 0 for identities)."""
    flat = a.inf.size
    x = rn.to_rns_mont(rns, a.x.reshape(ctx.L, flat)).v
    y = rn.to_rns_mont(rns, a.y.reshape(ctx.L, flat)).v
    one = jnp.broadcast_to(rn.r_one(rns, (flat,)).v, x.shape)
    z = jnp.where(a.inf.reshape(-1).astype(bool)[None], 0.0, one)
    return x, y, z


def add_complete_rns(ctx: MontCtx, rns: RNSCtx, a, b):
    """COMPLETE affine a + b -> normalized AffinePoint; the RNS
    analog of cv.add_affine + cv.normalize (homomorphic L1 Add/Sub,
    reference bgn.go:442-497).

    The limb path costs ~11 sequential O(L^2) CIOS muls (L = 66 limbs
    at 1024-bit keys).  Here the group law runs as RNS matmul work: one incomplete mixed add
    + one doubling computed unconditionally, with the same completeness
    selects as cv.madd driven by EXACT zero tests on the canonical limbs
    of H = x_b - x_a and R = y_b - y_a (RNS has no cheap zero test; the
    two from_rns_mont conversions are matmuls).  Bit-identical
    output to the limb path (same field values, same canonical limbs)."""
    from .curve import AffinePoint
    L = ctx.L
    batch_shape = a.x.shape[1:]
    flat = 1
    for s in batch_shape:
        flat *= s

    def prep(x):
        return rn.to_rns_mont(rns, x.reshape(L, flat))

    axr, ayr, bxr, byr = prep(a.x), prep(a.y), prep(b.x), prep(b.y)
    one = rn.r_one(rns, (flat,))
    Z1 = jnp.broadcast_to(one.v, axr.v.shape)

    Xa, Ya, Za = _add_pt(rns, axr.v, ayr.v, Z1, bxr, byr)
    Xd, Yd, Zd = _dbl_pt(rns, axr.v, ayr.v, Z1)

    H = rn.r_sub(rns, bxr, axr)
    R = rn.r_sub(rns, byr, ayr)
    h_zero = lb.is_zero(rn.from_rns_mont(rns, H))      # [flat] uint32
    r_zero = lb.is_zero(rn.from_rns_mont(rns, R))

    a_inf = a.inf.reshape(-1)
    b_inf = b.inf.reshape(-1)
    live = (1 - a_inf) * (1 - b_inf)
    same = h_zero & r_zero & live
    opp = h_zero & (1 - r_zero) & live

    def sel(m, u, v):
        return jnp.where(m.astype(bool)[None], u, v)

    X = sel(same, Xd, Xa)
    Y = sel(same, Yd, Ya)
    Z = sel(same, Zd, Za)
    zero = jnp.zeros_like(Z)
    Z = sel(opp, zero, Z)
    # a == O -> b (affine, Z = 1); b == O (a live) -> a; O + O -> O
    oneb = jnp.broadcast_to(one.v, Z.shape)
    X = sel(a_inf, bxr.v, X)
    Y = sel(a_inf, byr.v, Y)
    Z = sel(a_inf, oneb, Z)
    bo = b_inf * (1 - a_inf)
    X = sel(bo, axr.v, X)
    Y = sel(bo, ayr.v, Y)
    Z = sel(bo, oneb, Z)
    Z = sel(a_inf & b_inf, zero, Z)

    aff = normalize_rns(ctx, rns, X, Y, Z)
    return AffinePoint(aff.x.reshape((L,) + batch_shape),
                       aff.y.reshape((L,) + batch_shape),
                       aff.inf.reshape(batch_shape))


def make_rns_window_table(ctx: MontCtx, rns: RNSCtx, table):
    """Limb-domain fixed-base window table (AffinePoint [L, J, R]) ->
    (x, y) RNS residues [2k, J, R].  Runs once at key build; identity
    entries (digit 0) keep zero/garbage residues and are masked by the
    digits during the ladder."""
    L = ctx.L
    J, R = table.x.shape[1], table.x.shape[2]
    x = rn.to_rns_mont(rns, table.x.reshape(L, J * R))
    y = rn.to_rns_mont(rns, table.y.reshape(L, J * R))
    ch = x.v.shape[0]
    return x.v.reshape(ch, J, R), y.v.reshape(ch, J, R)


def neg_y_rns(rns: RNSCtx, Y, bound: int, mask):
    """Residues of the negated y-coordinate ((bound*p) - y) where mask,
    unchanged elsewhere; bound preserved."""
    t = rns.kp[:, bound:bound + 1] - Y
    t = jnp.where(t < 0, t + rns.m, t)
    return jnp.where(mask.astype(bool)[None], t, Y)


def fixed_base_mul_rns(ctx: MontCtx, rns: RNSCtx, table_rns, table_inf,
                       digits):
    """base^e via a radix-W window table, accumulated in RNS (W =
    scheme._WINDOW_RADIX = 2^w; the table's last axis carries the W
    digit entries, so the radix is a shape property here).

    LSB-first window accumulation (no doublings): acc_j = base^(e mod
    W^j), updated by one mixed addition per window.  Identity handling
    is EXACT and flag-based (digit == 0 entries and the not-yet-started
    prefix come from the digits, never from an RNS zero test).  The
    remaining degenerate-addition cases (acc == +-entry) require
    e mod W^j == -+ d*W^j (mod ord(base)); both magnitudes are below
    W^(j+1), so for windows covering fewer bits than the base's order
    this is impossible, and for the top windows of a full-width random
    exponent it happens with probability < 2^-(ord_bits - w) per encrypt
    (~2^-246 at 512-bit keys with w = 8); the limb path
    (cv.fixed_base_mul, complete additions) remains the
    reference-semantics fallback.

    digits: uint32 [Jd, B] base-W digits, least-significant first.
    Returns raw (X, Y, Z) RVals [2k, B]; Z is exact 0.0 residues for
    e = 0 (normalize_rns's identity encoding).  Replaces the two scalar
    mults of EncryptWithRandomness (bgn.go:344-346) on the RNS path."""
    tx, ty = table_rns
    Jd, B = digits.shape
    ch = tx.shape[0]

    jidx = jnp.arange(Jd, dtype=jnp.int32).reshape(Jd, 1)
    d = digits.astype(jnp.int32)
    gx = jnp.moveaxis(tx[:, jidx, d], 1, 0)            # [Jd, 2k, B]
    gy = jnp.moveaxis(ty[:, jidx, d], 1, 0)
    ginf = table_inf[jidx, d].astype(jnp.uint32)       # [Jd, B]
    one = rn.r_one(rns, (B,))
    zeros = jnp.zeros((ch, B), jnp.float32)

    def step(carry, row):
        X, Y, Z, started = carry
        rx, ry, rinf = row
        aX, aY, aZ = _add_pt(rns, X, Y, Z, _pt(rx), _pt(ry))
        live = (1 - rinf)                      # entry is not identity
        init = live * (1 - started)            # first live window
        upd = live * started

        def sel(m, a, b):
            return jnp.where(m.astype(bool)[None], a, b)

        X2 = sel(init, rx, sel(upd, aX, X))
        Y2 = sel(init, ry, sel(upd, aY, Y))
        Z2 = sel(init, jnp.broadcast_to(one.v, (ch, B)),
                 sel(upd, aZ, Z))
        return (X2, Y2, Z2, started | live), None

    carry0 = (zeros, zeros, jnp.broadcast_to(one.v, (ch, B)),
              jnp.zeros((B,), jnp.uint32))
    (X, Y, Z, started), _ = jax.lax.scan(step, carry0, (gx, gy, ginf))
    Z = jnp.where(started.astype(bool)[None], Z, jnp.zeros_like(Z))
    return RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)


def normalize_rns(ctx: MontCtx, rns: RNSCtx, X, Y, Z):
    """Jacobian (raw RNS residues [2k, B], bounds <= (27, 27, 6)) ->
    canonical affine AffinePoint limbs -- the RNS analog of cv.normalize
    + montgomery.batch_mont_inv, with the prefix/suffix product scans and
    all coordinate muls as r_muls; only the two affine coordinates
    convert to limbs.  Bit-identical output (same field values, same
    canonical limb encoding).

    Identity detection is EXACT without a flag channel: a dead lane's Z
    is written as literal 0.0 in every channel, while any live value
    0 < v < 6p cannot vanish in all ~2k channels (that would need every
    channel prime to divide v, i.e. v >= A >> 6p)."""
    from .curve import AffinePoint

    dead = jnp.all(Z == 0.0, axis=0)                      # [B] exact
    one_b = jnp.broadcast_to(rns.one_rns, Z.shape)
    zsafe = jnp.where(dead[None], one_b, Z)

    def mul2(a, b):
        # static bound 6 covers both levels: inputs <= 6p, products <= 3p
        return rn.r_mul(rns, RVal(a, 6), RVal(b, 6)).v

    prefix = jax.lax.associative_scan(mul2, zsafe, axis=1)
    suffix = jax.lax.associative_scan(mul2, zsafe, axis=1, reverse=True)
    total = prefix[:, -1:]
    tinv = rn.r_pow_bits(rns, RVal(total, 3), ctx.pm2_bits).v  # [2k, 1]
    one_col = one_b[:, :1]
    pre_excl = jnp.concatenate([one_col, prefix[:, :-1]], axis=1)
    suf_excl = jnp.concatenate([suffix[:, 1:], one_col], axis=1)
    zinv = rn.r_mul(rns, RVal(pre_excl, 3), RVal(suf_excl, 3))
    zinv = rn.r_mul(rns, zinv, RVal(jnp.broadcast_to(tinv, Z.shape), 3))
    zinv2 = rn.r_mul(rns, zinv, zinv)
    zinv3 = rn.r_mul(rns, zinv2, zinv)
    x = rn.r_mul(rns, RVal(X, _BX), zinv2)
    y = rn.r_mul(rns, RVal(Y, _BY), zinv3)
    xl = rn.from_rns_mont(rns, x)
    yl = rn.from_rns_mont(rns, y)
    zero = jnp.zeros_like(xl)
    inf = dead.astype(jnp.uint32)
    xl = jnp.where(dead[None], zero, xl)
    yl = jnp.where(dead[None], zero, yl)
    return AffinePoint(xl, yl, inf)


def mont_inv_rns(ctx: MontCtx, rns: RNSCtx, x):
    """Montgomery-form limb inverse x^-1 (same contract as
    montgomery.mont_inv) with the Fermat chain run in RNS.

    The limb-domain chain is 16L sequential CIOS muls on a tiny array, the
    single largest cost in curve.normalize (hence in every homomorphic L1
    op).  Here the chain is one RNS square-and-multiply scan.  Exact:
    to_rns_mont/from_rns_mont round-trip the Montgomery representative and
    the chain computes x^(p-2) in either domain."""
    batch_shape = x.shape[1:]
    flat = 1
    for s in batch_shape:
        flat *= s
    xr = rn.to_rns_mont(rns, x.reshape(ctx.L, flat))
    w = rn.r_pow_bits(rns, xr, ctx.pm2_bits)
    return rn.from_rns_mont(rns, w).reshape((ctx.L,) + batch_shape)


def scalar_mul_rns(ctx: MontCtx, rns: RNSCtx, base, digits, raw=False):
    """base^e in G1 via an RNS double-and-add ladder; e = shared MSB-first
    digits -- plain bits or signed NAF, first digit == 1 (the decrypt
    exponent q1, bgn.go:222-223).  raw=True skips the limb conversion and
    returns (X, Y, Z) RVals over the flattened batch.

    base: limb-Montgomery AffinePoint; returns a limb-Montgomery JacPoint
    with the same coordinates as ops/curve.py:scalar_mul on every input
    where no degenerate addition occurs (identity bases are fixed up by a
    final select, exactly like curve.scalar_mul; the NAF chain is vetted
    at keygen by scheme._chain_degenerate)."""
    from .curve import JacPoint
    batch_shape = base.x.shape[1:]
    flat = 1
    for s in batch_shape:
        flat *= s

    def prep(x):
        return rn.to_rns_mont(rns, x.reshape(ctx.L, flat))

    ax, ay = prep(base.x), prep(base.y)
    one = rn.r_one(rns, (flat,))
    X0, Y0 = ax.v, ay.v
    Z0 = jnp.broadcast_to(one.v, ax.v.shape)

    nay = _pt(_neg_coord(rns, ay.v))

    def step(carry, d):
        s1 = _dbl_pt(rns, *carry)
        s2 = jax.lax.switch(
            d.astype(jnp.int32) + 1,
            [lambda s: _add_pt(rns, *s, ax, nay), lambda s: s,
             lambda s: _add_pt(rns, *s, ax, ay)],
            s1)
        return s2, None

    (X, Y, Z), _ = jax.lax.scan(step, (X0, Y0, Z0), digits[1:])

    if raw:
        # RNS-domain result for fused consumers (ops/bsgs.py RNS scan);
        # identity-base lanes carry garbage residues -- the caller masks
        # them via base.inf
        return RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)
    Xl = rn.from_rns_mont(rns, RVal(X, _BX)).reshape((ctx.L,) + batch_shape)
    Yl = rn.from_rns_mont(rns, RVal(Y, _BY)).reshape((ctx.L,) + batch_shape)
    Zl = rn.from_rns_mont(rns, RVal(Z, _BZ)).reshape((ctx.L,) + batch_shape)
    # identity base -> identity result (Z = 0), as in curve.scalar_mul
    Zl = jnp.where(base.inf.astype(bool)[None], jnp.zeros_like(Zl), Zl)
    return JacPoint(Xl, Yl, Zl)


def scalar_mul_vec_rns(ctx: MontCtx, rns: RNSCtx, base, bits, raw=False):
    """base^k with a PER-ELEMENT exponent column: base AffinePoint
    [L, *batch], bits uint [nbits, *batch] MSB-first plain bits (k >= 0).
    The RNS MultConstant path (reference MultConst, bgn.go:253-291).

    Safety of the incomplete mixed additions (_add_pt), proven statically:
    a started lane's state is c*base with c = value of the consumed bits;
    at every add step c has just been doubled, so c is even with
    2 <= c < 2^nbits.  A degenerate addition needs c == +-1 (mod
    ord(base)); ord(base) divides n and is >= min(q1, q2) for non-identity
    ciphertext points, so when 2^nbits < min(q1, q2) neither congruence
    can hold (c != 1 since c even, c != ord-1 since c < ord).  The caller
    (scheme.mult_const) guarantees nbits <= key_bits//2 - 2 and routes
    larger exponents through the complete limb ladder.

    Returns a limb-Montgomery JacPoint; k = 0 and identity-base lanes
    come back with Z = 0 (the identity), matching curve.scalar_mul."""
    from .curve import JacPoint
    batch_shape = base.x.shape[1:]
    flat = 1
    for s in batch_shape:
        flat *= s

    ax = rn.to_rns_mont(rns, base.x.reshape(ctx.L, flat))
    ay = rn.to_rns_mont(rns, base.y.reshape(ctx.L, flat))
    one = rn.r_one(rns, (flat,))
    X0 = ax.v
    Y0 = ay.v
    Z0 = jnp.broadcast_to(one.v, ax.v.shape)
    bits2 = bits.reshape(bits.shape[0], flat).astype(jnp.uint32)

    def step(carry, b):
        X, Y, Z, started = carry
        dX, dY, dZ = _dbl_pt(rns, X, Y, Z)
        aX, aY, aZ = _add_pt(rns, dX, dY, dZ, _pt(ax.v), _pt(ay.v))
        bb = b.astype(bool)
        st = started.astype(bool)
        newly = (~st) & bb

        def sel3(m, u, v):
            return jnp.where(m[None], u, v)

        X2 = sel3(st, jnp.where(bb[None], aX, dX), sel3(newly, ax.v, X))
        Y2 = sel3(st, jnp.where(bb[None], aY, dY), sel3(newly, ay.v, Y))
        Z2 = sel3(st, jnp.where(bb[None], aZ, dZ), sel3(newly, Z0, Z))
        return (X2, Y2, Z2, started | b), None

    carry0 = (X0, Y0, Z0, jnp.zeros((flat,), jnp.uint32))
    (X, Y, Z, started), _ = jax.lax.scan(step, carry0, bits2)

    dead = (~started.astype(bool)) | base.inf.reshape(-1).astype(bool)
    if raw:
        # normalize_rns identity encoding: exact 0.0 residues
        Z = jnp.where(dead[None], jnp.zeros_like(Z), Z)
        return RVal(X, _BX), RVal(Y, _BY), RVal(Z, _BZ)
    Xl = rn.from_rns_mont(rns, RVal(X, _BX)).reshape((ctx.L,) + batch_shape)
    Yl = rn.from_rns_mont(rns, RVal(Y, _BY)).reshape((ctx.L,) + batch_shape)
    Zl = rn.from_rns_mont(rns, RVal(Z, _BZ)).reshape((ctx.L,) + batch_shape)
    Zl = jnp.where(dead.reshape(batch_shape)[None], jnp.zeros_like(Zl), Zl)
    return JacPoint(Xl, Yl, Zl)


def fp2_pow_vec_rns(ctx: MontCtx, rns: RNSCtx, z, bits):
    """z^k with a per-element exponent column for GT elements
    (limb [2, L, *batch] in/out; bits uint [nbits, *batch] MSB-first).
    The RNS L2 MultConstant path -- field muls are complete, so unlike
    the G1 variant this needs no order-bound precondition."""
    batch_shape = z.shape[2:]
    flat = 1
    for s in batch_shape:
        flat *= s
    zr = rn.to_rns_mont(rns, z[0].reshape(ctx.L, flat))
    zi = rn.to_rns_mont(rns, z[1].reshape(ctx.L, flat))
    one = rn.r_one(rns, (flat,))
    acc0 = (jnp.broadcast_to(one.v, zr.v.shape), jnp.zeros_like(zr.v))
    bits2 = bits.reshape(bits.shape[0], flat)

    def step(acc, b):
        a = (RVal(acc[0], 9), RVal(acc[1], 9))
        sq = _fp2_sqr(rns, a)
        mu = _fp2_mul(rns, (sq[0], sq[1]), (zr, zi))
        assert mu[0].bound <= 9 and mu[1].bound <= 9
        sel = b.astype(bool)[None]
        return (jnp.where(sel, mu[0].v, sq[0].v),
                jnp.where(sel, mu[1].v, sq[1].v)), None

    (ar, ai), _ = jax.lax.scan(step, acc0, bits2)
    out_re = rn.from_rns_mont(rns, RVal(ar, 9)) \
        .reshape((ctx.L,) + batch_shape)
    out_im = rn.from_rns_mont(rns, RVal(ai, 9)) \
        .reshape((ctx.L,) + batch_shape)
    return jnp.stack([out_re, out_im], axis=0)


def fp2_pow_rns(ctx: MontCtx, rns: RNSCtx, z, digits, unitary=False,
                raw=False):
    """z^e for GT elements (limb [2, L, *batch] in/out) with the
    square-and-multiply scan in RNS (same contract as fp2.pow_bits for
    shared MSB-first exponents; the L2 decrypt csk = c^q1 path).

    unitary=True: z has norm 1 (every reduced pairing value / L2
    ciphertext does), so z^-1 = conj(z) and `digits` may be signed NAF;
    negative digits multiply by the conjugate.  raw=True returns the
    (re, im) RVals over the flattened batch without limb conversion."""
    batch_shape = z.shape[2:]
    flat = 1
    for s in batch_shape:
        flat *= s
    zr = rn.to_rns_mont(rns, z[0].reshape(ctx.L, flat))
    zi = rn.to_rns_mont(rns, z[1].reshape(ctx.L, flat))
    wr, wi = _fp2_pow_bits(rns, (RVal(zr.v, 9), RVal(zi.v, 9)), digits,
                           unitary=unitary)
    if raw:
        return wr, wi
    out_re = rn.from_rns_mont(rns, wr).reshape((ctx.L,) + batch_shape)
    out_im = rn.from_rns_mont(rns, wi).reshape((ctx.L,) + batch_shape)
    return jnp.stack([out_re, out_im], axis=0)


# ---------------------------------------------------------------------------
# F_p^2 in RNS (for the final exponentiation; mirrors ops/fp2.py)
# ---------------------------------------------------------------------------
# An F_p^2 element is a pair (re, im) of RVals.  Stable bound invariant for
# scan carries: (re, im) < (9p, 9p), the same (6, 9) production pattern as
# the Miller-loop f update.


def _fp2_mul(rns, x, y):
    """Karatsuba: 3 r_muls, one stacked dot."""
    a, b = x
    c, d = y
    t0, t1, t2 = rn.r_mul_many(
        rns, [(a, c), (b, d),
              (rn.r_add(rns, a, b), rn.r_add(rns, c, d))])
    return (rn.r_sub(rns, t0, t1),
            rn.r_sub(rns, rn.r_sub(rns, t2, t0), t1))


def _fp2_sqr(rns, x):
    a, b = x
    re, ab = rn.r_mul_many(
        rns, [(rn.r_add(rns, a, b), rn.r_sub(rns, a, b)), (a, b)])
    return re, rn.r_add(rns, ab, ab)


def _fp2_conj(rns, x):
    a, b = x
    return a, rn.r_sub(rns, rn.r_zero(rns, b.v.shape[1:]), b)


def _fp2_inv(rns, x, pm2_bits):
    """1/(a+bi) = (a-bi)/(a^2+b^2); Fermat inversion = a pure mul chain,
    so it stays in RNS (the limb-domain path costs ~2*16L CIOS muls)."""
    a, b = x
    aa, bb = rn.r_mul_many(rns, [(a, a), (b, b)])
    norm = rn.r_add(rns, aa, bb)
    ninv = rn.r_pow_bits(rns, norm, pm2_bits)
    nb = rn.r_sub(rns, rn.r_zero(rns, b.v.shape[1:]), b)
    return rn.r_mul(rns, a, ninv), rn.r_mul(rns, nb, ninv)


def _fp2_pow_bits(rns, x, digits, unitary=False):
    """x^e for an F_p^2 element; e as shared MSB-first digits (plain bits,
    or signed NAF when unitary=True: x^-1 = conj(x)).

    unitary=False requires nonnegative digits: conjugation is only the
    inverse on the norm-1 subgroup, so signed digits would be silently
    wrong.  Concrete digit arrays are checked loudly; traced digits are
    clamped to >= 0."""
    if not unitary:
        if not isinstance(digits, jax.core.Tracer):
            if np.asarray(digits).min() < 0:
                raise ValueError(
                    "non-unitary fp2 pow requires nonnegative digits "
                    "(signed NAF needs unitary=True)")
        digits = jnp.maximum(digits, 0)
    xr, xi = x
    assert xr.bound <= 9 and xi.bound <= 10, (xr.bound, xi.bound)
    one = rn.r_one(rns, xr.v.shape[1:])
    acc0 = (jnp.broadcast_to(one.v, xr.v.shape), jnp.zeros_like(xr.v))
    # conj(x): negate the imaginary part (value 10p - xi, bound 10)
    bshape = (1,) * (xi.v.ndim - 1)
    kp10 = rns.kp[:, 10].reshape((-1,) + bshape)
    m = rns.m.reshape((-1,) + bshape)
    t = kp10 - xi.v
    nxi = RVal(jnp.where(t < 0, t + m, t), 10)

    def _mul_branch(xarg):
        def f(sq):
            mu = _fp2_mul(rns, (RVal(sq[0], 9), RVal(sq[1], 9)), xarg)
            assert mu[0].bound <= 9 and mu[1].bound <= 9
            return mu[0].v, mu[1].v
        return f

    def step(acc, d):
        a = (RVal(acc[0], 9), RVal(acc[1], 9))
        sq = _fp2_sqr(rns, a)
        assert sq[0].bound <= 9 and sq[1].bound <= 9
        sqv = (sq[0].v, sq[1].v)
        di = d.astype(jnp.int32)
        return jax.lax.switch(
            di + 1,
            [_mul_branch((xr, nxi)), lambda s: s,
             _mul_branch((xr, xi))],
            sqv), None

    acc, _ = jax.lax.scan(step, acc0, digits)
    return RVal(acc[0], 9), RVal(acc[1], 9)


def final_exponentiation_rns(ctx: MontCtx, rns: RNSCtx, f, l_bits):
    """f^((p^2-1)/n) = (conj(f)/f)^l entirely in RNS (same contract as
    ops/pairing.py:final_exponentiation); f = (re RVal, im RVal)."""
    inv = _fp2_inv(rns, f, ctx.pm2_bits)
    w = _fp2_mul(rns, _fp2_conj(rns, f), inv)
    return _fp2_pow_bits(rns, w, l_bits)


def _miller_f_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint,
                  b: AffinePoint, n_digits):
    """Miller function value as RNS RVals (f_re, f_im), flat batch.

    n_digits: MSB-first exponent digits -- plain bits (uint {0,1}) or
    signed NAF digits ({-1,0,1}); the first nonzero digit must be +1.
    Negative digits add -A (line through V and -A); the REDUCED pairing
    value is chain-independent, so both encodings agree after the final
    exponentiation."""
    batch_shape = jnp.broadcast_shapes(a.x.shape[1:], b.x.shape[1:])
    L = ctx.L
    flat = 1
    for s in batch_shape:
        flat *= s

    def prep(x):
        v = rn.to_rns_mont(
            rns, lb.expand_to(x, (L,) + batch_shape).reshape(L, flat))
        return RVal(v.v, 3)

    ax, ay = prep(a.x), prep(a.y)
    xb, yb = prep(b.x), prep(b.y)
    one = rn.r_one(rns, (flat,))
    X0, Y0 = ax.v, ay.v
    Z0 = jnp.broadcast_to(one.v, ax.v.shape)
    f0 = Z0
    fi0 = jnp.zeros_like(f0)

    nay = _pt(_neg_coord(rns, ay.v))

    def dbl(*s):
        return _dbl_step(rns, *s, xb, yb)

    def madd(*s):
        return _add_step(rns, *s, ax, ay, xb, yb)

    def madd_neg(*s):
        return _add_step(rns, *s, ax, nay, xb, yb)

    def step(carry, d):
        X, Y, Z, fr, fi, started = carry
        d = d.astype(jnp.int32)

        def not_started(c):
            X, Y, Z, fr, fi, _ = c
            return (X, Y, Z, fr, fi,
                    jnp.where(d != 0, jnp.uint32(1), jnp.uint32(0)))

        def normal(c):
            X, Y, Z, fr, fi, st = c
            s1 = dbl(X, Y, Z, fr, fi)
            s2 = jax.lax.switch(
                d + 1,
                [lambda s: madd_neg(*s), lambda s: s, lambda s: madd(*s)],
                s1)
            return s2 + (st,)

        return jax.lax.cond(started.astype(bool), normal, not_started,
                            carry), None

    carry0 = (X0, Y0, Z0, f0, fi0, jnp.uint32(0))
    (X, Y, Z, fr, fi, started), _ = jax.lax.scan(step, carry0,
                                                 n_digits[:-1])

    def tail_started(c):
        X, Y, Z, fr, fi = c
        _, _, _, fr2, fi2 = dbl(X, Y, Z, fr, fi)
        return fr2, fi2

    fr, fi = jax.lax.cond(started.astype(bool), tail_started,
                          lambda c: (c[3], c[4]), (X, Y, Z, fr, fi))
    return (RVal(fr, _BF), RVal(fi, _BF)), batch_shape


def miller_loop_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint,
                    b: AffinePoint, n_bits):
    """f_{n,A}(phi(B)); inputs limb-Montgomery, output [2, L, *batch]
    limb-Montgomery (same contract as ops/pairing.py:miller_loop)."""
    (fr, fi), batch_shape = _miller_f_rns(ctx, rns, a, b, n_bits)
    out_re = rn.from_rns_mont(rns, fr).reshape((ctx.L,) + batch_shape)
    out_im = rn.from_rns_mont(rns, fi).reshape((ctx.L,) + batch_shape)
    return jnp.stack([out_re, out_im], axis=0)


def pairing_rns(ctx: MontCtx, rns: RNSCtx, a: AffinePoint, b: AffinePoint,
                n_bits, l_bits):
    """Full pairing (Miller + final exponentiation) in the RNS domain with
    one limb conversion at exit; bit-identical to miller_loop +
    final_exponentiation on the XLA path."""
    f, batch_shape = _miller_f_rns(ctx, rns, a, b, n_bits)
    zr, zi = final_exponentiation_rns(ctx, rns, f, l_bits)
    out_re = rn.from_rns_mont(rns, zr).reshape((ctx.L,) + batch_shape)
    out_im = rn.from_rns_mont(rns, zi).reshape((ctx.L,) + batch_shape)
    return jnp.stack([out_re, out_im], axis=0)
