"""Batched arithmetic on E: y^2 = x^3 + x over F_p (the A1 curve).

This is the batched replacement for PBC's curve group (reference L1
layer; every G1 op in bgn.go -- Element.Mul/Div/PowBig on G1 -- lands here).

Representations
  - Affine batch: AffinePoint(x, y, inf) with x, y uint32 [L, *batch] in
    Montgomery form and inf uint32 {0,1} of batch shape.  This is the
    canonical, serializable, comparable form: ciphertexts are stored affine
    (the analog of pbc's canonical element bytes).
  - Jacobian JacPoint(X, Y, Z): internal compute form; Z == 0 encodes the
    identity O.  Ops chain in Jacobian and are renormalized once per batch
    via Montgomery batch inversion (amortized ~4 muls/element).

Completeness: madd handles A=O, B=O, A==B (via a caller-precomputed 2B) and
A==-B with lane selects, so ladders and homomorphic Adds are total functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx


class AffinePoint(NamedTuple):
    x: jax.Array   # [L, *batch] Montgomery form
    y: jax.Array   # [L, *batch]
    inf: jax.Array  # [*batch] uint32 {0,1}


class JacPoint(NamedTuple):
    X: jax.Array
    Y: jax.Array
    Z: jax.Array   # Z == 0 encodes the identity


def affine_infinity(ctx: MontCtx, batch_shape=()) -> AffinePoint:
    z = jnp.zeros((ctx.L,) + batch_shape, dtype=jnp.uint32)
    return AffinePoint(z, z, jnp.ones(batch_shape, dtype=jnp.uint32))


def jac_infinity(ctx: MontCtx, batch_shape=()) -> JacPoint:
    one = jnp.broadcast_to(
        ctx.one.reshape((ctx.L,) + (1,) * len(batch_shape)),
        (ctx.L,) + batch_shape)
    return JacPoint(one, one, jnp.zeros_like(one))


def to_jac(ctx: MontCtx, a: AffinePoint) -> JacPoint:
    batch_shape = a.x.shape[1:]
    one = jnp.broadcast_to(
        ctx.one.reshape((ctx.L,) + (1,) * len(batch_shape)), a.x.shape)
    Z = lb.select(a.inf, jnp.zeros_like(one), one)
    return JacPoint(a.x, a.y, Z)


def normalize(ctx: MontCtx, j: JacPoint, rns=None) -> AffinePoint:
    """Jacobian -> canonical affine via batched inversion of Z.

    rns: optional RNSCtx -- on the RNS path the single Fermat chain
    behind the batch inversion runs as one RNS pow scan instead of the
    limb-domain chain (see rns_pairing.mont_inv_rns)."""
    L = ctx.L
    batch_shape = j.Z.shape[1:]
    zflat = j.Z.reshape(L, -1) if batch_shape else j.Z.reshape(L, 1)
    inv_fn = None
    if rns is not None:
        from . import pairing as pairing_mod
        if pairing_mod.use_rns(rns):
            from . import rns_pairing

            def inv_fn(t):
                return rns_pairing.mont_inv_rns(ctx, rns, t)

    zinv = mg.batch_mont_inv(ctx, zflat, inv_fn=inv_fn).reshape(j.Z.shape)
    zinv2 = mg.mont_mul(ctx, zinv, zinv)
    zinv3 = mg.mont_mul(ctx, zinv2, zinv)
    x = mg.mont_mul(ctx, j.X, zinv2)
    y = mg.mont_mul(ctx, j.Y, zinv3)
    inf = lb.is_zero(j.Z)
    zero = jnp.zeros_like(x)
    return AffinePoint(lb.select(inf, zero, x), lb.select(inf, zero, y), inf)


def neg_affine(ctx: MontCtx, a: AffinePoint) -> AffinePoint:
    return AffinePoint(a.x, mg.mod_neg(ctx, a.y), a.inf)


def eq_affine(a: AffinePoint, b: AffinePoint):
    """Equality of canonical affine points; uint32 {0,1}."""
    both_inf = a.inf & b.inf
    coords = lb.eq(a.x, b.x) & lb.eq(a.y, b.y) & (1 - a.inf) & (1 - b.inf)
    return (both_inf | coords).astype(jnp.uint32)


def select_jac(mask, a: JacPoint, b: JacPoint) -> JacPoint:
    return JacPoint(lb.select(mask, a.X, b.X),
                    lb.select(mask, a.Y, b.Y),
                    lb.select(mask, a.Z, b.Z))


def select_affine(mask, a: AffinePoint, b: AffinePoint) -> AffinePoint:
    return AffinePoint(lb.select(mask, a.x, b.x),
                       lb.select(mask, a.y, b.y),
                       jnp.where(mask.astype(bool), a.inf, b.inf))


def dbl(ctx: MontCtx, v: JacPoint) -> JacPoint:
    """Jacobian doubling for a = 1 (curve y^2 = x^3 + x). ~9 muls.

    Z == 0 and Y == 0 (2-torsion) both land on Z' == 0 automatically."""
    X, Y, Z = v
    XX = mg.mont_mul(ctx, X, X)
    YY = mg.mont_mul(ctx, Y, Y)
    YYYY = mg.mont_mul(ctx, YY, YY)
    ZZ = mg.mont_mul(ctx, Z, Z)
    ZZZZ = mg.mont_mul(ctx, ZZ, ZZ)
    M = mg.mod_add(ctx, mg.mod_add(ctx, XX, mg.mod_add(ctx, XX, XX)), ZZZZ)
    T = mg.mont_mul(ctx, X, YY)
    S = mg.mod_add(ctx, T, T)
    S = mg.mod_add(ctx, S, S)                      # S = 4*X*Y^2
    MM = mg.mont_mul(ctx, M, M)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, MM, S), S)
    Y8 = mg.mod_add(ctx, YYYY, YYYY)
    Y8 = mg.mod_add(ctx, Y8, Y8)
    Y8 = mg.mod_add(ctx, Y8, Y8)                   # 8*Y^4
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, M, mg.mod_sub(ctx, S, X3)), Y8)
    YZ = mg.mont_mul(ctx, Y, Z)
    Z3 = mg.mod_add(ctx, YZ, YZ)
    return JacPoint(X3, Y3, Z3)


def madd(ctx: MontCtx, v: JacPoint, b: AffinePoint,
         b_dbl: Optional[JacPoint] = None) -> JacPoint:
    """Complete mixed addition v + b. ~11 muls plus selects.

    b_dbl: precomputed 2b (Jacobian) used when v == b; if None it is
    computed here (one extra dbl of the affine base)."""
    X1, Y1, Z1 = v
    ZZ = mg.mont_mul(ctx, Z1, Z1)
    U2 = mg.mont_mul(ctx, b.x, ZZ)
    ZZZ = mg.mont_mul(ctx, Z1, ZZ)
    S2 = mg.mont_mul(ctx, b.y, ZZZ)
    H = mg.mod_sub(ctx, U2, X1)
    R = mg.mod_sub(ctx, S2, Y1)
    HH = mg.mont_mul(ctx, H, H)
    HHH = mg.mont_mul(ctx, H, HH)
    V = mg.mont_mul(ctx, X1, HH)
    RR = mg.mont_mul(ctx, R, R)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, mg.mod_sub(ctx, RR, HHH), V), V)
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, R, mg.mod_sub(ctx, V, X3)),
                    mg.mont_mul(ctx, Y1, HHH))
    Z3 = mg.mont_mul(ctx, Z1, H)
    out = JacPoint(X3, Y3, Z3)

    v_inf = lb.is_zero(Z1)
    h_zero = lb.is_zero(H)
    r_zero = lb.is_zero(R)
    # v == b (same point): fall back to the doubling of b
    if b_dbl is None:
        b_dbl = dbl(ctx, to_jac(ctx, b))
    same = h_zero & r_zero & (1 - v_inf) & (1 - b.inf)
    out = select_jac(same, b_dbl, out)
    # v == -b: identity
    opp = h_zero & (1 - r_zero) & (1 - v_inf) & (1 - b.inf)
    out = JacPoint(out.X, out.Y,
                   lb.select(opp, jnp.zeros_like(out.Z), out.Z))
    # v == O -> b ; b == O -> v
    out = select_jac(v_inf, to_jac(ctx, b), out)
    out = select_jac(b.inf & (1 - v_inf), v, out)
    return out


def add_affine(ctx: MontCtx, a: AffinePoint, b: AffinePoint) -> JacPoint:
    """General complete a + b for two affine batches (homomorphic Add)."""
    return madd(ctx, to_jac(ctx, a), b)


def fixed_base_mul(ctx: MontCtx, table: AffinePoint, digits) -> JacPoint:
    """base^e via a precomputed radix-R window table (fixed base).

    table: AffinePoint with batch shape (J, R), entry (j, d) = base^(d*R^j)
    (d = 0 entries are the identity).  digits: uint32 [Jd, *batch] base-R
    digits of e, least-significant first, Jd <= J.  Cost: Jd complete mixed
    additions + Jd doublings (for the completeness fallback) versus
    ~key_bits doublings + additions for the generic ladder -- ~4x fewer
    field muls for 512-bit exponents."""
    Jd = digits.shape[0]
    batch_shape = digits.shape[1:]
    jidx = jnp.arange(Jd, dtype=jnp.int32).reshape(
        (Jd,) + (1,) * len(batch_shape))
    d = digits.astype(jnp.int32)
    gx = table.x[:, jidx, d]             # [L, Jd, *batch]
    gy = table.y[:, jidx, d]
    ginf = table.inf[jidx, d]            # [Jd, *batch]
    # scan over the window rows accumulating the sum
    xs = (jnp.moveaxis(gx, 1, 0), jnp.moveaxis(gy, 1, 0), ginf)

    def step(v, row):
        rx, ry, rinf = row
        pt = AffinePoint(rx, ry, rinf)
        return madd(ctx, v, pt), None

    v0 = jac_infinity(ctx, batch_shape)
    v, _ = jax.lax.scan(step, v0, xs)
    return v


def scalar_mul(ctx: MontCtx, base: AffinePoint, bits) -> JacPoint:
    """base^e (written multiplicatively, as pbc does): double-and-add ladder.

    bits: [nbits] shared exponent (uses lax.cond to skip non-add steps) or
    [nbits, *batch] per-element exponents (computes both paths + select).
    Leading zero bits are harmless.  Mirrors Element.PowBig semantics
    (reference bgn.go:113, 222-223, 277, ...)."""
    batch_shape = jnp.broadcast_shapes(base.x.shape[1:], bits.shape[1:])
    base = AffinePoint(
        lb.expand_to(base.x, (ctx.L,) + batch_shape),
        lb.expand_to(base.y, (ctx.L,) + batch_shape),
        jnp.broadcast_to(
            base.inf.reshape(base.inf.shape + (1,) * (len(batch_shape)
                                                      - base.inf.ndim)),
            batch_shape))
    base2 = dbl(ctx, to_jac(ctx, base))
    v0 = jac_infinity(ctx, batch_shape)
    shared = bits.ndim == 1

    def step(v, bit):
        d = dbl(ctx, v)
        if shared:
            w = jax.lax.cond(bit.astype(bool),
                             lambda d: madd(ctx, d, base, base2),
                             lambda d: d, d)
        else:
            added = madd(ctx, d, base, base2)
            w = select_jac(jnp.broadcast_to(bit, batch_shape), added, d)
        return w, None

    v, _ = jax.lax.scan(step, v0, bits)
    # a ladder from an infinite base must return infinity
    return JacPoint(v.X, v.Y, lb.select(base.inf, jnp.zeros_like(v.Z), v.Z))
