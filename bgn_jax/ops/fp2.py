"""Batched F_p^2 = F_p[i]/(i^2+1) arithmetic (valid since p == 3 mod 4).

GT (the pairing target group, reference `pairing.NewGT()` bgn.go:297) is the
order-n subgroup of F_p2^*; every L2 ciphertext is one of these elements.
Elements are pairs of Montgomery-form limb arrays stacked on a new leading
axis: shape [2, L, *batch] with [0]=real, [1]=imag.

Cites: GT usage in reference Add/Sub/Mult (bgn.go:294-314, 442-497) and the
host golden model bgn_jax/hostmath.py (fp2_*).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx


def make(re, im):
    return jnp.stack([re, im], axis=0)


def real(z):
    return z[0]


def imag(z):
    return z[1]


def one(ctx: MontCtx, batch_shape=()):
    """Multiplicative identity (Montgomery form of (1, 0))."""
    re = jnp.broadcast_to(
        ctx.one.reshape(ctx.one.shape + (1,) * len(batch_shape)),
        (ctx.L,) + batch_shape)
    return make(re, jnp.zeros_like(re))


def zero(ctx: MontCtx, batch_shape=()):
    return jnp.zeros((2, ctx.L) + batch_shape, dtype=jnp.uint32)


def mul(ctx: MontCtx, x, y):
    """Karatsuba: 3 mont_muls per F_p^2 product."""
    a, b = x[0], x[1]
    c, d = y[0], y[1]
    t0 = mg.mont_mul(ctx, a, c)
    t1 = mg.mont_mul(ctx, b, d)
    t2 = mg.mont_mul(ctx, mg.mod_add(ctx, a, b), mg.mod_add(ctx, c, d))
    re = mg.mod_sub(ctx, t0, t1)
    im = mg.mod_sub(ctx, mg.mod_sub(ctx, t2, t0), t1)
    return make(re, im)


def sqr(ctx: MontCtx, x):
    """(a+bi)^2 = (a+b)(a-b) + 2ab i: 2 mont_muls."""
    a, b = x[0], x[1]
    re = mg.mont_mul(ctx, mg.mod_add(ctx, a, b), mg.mod_sub(ctx, a, b))
    ab = mg.mont_mul(ctx, a, b)
    return make(re, mg.mod_add(ctx, ab, ab))


def conj(ctx: MontCtx, x):
    return make(x[0], mg.mod_neg(ctx, x[1]))


def inv(ctx: MontCtx, x):
    """1/(a+bi) = (a-bi)/(a^2+b^2)."""
    a, b = x[0], x[1]
    norm = mg.mod_add(ctx, mg.mont_mul(ctx, a, a), mg.mont_mul(ctx, b, b))
    ninv = mg.mont_inv(ctx, norm)
    return make(mg.mont_mul(ctx, a, ninv),
                mg.mont_mul(ctx, mg.mod_neg(ctx, b), ninv))


def div(ctx: MontCtx, x, y):
    return mul(ctx, x, inv(ctx, y))


def pow_bits(ctx: MontCtx, x, bits):
    """x^e with e as MSB-first bits [nbits, *eb]; square-and-multiply scan."""
    batch_shape = jnp.broadcast_shapes(x.shape[2:], bits.shape[1:])
    acc0 = jnp.broadcast_to(one(ctx, ()).reshape(
        (2, ctx.L) + (1,) * len(batch_shape)), (2, ctx.L) + batch_shape)
    x = lb.expand_to(x, (2, ctx.L) + batch_shape)

    def step(acc, bit):
        acc = sqr(ctx, acc)
        acc_mul = mul(ctx, acc, x)
        sel = jnp.broadcast_to(bit, batch_shape).astype(bool)
        return jnp.where(sel[None, None], acc_mul, acc), None

    acc, _ = jax.lax.scan(step, acc0, bits)
    return acc


def eq(x, y):
    """Exact equality; uint32 {0,1} of batch shape."""
    return (lb.eq(x[0], y[0]) & lb.eq(x[1], y[1])).astype(jnp.uint32)


def is_one(ctx: MontCtx, x):
    one_re = ctx.one.reshape(ctx.one.shape + (1,) * (x.ndim - 2))
    return (jnp.all(x[0] == one_re, axis=0) &
            jnp.all(x[1] == 0, axis=0)).astype(jnp.uint32)


def select(mask, x, y):
    """where(mask, x, y) with mask of batch shape."""
    return jnp.where(mask.astype(bool)[None, None], x, y)


def frobenius(ctx: MontCtx, x):
    """x^p = conj(x) in F_p^2."""
    return conj(ctx, x)
