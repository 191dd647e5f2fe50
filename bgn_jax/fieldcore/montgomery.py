"""Batched Montgomery modular arithmetic (CIOS) on 16-bit limb arrays.

This is the limb-domain replacement for GMP's modular layer underneath
PBC (reference: README.md:10-25).  The hot paths run in the RNS domain
(fieldcore/rns.py); `mont_mul` serves the host boundary and the cold
paths that stay on limbs.  The CIOS (coarsely integrated operand scanning) loop
runs as a `lax.fori_loop` over the L outer limbs with all inner work
vectorized over [L, batch] uint32 lanes.

Overflow audit (why uint32 accumulators are safe): per outer iteration each
accumulator position receives at most 4*(2^16-1) from the split products
(a_i*b lo/hi + m*p lo/hi) plus a small shifted-in carry; a position is live
for at most L+1 iterations, so values stay below (L+1)*2^18 + 2^17 < 2^32
for L <= 16000.  The low 16 bits of T[0] are always the exact residue of the
current absolute position because carries are only deferred upward, never
downward.

`platform()` below is the one backend decision of the package: it picks
the limb loop form here and the field path in ops/pairing.py:use_rns.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import limbs as lb

LIMB_BITS = lb.LIMB_BITS
LIMB_MASK = lb.LIMB_MASK

_PLATFORMS = ("gpu", "cpu")


def platform(backend: str | None = None) -> str:
    """The JAX backend the kernels are traced for: "gpu" or "cpu".

    gpu: the RNS field path (ops/pairing.py:use_rns) with the unrolled
    limb CIOS for the cold limb paths.  cpu (the test backend): the
    fori_loop limb CIOS.  Any other backend is an error -- there is no
    path tuned or tested for it, so none is guessed."""
    b = jax.default_backend() if backend is None else backend
    if b not in _PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {b!r}: bgn_jax runs on 'gpu' "
            "(the RNS field path) or 'cpu' (tests)")
    return b


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MontCtx:
    """Montgomery context for a fixed odd modulus p held in device arrays.

    Array fields don't key the jit cache, but the static `p_host` int DOES
    enter the pytree treedef: jit caches are therefore keyed per key value,
    trading cross-key kernel sharing for host-int access without device
    readbacks.  Multi-key workloads at the same width recompile the
    limb kernels once per key; on the rns=None large-key path that is the
    only compiled field path, so prefer key reuse there when churning many
    keys.  R = 2^(16*L).
    """

    p: jax.Array          # [L] modulus limbs
    pinv: jax.Array       # [] -p^-1 mod 2^16
    r2: jax.Array         # [L] R^2 mod p   (to_mont multiplier)
    one: jax.Array        # [L] R mod p     (Montgomery form of 1)
    pm2_bits: jax.Array   # [16L] bits of p-2, MSB first (Fermat inversion)
    pp1d4_bits: jax.Array  # [16L] bits of (p+1)/4, MSB first (sqrt, p=3 mod 4)
    # host copy of the modulus (static aux data, not traced): key-build and
    # serialization paths need p as a Python int without a device->host
    # read of ctx.p.
    p_host: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def L(self) -> int:
        return self.p.shape[0]


def make_mont_ctx(p: int, L: int | None = None) -> MontCtx:
    """Build a MontCtx from a host modulus (host-side, numpy)."""
    if p % 2 == 0:
        raise ValueError("modulus must be odd")
    if L is None:
        L = lb.num_limbs_for_bits(p.bit_length())
    R = 1 << (LIMB_BITS * L)
    if p >= R:
        raise ValueError("modulus does not fit limb count")
    pinv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    return MontCtx(
        p=jnp.asarray(lb.int_to_limbs(p, L)),
        pinv=jnp.asarray(np.uint32(pinv)),
        r2=jnp.asarray(lb.int_to_limbs(R * R % p, L)),
        one=jnp.asarray(lb.int_to_limbs(R % p, L)),
        pm2_bits=jnp.asarray(lb.int_to_bits(p - 2, LIMB_BITS * L)),
        pp1d4_bits=jnp.asarray(lb.int_to_bits((p + 1) // 4, LIMB_BITS * L)),
        p_host=p,
    )


def _bcast(v, batch_ndim: int):
    """Reshape a [L] constant to [L, 1, 1, ...] for batch broadcast."""
    return v.reshape(v.shape + (1,) * batch_ndim)


def mont_mul(ctx: MontCtx, a, b):
    """Montgomery product a*b*R^-1 mod p, batched.

    a, b: uint32 [L, *batch] canonical limbs < p. Returns same shape < p.

    The CIOS outer loop is STATICALLY UNROLLED (L is a compile-time shape):
    a lax.fori_loop here pays while-loop overhead on every one of the
    L tiny iterations; unrolled, XLA fuses the chain.  The scan bodies
    that call mont_mul are traced once, so jaxpr growth stays bounded,
    but a graph holding many mont_muls (e.g. the associative scans of
    batch_mont_inv) compiles slowly on the GPU -- keep hot GPU kernels
    on the RNS path.

    On CPU (the test backend) dispatches to a lax.fori_loop variant --
    the unrolled form makes XLA's CPU pipeline pathologically slow (and
    occasionally crashes it), while loop overhead is irrelevant at test
    sizes."""
    if platform() == "cpu":
        return _mont_mul_loop(ctx, a, b)
    L = ctx.L
    batch_shape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = lb.expand_to(a, (L,) + batch_shape)
    b = lb.expand_to(b, (L,) + batch_shape)
    p = _bcast(ctx.p, len(batch_shape))
    # Flat accumulator over absolute positions [0, 2L]: per-iteration work
    # lands at offset i, so there is no shift/concat in the loop.  Position
    # i is fully consumed (low 16 bits forced to zero, carry pushed up)
    # before iteration i+1.
    T = jnp.zeros((2 * L + 1,) + batch_shape, dtype=jnp.uint32)

    for i in range(L):
        prod = a[i][None] * b                     # [L, B] exact in uint32
        T = T.at[i:i + L].add(prod & LIMB_MASK)
        T = T.at[i + 1:i + L + 1].add(prod >> LIMB_BITS)
        m = ((T[i] & LIMB_MASK) * ctx.pinv) & LIMB_MASK
        q = m[None] * p
        T = T.at[i:i + L].add(q & LIMB_MASK)
        T = T.at[i + 1:i + L + 1].add(q >> LIMB_BITS)
        T = T.at[i + 1].add(T[i] >> LIMB_BITS)    # low 16 bits are zero now

    limbs, _ = lb.normalize(T[L:2 * L + 1])       # [L+1], value < 2p
    p_ext = jnp.concatenate([p, jnp.zeros_like(p[:1])], axis=0)
    p_ext = jnp.broadcast_to(p_ext, (L + 1,) + batch_shape)
    diff, borrow = lb.sub(limbs, p_ext)
    res = lb.select(borrow, limbs, diff)
    return res[:L]


def _mont_mul_loop(ctx: MontCtx, a, b):
    """CIOS as a lax.fori_loop (compile-friendly CPU/test path)."""
    L = ctx.L
    batch_shape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = lb.expand_to(a, (L,) + batch_shape)
    b = lb.expand_to(b, (L,) + batch_shape)
    p = _bcast(ctx.p, len(batch_shape))
    T0 = jnp.zeros((L + 1,) + batch_shape, dtype=jnp.uint32)

    def body(i, T):
        ai = jax.lax.dynamic_index_in_dim(a, i, axis=0, keepdims=False)
        prod = ai[None] * b
        T = T.at[0:L].add(prod & LIMB_MASK)
        T = T.at[1:L + 1].add(prod >> LIMB_BITS)
        m = ((T[0] & LIMB_MASK) * ctx.pinv) & LIMB_MASK
        q = m[None] * p
        T = T.at[0:L].add(q & LIMB_MASK)
        T = T.at[1:L + 1].add(q >> LIMB_BITS)
        carry = T[0] >> LIMB_BITS
        T = jnp.concatenate(
            [T[1:], jnp.zeros((1,) + batch_shape, dtype=jnp.uint32)], axis=0)
        T = T.at[0].add(carry)
        return T

    T = jax.lax.fori_loop(0, L, body, T0)
    limbs, _ = lb.normalize(T)
    p_ext = jnp.concatenate([p, jnp.zeros_like(p[:1])], axis=0)
    p_ext = jnp.broadcast_to(p_ext, (L + 1,) + batch_shape)
    diff, borrow = lb.sub(limbs, p_ext)
    res = lb.select(borrow, limbs, diff)
    return res[:L]


def mont_sqr(ctx: MontCtx, a):
    return mont_mul(ctx, a, a)


def to_mont(ctx: MontCtx, a):
    return mont_mul(ctx, a, _bcast(ctx.r2, a.ndim - 1))


def from_mont(ctx: MontCtx, a):
    """Montgomery form -> canonical residue (multiply by 1)."""
    L = ctx.L
    one = jnp.zeros((L,) + a.shape[1:], dtype=jnp.uint32).at[0].set(1)
    return mont_mul(ctx, a, one)


def mod_add(ctx: MontCtx, a, b):
    """a + b mod p for canonical or Montgomery residues < p."""
    batch_ndim = max(a.ndim, b.ndim) - 1
    s, carry = lb.add(a, b)
    p = _bcast(ctx.p, batch_ndim)
    d, borrow = lb.sub(s, p)
    take_d = carry | (1 - borrow)
    return lb.select(take_d, d, s)


def mod_sub(ctx: MontCtx, a, b):
    batch_ndim = max(a.ndim, b.ndim) - 1
    d, borrow = lb.sub(a, b)
    p = _bcast(ctx.p, batch_ndim)
    d_fix, _ = lb.add(d, p)
    return lb.select(borrow, d_fix, d)


def mod_neg(ctx: MontCtx, a):
    """-a mod p (maps 0 to 0)."""
    batch_ndim = a.ndim - 1
    p = _bcast(ctx.p, batch_ndim)
    d, _ = lb.sub(jnp.broadcast_to(p, a.shape), a)
    return lb.select(lb.is_zero(a), a, d)


def mont_pow(ctx: MontCtx, a, bits):
    """a^e mod p in Montgomery form; e given as bits [nbits, *eb] MSB first.

    a: [L, *batch] Montgomery form.  Leading zero bits are harmless
    (square-and-multiply from 1).  Result shape broadcasts batch with eb."""
    nbits = bits.shape[0]
    batch_shape = jnp.broadcast_shapes(a.shape[1:], bits.shape[1:])
    acc0 = jnp.broadcast_to(_bcast(ctx.one, len(batch_shape)),
                            (ctx.L,) + batch_shape)
    a = lb.expand_to(a, (ctx.L,) + batch_shape)

    def step(acc, bit):
        acc = mont_sqr(ctx, acc)
        acc_mul = mont_mul(ctx, acc, a)
        bit = jnp.broadcast_to(bit, batch_shape)
        return lb.select(bit, acc_mul, acc), None

    acc, _ = jax.lax.scan(step, acc0, bits)
    return acc


def mont_inv(ctx: MontCtx, a):
    """a^-1 mod p in Montgomery form via Fermat (a^(p-2))."""
    return mont_pow(ctx, a, ctx.pm2_bits)


def mont_sqrt(ctx: MontCtx, a):
    """Candidate square root a^((p+1)/4) (p == 3 mod 4); caller must verify."""
    return mont_pow(ctx, a, ctx.pp1d4_bits)


def batch_mont_inv(ctx: MontCtx, a, inv_fn=None):
    """Inverse of every element along axis 1 for one `mont_inv`'s cost.

    Montgomery's batch-inversion trick with prefix/suffix products computed
    by associative scans (log-depth in the N axis), so the whole block needs
    a single Fermat exponentiation: inv_i = prefix_{i-1}*suffix_{i+1}*
    inv(total).  Zero entries map to zero (callers mask separately).

    a: [L, N, *batch] Montgomery form -> same shape of inverses.
    inv_fn: optional replacement for the single mont_inv (same contract:
    Montgomery-form limbs in/out) -- the RNS Fermat chain on the RNS path.
    """
    one = jnp.broadcast_to(_bcast(ctx.one, a.ndim - 1), a.shape)
    is0 = jnp.all(a == 0, axis=0, keepdims=True)       # [1, N, *batch]
    safe = jnp.where(is0, one, a)

    def mul2(x, y):
        return mont_mul(ctx, x, y)

    prefix = jax.lax.associative_scan(mul2, safe, axis=1)
    suffix = jax.lax.associative_scan(mul2, safe, axis=1, reverse=True)
    total_inv = (inv_fn or (lambda t: mont_inv(ctx, t)))(
        prefix[:, -1])                                 # [L, *batch]
    one_col = one[:, :1]
    pre_excl = jnp.concatenate([one_col, prefix[:, :-1]], axis=1)
    suf_excl = jnp.concatenate([suffix[:, 1:], one_col], axis=1)
    inv = mont_mul(ctx, mont_mul(ctx, pre_excl, suf_excl), total_inv[:, None])
    return jnp.where(is0, jnp.zeros_like(inv), inv)
