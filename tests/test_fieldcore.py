"""fieldcore vs. exact Python integers (golden model, SURVEY.md §4 item 2)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from bgn_jax.fieldcore import limbs as lb
from bgn_jax.fieldcore import montgomery as mg
from bgn_jax import hostmath as hm

RNG = random.Random(1234)

# jit everything once: eager op-by-op dispatch is ~1000x slower (see
# fieldcore docs); the library's scheme layer always runs under jit.
import jax

j_add = jax.jit(lb.add)
j_sub = jax.jit(lb.sub)
j_geq = jax.jit(lb.geq)
j_normalize = jax.jit(lb.normalize)
j_mod_add = jax.jit(mg.mod_add)
j_mod_sub = jax.jit(mg.mod_sub)
j_mod_neg = jax.jit(mg.mod_neg)
j_mont_mul = jax.jit(mg.mont_mul)
j_to_mont = jax.jit(mg.to_mont)
j_from_mont = jax.jit(mg.from_mont)
j_mont_pow = jax.jit(mg.mont_pow)
j_mont_inv = jax.jit(mg.mont_inv)
j_mont_sqrt = jax.jit(mg.mont_sqrt)
j_batch_inv = jax.jit(mg.batch_mont_inv)
j_bits = jax.jit(lb.limbs_to_bits_msb, static_argnums=1)


@pytest.fixture(scope="module")
def modulus():
    # a ~170-bit prime p == 3 (mod 4), like an A1 field prime for 160-bit keys
    params = hm.gen_a1_params(160, random.Random(7))
    return params.p


@pytest.fixture(scope="module")
def ctx(modulus):
    return mg.make_mont_ctx(modulus)


def rand_residues(p, n, rng=RNG):
    return [rng.randrange(p) for _ in range(n)]


def test_limb_roundtrip():
    L = 12
    xs = [RNG.getrandbits(16 * L - 3) for _ in range(8)]
    arr = lb.ints_to_limbs(xs, L)
    assert lb.limbs_to_ints(arr) == xs


def test_add_sub_geq(ctx, modulus):
    L = ctx.L
    M = 1 << (16 * L)
    xs = rand_residues(M, 16)
    ys = rand_residues(M, 16)
    a = jnp.asarray(lb.ints_to_limbs(xs, L))
    b = jnp.asarray(lb.ints_to_limbs(ys, L))
    s, carry = j_add(a, b)
    got = lb.limbs_to_ints(s)
    for x, y, g, c in zip(xs, ys, got, np.asarray(carry)):
        assert g == (x + y) % M
        assert int(c) == (x + y) // M
    d, borrow = j_sub(a, b)
    got = lb.limbs_to_ints(d)
    for x, y, g, c in zip(xs, ys, got, np.asarray(borrow)):
        assert g == (x - y) % M
        assert int(c) == (1 if x < y else 0)
    assert list(np.asarray(j_geq(a, b))) == [1 if x >= y else 0
                                              for x, y in zip(xs, ys)]


def test_normalize_lazy():
    L = 6
    t = np.array(RNG.getrandbits(31), dtype=np.uint32)
    tarr = np.array([[RNG.getrandbits(28) for _ in range(5)]
                     for _ in range(L)], dtype=np.uint32)
    limbs, overflow = j_normalize(jnp.asarray(tarr))
    for bidx in range(5):
        val = sum(int(tarr[j, bidx]) << (16 * j) for j in range(L))
        got = lb.limbs_to_int(np.asarray(limbs)[:, bidx])
        ov = int(np.asarray(overflow)[bidx])
        assert got + (ov << (16 * L)) == val


def test_mod_add_sub_neg(ctx, modulus):
    p, L = modulus, ctx.L
    xs, ys = rand_residues(p, 16), rand_residues(p, 16)
    a = jnp.asarray(lb.ints_to_limbs(xs, L))
    b = jnp.asarray(lb.ints_to_limbs(ys, L))
    assert lb.limbs_to_ints(j_mod_add(ctx, a, b)) == [
        (x + y) % p for x, y in zip(xs, ys)]
    assert lb.limbs_to_ints(j_mod_sub(ctx, a, b)) == [
        (x - y) % p for x, y in zip(xs, ys)]
    assert lb.limbs_to_ints(j_mod_neg(ctx, a)) == [(-x) % p for x in xs]
    zero = jnp.zeros_like(a)
    assert lb.limbs_to_ints(j_mod_neg(ctx, zero)) == [0] * 16


def test_mont_mul_matches_python(ctx, modulus):
    p, L = modulus, ctx.L
    R = 1 << (16 * L)
    xs, ys = rand_residues(p, 32), rand_residues(p, 32)
    a = jnp.asarray(lb.ints_to_limbs(xs, L))
    b = jnp.asarray(lb.ints_to_limbs(ys, L))
    got = lb.limbs_to_ints(j_mont_mul(ctx, a, b))
    rinv = pow(R, -1, p)
    for x, y, g in zip(xs, ys, got):
        assert g == x * y * rinv % p


def test_mont_roundtrip_and_pow(ctx, modulus):
    p, L = modulus, ctx.L
    xs = rand_residues(p, 8)
    a = jnp.asarray(lb.ints_to_limbs(xs, L))
    am = j_to_mont(ctx, a)
    back = lb.limbs_to_ints(j_from_mont(ctx, am))
    assert back == xs
    # product in Montgomery domain
    prod = lb.limbs_to_ints(mg.from_mont(ctx, j_mont_mul(ctx, am, am)))
    assert prod == [x * x % p for x in xs]
    # powers with a shared host exponent
    e = RNG.getrandbits(90)
    bits = jnp.asarray(lb.int_to_bits(e, 16 * L))
    got = lb.limbs_to_ints(j_from_mont(ctx, j_mont_pow(ctx, am, bits)))
    assert got == [pow(x, e, p) for x in xs]
    # per-element exponents
    es = [RNG.getrandbits(40) for _ in xs]
    ebits = jnp.asarray(np.stack(
        [lb.int_to_bits(ei, 64) for ei in es], axis=1))
    got = lb.limbs_to_ints(j_from_mont(ctx, j_mont_pow(ctx, am, ebits)))
    assert got == [pow(x, ei, p) for x, ei in zip(xs, es)]


def test_mont_inv_sqrt(ctx, modulus):
    p, L = modulus, ctx.L
    xs = rand_residues(p - 1, 8)
    xs = [x + 1 for x in xs]  # nonzero
    am = j_to_mont(ctx, jnp.asarray(lb.ints_to_limbs(xs, L)))
    inv = lb.limbs_to_ints(j_from_mont(ctx, j_mont_inv(ctx, am)))
    for x, g in zip(xs, inv):
        assert g * x % p == 1
    # sqrt of squares
    sq = j_mont_mul(ctx, am, am)
    r = lb.limbs_to_ints(j_from_mont(ctx, j_mont_sqrt(ctx, sq)))
    for x, g in zip(xs, r):
        assert g == x % p or g == (-x) % p


def test_batch_mont_inv(ctx, modulus):
    p, L = modulus, ctx.L
    N, B = 5, 3
    vals = [[RNG.randrange(1, p) for _ in range(B)] for _ in range(N)]
    vals[2][1] = 0  # exercise the zero path
    arr = np.zeros((L, N, B), dtype=np.uint32)
    for i in range(N):
        for j in range(B):
            arr[:, i, j] = lb.int_to_limbs(vals[i][j], L)
    am = j_to_mont(ctx, jnp.asarray(arr.reshape(L, N * B))).reshape(L, N, B)
    inv = j_batch_inv(ctx, am)
    out = j_from_mont(ctx, inv.reshape(L, N * B)).reshape(L, N, B)
    out = np.asarray(out)
    for i in range(N):
        for j in range(B):
            g = lb.limbs_to_int(out[:, i, j])
            if vals[i][j] == 0:
                assert g == 0
            else:
                assert g * vals[i][j] % p == 1


def test_bits_device(ctx):
    L = ctx.L
    xs = [RNG.getrandbits(16 * L - 5) for _ in range(4)]
    a = jnp.asarray(lb.ints_to_limbs(xs, L))
    bits = np.asarray(j_bits(a, 16 * L))
    for i, x in enumerate(xs):
        got = int("".join(str(int(b)) for b in bits[:, i]), 2)
        assert got == x
