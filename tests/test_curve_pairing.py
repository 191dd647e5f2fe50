"""Device curve / F_p^2 / pairing kernels vs. the host golden model."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bgn_jax import hostmath as hm
from bgn_jax.fieldcore import limbs as lb
from bgn_jax.fieldcore import montgomery as mg
from bgn_jax.ops import curve as cv
from bgn_jax.ops import fp2, pairing
from bgn_jax.utils import convert

KEY_BITS = 160


@pytest.fixture(scope="module")
def setup():
    rng = random.Random(99)
    params = hm.gen_a1_params(KEY_BITS, rng)
    ctx = mg.make_mont_ctx(params.p)
    G = hm.find_generator(params, rng)
    return params, ctx, G, rng


j_normalize = jax.jit(cv.normalize)
j_add_affine = jax.jit(lambda ctx, a, b: cv.normalize(ctx, cv.add_affine(ctx, a, b)))
j_scalar_mul = jax.jit(lambda ctx, b, bits: cv.normalize(ctx, cv.scalar_mul(ctx, b, bits)))
j_fp2_mul = jax.jit(fp2.mul)
j_fp2_sqr = jax.jit(fp2.sqr)
j_fp2_inv = jax.jit(fp2.inv)
j_fp2_pow = jax.jit(fp2.pow_bits)
j_pairing = jax.jit(pairing.pairing)


def host_points(params, G, ks):
    return [hm.ec_mul(k, G, params.p) for k in ks]


def test_fp2_ops(setup):
    params, ctx, G, rng = setup
    p = params.p
    xs = [(rng.randrange(p), rng.randrange(p)) for _ in range(8)]
    ys = [(rng.randrange(p), rng.randrange(p)) for _ in range(8)]
    a = convert.fp2_from_host(ctx, xs)
    b = convert.fp2_from_host(ctx, ys)
    got = convert.fp2_to_host(ctx, j_fp2_mul(ctx, a, b))
    assert got == [hm.fp2_mul(x, y, p) for x, y in zip(xs, ys)]
    got = convert.fp2_to_host(ctx, j_fp2_sqr(ctx, a))
    assert got == [hm.fp2_sqr(x, p) for x in xs]
    got = convert.fp2_to_host(ctx, j_fp2_inv(ctx, a))
    assert got == [hm.fp2_inv(x, p) for x in xs]
    e = rng.getrandbits(60)
    bits = jnp.asarray(lb.int_to_bits(e, 64))
    got = convert.fp2_to_host(ctx, j_fp2_pow(ctx, a, bits))
    assert got == [hm.fp2_pow(x, e, p) for x in xs]


def test_point_roundtrip_and_add(setup):
    params, ctx, G, rng = setup
    p = params.p
    ks = [rng.randrange(1, params.n) for _ in range(6)]
    As = host_points(params, G, ks)
    Bs = host_points(params, G, [rng.randrange(1, params.n) for _ in range(6)])
    a = convert.affine_from_host(ctx, As)
    b = convert.affine_from_host(ctx, Bs)
    assert convert.affine_to_host(ctx, a) == As
    got = convert.affine_to_host(ctx, j_add_affine(ctx, a, b))
    assert got == [hm.ec_add(A, B, p) for A, B in zip(As, Bs)]


def test_point_add_edge_cases(setup):
    params, ctx, G, rng = setup
    p = params.p
    A = hm.ec_mul(12345, G, p)
    cases_a = [A, A, None, A, None]
    cases_b = [A,                      # doubling via general add
               hm.ec_neg(A, p),        # inverse -> identity
               A,                      # O + A
               None,                   # A + O
               None]                   # O + O
    a = convert.affine_from_host(ctx, cases_a)
    b = convert.affine_from_host(ctx, cases_b)
    got = convert.affine_to_host(ctx, j_add_affine(ctx, a, b))
    want = [hm.ec_add(x, y, p) for x, y in zip(cases_a, cases_b)]
    assert got == want


def test_scalar_mul_shared_and_batched(setup):
    params, ctx, G, rng = setup
    p = params.p
    base_pts = host_points(params, G, [rng.randrange(1, params.n)
                                       for _ in range(5)])
    base = convert.affine_from_host(ctx, base_pts)
    # shared exponent (includes leading zeros)
    e = rng.getrandbits(70)
    bits = jnp.asarray(lb.int_to_bits(e, 96))
    got = convert.affine_to_host(ctx, j_scalar_mul(ctx, base, bits))
    assert got == [hm.ec_mul(e, P, p) for P in base_pts]
    # per-element exponents, including 0 and 1
    es = [0, 1, rng.getrandbits(50), rng.getrandbits(50), params.n]
    ebits = jnp.asarray(np.stack(
        [lb.int_to_bits(ei, params.n.bit_length() + 1) for ei in es], axis=1))
    got = convert.affine_to_host(ctx, j_scalar_mul(ctx, base, ebits))
    assert got == [hm.ec_mul(ei, P, p) for ei, P in zip(es, base_pts)]
    # identity base
    ident = convert.affine_from_host(ctx, [None, None])
    bits = jnp.asarray(lb.int_to_bits(17, 8))
    got = convert.affine_to_host(ctx, j_scalar_mul(ctx, ident, bits))
    assert got == [None, None]


def test_pairing_matches_host_and_bilinear(setup):
    params, ctx, G, rng = setup
    p, n = params.p, params.n
    n_bits = jnp.asarray(lb.int_to_bits(n, KEY_BITS))
    l_bits = jnp.asarray(lb.int_to_bits(params.l, params.l.bit_length()))
    a_sc, b_sc = rng.randrange(2, n), rng.randrange(2, n)
    As = [G, hm.ec_mul(a_sc, G, p), None, G]
    Bs = [G, hm.ec_mul(b_sc, G, p), G, None]
    a = convert.affine_from_host(ctx, As)
    b = convert.affine_from_host(ctx, Bs)
    got = convert.fp2_to_host(ctx, j_pairing(ctx, a, b, n_bits, l_bits))
    want = [hm.tate_pairing(A, B, params) for A, B in zip(As, Bs)]
    assert got == want
    # bilinearity against host exponentiation
    e_gg = want[0]
    assert want[1] == hm.fp2_pow(e_gg, a_sc * b_sc % n, p)
    assert want[2] == hm.FP2_ONE and want[3] == hm.FP2_ONE
    # non-degeneracy
    assert e_gg != hm.FP2_ONE
