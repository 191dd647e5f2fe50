"""Signed-digit (NAF) ladder tests.

The RNS Miller loop / decrypt ladders take MSB-first signed digits
(scheme._exp_digits): NAF where the chain is safe, plain bits otherwise.
The reduced pairing value and the scalar-mult result are chain-independent,
so binary and NAF paths must agree exactly (the reference's Element.Pair /
PowBig semantics, bgn.go:294-314, 222-223)."""

import random

import numpy as np
import pytest

from bgn_jax import scheme
from bgn_jax.fieldcore import limbs as lb


@pytest.fixture()
def keyrng(shared_keypair64):
    return shared_keypair64, random.Random(5)


def test_int_to_naf_roundtrip_and_nonadjacent():
    rng = random.Random(11)
    for _ in range(50):
        width = rng.randrange(1, 80)
        v = rng.randrange(1 << width)
        naf = lb.int_to_naf(v, width)
        assert naf.shape == (width + 1,)
        val = 0
        for d in naf:
            val = 2 * val + int(d)
        assert val == v
        nz = np.nonzero(naf)[0]
        assert np.all(np.diff(nz) >= 2), "adjacent nonzero NAF digits"


def test_chain_degenerate_flags_the_bad_cases():
    # exponent 7 over a base of order 3: NAF(7) = (1,0,0,-1); the final
    # add sees V = 8A == -A == addend (mod 3) -> V == addend, flagged
    naf7 = lb.int_to_naf(7, 3)
    assert scheme._chain_degenerate(naf7, (3,))
    # same digits over a large order: safe
    assert not scheme._chain_degenerate(naf7, (1 << 61,))
    # binary chain of 11 = 0b1011 over order 5: at the second add the
    # chain holds V = 4A == -A (mod 5): vertical mid-chain, flagged
    bits11 = lb.int_to_bits(11, 4).astype(np.int64)
    assert scheme._chain_degenerate(bits11, (5,))


def test_exp_digits_prefers_naf_and_strips_leading_zeros():
    d, kind = scheme._exp_digits(0b1011, 8, (1 << 61,))
    assert kind == "naf"
    arr = np.asarray(d)
    assert arr[0] == 1
    val = 0
    for v in arr:
        val = 2 * val + int(v)
    assert val == 0b1011


def test_pairing_naf_matches_binary(keyrng):
    from bgn_jax.ops import rns_pairing as rp

    (pk, sk), rng = keyrng
    dev = pk.dev
    a = pk.encrypt([0, 1, 2, 7, 100, 55], rng=rng).data
    b = pk.encrypt([1, 3, 5, 2, 99, 4], rng=rng).data
    z_bits = rp.pairing_rns(dev.ctx, dev.rns, a, b, dev.n_bits, dev.l_bits)
    z_naf = rp.pairing_rns(dev.ctx, dev.rns, a, b, dev.n_naf, dev.l_bits)
    np.testing.assert_array_equal(np.asarray(z_bits), np.asarray(z_naf))


def test_ladders_naf_match_binary(keyrng):
    from bgn_jax.ops import curve as cv
    from bgn_jax.ops import rns_pairing as rp

    (pk, sk), rng = keyrng
    dev = pk.dev
    a = pk.encrypt([0, 1, 2, 7, 100, 55], rng=rng).data
    ref = cv.normalize(dev.ctx, cv.JacPoint(
        *rp.scalar_mul_rns(dev.ctx, dev.rns, a, sk.q1_bits)))
    got = cv.normalize(dev.ctx, cv.JacPoint(
        *rp.scalar_mul_rns(dev.ctx, dev.rns, a, sk.q1_naf)))
    np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(got.x))
    np.testing.assert_array_equal(np.asarray(ref.y), np.asarray(got.y))
    np.testing.assert_array_equal(np.asarray(ref.inf), np.asarray(got.inf))

    # fp2 pow on a unitary GT element (an L2 ciphertext): signed digits
    # take inverses by conjugation
    z = pk.mult(pk.encrypt([3, 5], rng=rng),
                pk.encrypt([7, 2], rng=rng)).data
    w_ref = rp.fp2_pow_rns(dev.ctx, dev.rns, z, sk.q1_bits)
    w_naf = rp.fp2_pow_rns(dev.ctx, dev.rns, z, sk.q1_naf, unitary=True)
    np.testing.assert_array_equal(np.asarray(w_ref), np.asarray(w_naf))


def test_decrypt_end_to_end_with_naf(keyrng, shared_tables64):
    """Scheme-level decrypt (uses q1_naf) incl. the m = 0 order-q1
    ciphertext whose final ladder add is the vertical -> identity case."""
    (pk, sk), rng = keyrng
    tables = shared_tables64
    ms = [0, 1, 2, 7, 9, 10]
    ct = pk.encrypt(ms, rng=rng)
    assert [int(v) for v in sk.decrypt(ct, pk, tables)] == ms
    prod = pk.mult(ct, pk.encrypt([5] * 6, rng=rng))
    assert [int(v) for v in sk.decrypt(prod, pk, tables)] == \
        [5 * m for m in ms]
