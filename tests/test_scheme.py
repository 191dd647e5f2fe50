"""Scheme-level tests: the reference's semantics end-to-end on device.

Covers the behavior of bgn_test.go / cmd/main.go truth tables at a reduced
key size (160 bits) for CPU-test speed; kernels are size-generic and the
512-bit reference constants run in test_reference_constants.py."""

import random

import numpy as np
import pytest

from bgn_jax import hostmath as hm
from bgn_jax import scheme
from bgn_jax.utils import convert

KEY_BITS = 64   # shared_keypair width (see conftest r5 note)
MSG_SPACE = 1021


@pytest.fixture(scope="module")
def keypair(shared_keypair):
    return shared_keypair


def test_encrypt_decrypt_roundtrip(keypair):
    pk, sk, tables = keypair
    ms = [0, 1, 2, 17, 1000, -1, -5, -1000]
    ct = pk.encrypt(ms)
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert list(ok) == [True] * len(ms)
    assert list(vals) == ms


def test_encrypt_matches_golden_fixed_randomness(keypair):
    """Value-compat check SURVEY.md §4 requires: identical (key, m, r) =>
    identical ciphertext points vs the exact host model."""
    pk, sk, tables = keypair
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host,
                      R=sk.r, msg_space=pk.msg_space)
    ms = [0, 1, 5, 999]
    rs = [3, 12345, 0, 2 ** 40 + 7]
    ct = pk.encrypt_with_randomness(ms, rs)
    got = convert.affine_to_host(pk.dev.ctx, ct.data)
    want = [hm.golden_encrypt(gk, m, r) for m, r in zip(ms, rs)]
    assert got == want


def test_encrypt_deterministic(keypair):
    pk, sk, tables = keypair
    ct = pk.encrypt_deterministic([0, 1, 7])
    pts = convert.affine_to_host(pk.dev.ctx, ct.data)
    assert pts[0] is None  # E_det(0) = O (encryptZero, bgn.go:562)
    assert pts[1] == pk.P_host
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert list(vals) == [0, 1, 7] and all(ok)


def test_add_sub_neg_l1(keypair):
    pk, sk, tables = keypair
    a = pk.encrypt([3, 0, 500, 7])
    b = pk.encrypt([4, 0, 500, 9])
    assert list(sk.decrypt(pk.add(a, b), pk, tables)) == [7, 0, 1000, 16]
    assert list(sk.decrypt(pk.sub(a, b), pk, tables)) == [-1, 0, 0, -2]
    assert list(sk.decrypt(pk.neg(a), pk, tables)) == [-3, 0, -500, -7]


def test_mult_and_l2_ops(keypair):
    pk, sk, tables = keypair
    a = pk.encrypt([3, 0, 1, 30])
    b = pk.encrypt([4, 5, 0, 30])
    prod = pk.mult(a, b)
    assert prod.level2
    assert list(sk.decrypt(prod, pk, tables)) == [12, 0, 0, 900]
    # L2 add/sub.  1800 exceeds the BSGS range at msg_space 1021
    # (max m = bound^2 + bound_t + 1 = 1058, gsbs.go:98): the reference's
    # Decrypt errors there too, and DecryptFailSafe maps it to 0.
    s = pk.add(prod, prod)
    vals, ok = sk.decrypt_with_status(s, pk, tables)
    assert list(vals[:3]) == [24, 0, 0] and all(ok[:3])
    assert not ok[3]
    assert list(sk.decrypt_failsafe(s, pk, tables)) == [24, 0, 0, 0]
    d = pk.sub(s, prod)
    assert list(sk.decrypt(d, pk, tables)) == [12, 0, 0, 900]
    # negative L2 values decrypt via the inverse retry
    n = pk.neg(prod)
    assert list(sk.decrypt(n, pk, tables)) == [-12, 0, 0, -900]


def test_mixed_level_promotion(keypair):
    pk, sk, tables = keypair
    a = pk.encrypt([5, 2])
    b = pk.encrypt([7, 3])
    l2 = pk.mult(a, b)                       # [35, 6]
    mixed = pk.add(l2, a)                    # promotes a via makeL2
    assert mixed.level2
    assert list(sk.decrypt(mixed, pk, tables)) == [40, 8]
    mixed2 = pk.add(a, l2)
    assert list(sk.decrypt(mixed2, pk, tables)) == [40, 8]
    sub_mixed = pk.sub(l2, a)
    assert list(sk.decrypt(sub_mixed, pk, tables)) == [30, 4]


def test_mult_const(keypair):
    pk, sk, tables = keypair
    a = pk.encrypt([3, 7, 10])
    assert list(sk.decrypt(pk.mult_const(a, 5), pk, tables)) == [15, 35, 50]
    assert list(sk.decrypt(pk.mult_const(a, [2, 0, -3]), pk, tables)) == \
        [6, 0, -30]
    l2 = pk.make_l2(a)
    assert list(sk.decrypt(pk.mult_const(l2, 4), pk, tables)) == [12, 28, 40]
    assert list(sk.decrypt(pk.mult_const(l2, -2), pk, tables)) == \
        [-6, -14, -20]


def test_make_l2_of_zero(keypair):
    """makeL2(E_det(0)) = e(O, P) = 1 must decrypt to 0 (reference
    MultPoly zero padding, poly.go:129-137)."""
    pk, sk, tables = keypair
    z = pk.encrypt_zero(batch=2)
    l2 = pk.make_l2(z)
    vals, ok = sk.decrypt_with_status(l2, pk, tables)
    assert list(vals) == [0, 0] and all(ok)


def test_decrypt_failsafe_out_of_range(keypair):
    pk, sk, tables = keypair
    bound = int(np.ceil(np.sqrt(MSG_SPACE)))
    max_m = bound * bound + bound + 2     # largest table-reachable value
    ct = pk.encrypt([1, max_m + 50, 3])
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert list(ok) == [True, False, True]
    fs = sk.decrypt_failsafe(ct, pk, tables)
    assert list(fs) == [1, 0, 3]
    with pytest.raises(ValueError):
        sk.decrypt(ct, pk, tables)


def test_truth_tables(keypair):
    """cmd/main.go runSimpleCheck truth tables (cmd/main.go:74-107)."""
    pk, sk, tables = keypair
    zero = pk.encrypt([0])
    one = pk.encrypt([1])
    negone = pk.encrypt([-1])

    def d(ct):
        return int(sk.decrypt_failsafe(ct, pk, tables)[0])

    assert d(pk.add(zero, zero)) == 0
    assert d(pk.add(zero, one)) == 1
    assert d(pk.add(one, one)) == 2
    assert d(pk.mult(zero, zero)) == 0
    assert d(pk.mult(zero, one)) == 0
    assert d(pk.mult(one, one)) == 1
    assert d(pk.add(zero, pk.neg(one))) == -1
    assert d(pk.add(zero, negone)) == -1
    assert d(pk.add(one, pk.neg(one))) == 0
    assert d(pk.mult(one, pk.neg(one))) == -1
    assert d(pk.mult(pk.neg(one), pk.neg(one))) == 1


def test_randomized_mode():
    """Deterministic=false paths (bgn.go:260-268, 302-311, 462-475):
    re-randomized results still decrypt correctly and ciphertexts differ."""
    # SAME seed as conftest.shared_keypair: identical key material (the
    # deterministic flag is host-side only), so the ladder/pairing
    # kernel caches are shared instead of recompiling for a fresh prime
    rng = random.Random(5)
    pk, sk = scheme.keygen(KEY_BITS, MSG_SPACE, deterministic=False, rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)
    a = pk.encrypt([5, 9], rng=rng)
    b = pk.encrypt([2, 4], rng=rng)
    s1 = pk.add(a, b, rng=rng)
    s2 = pk.add(a, b, rng=rng)
    # randomization makes the two results different ciphertexts...
    p1 = convert.affine_to_host(pk.dev.ctx, s1.data)
    p2 = convert.affine_to_host(pk.dev.ctx, s2.data)
    assert p1 != p2
    # ...that decrypt identically
    assert list(sk.decrypt(s1, pk, tables)) == [7, 13]
    assert list(sk.decrypt(s2, pk, tables)) == [7, 13]
    m1 = pk.mult(a, b, rng=rng)
    assert list(sk.decrypt(m1, pk, tables)) == [10, 36]
    mc = pk.mult_const(a, 3, rng=rng)
    assert list(sk.decrypt(mc, pk, tables)) == [15, 27]


def test_encrypt_device_randomness(keypair):
    """On-device threefry randomness path: correct decrypts, key-derived
    determinism, key separation."""
    import jax as _jax

    pk, sk, tables = keypair
    ms = [0, 5, 1000, -3]
    ct = pk.encrypt_device(ms, _jax.random.PRNGKey(42))
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert list(vals) == ms and all(ok)

    ct2 = pk.encrypt_device(ms, _jax.random.PRNGKey(42))
    np.testing.assert_array_equal(np.asarray(ct.data.x),
                                  np.asarray(ct2.data.x))
    ct3 = pk.encrypt_device(ms, _jax.random.PRNGKey(7))
    assert not np.array_equal(np.asarray(ct.data.x), np.asarray(ct3.data.x))


def test_plaintext_wrapper_and_string_repr(keypair):
    """Plaintext/NewPlaintext (plaintext.go:21-30) and the String()
    analogs (ciphertext.go:60-73): canonical hex, one element per line,
    identical for equal deterministic ciphertexts."""
    from bgn_jax import encoding, polyct

    pk, sk, tables = keypair
    pt = encoding.new_plaintext(pk, 42)
    assert pt.value == 42 and pt.pk is pk

    ct = pk.encrypt_deterministic([3, 7])
    s = ct.string(pk)
    assert len(s.splitlines()) == 2
    assert s == pk.encrypt_deterministic([3, 7]).string(pk)
    l2 = pk.mult(ct, ct)
    assert len(l2.string(pk).splitlines()) == 2

    ppt = encoding.new_poly_plaintext(pk, 2.5)
    pct = polyct.encrypt_poly(pk, ppt, rng=random.Random(4))
    assert pct.string(pk).endswith("\n")
