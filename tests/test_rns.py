"""RNS Montgomery arithmetic (fieldcore/rns.py) against exact ints,
and the RNS Miller loop (ops/rns_pairing.py) against the XLA reference
path -- they must agree bit-for-bit after domain conversion.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest

from _kernels import clear_mode_kernels

from bgn_jax.fieldcore import limbs as lb
from bgn_jax.fieldcore import montgomery as mg
from bgn_jax.fieldcore import rns as rn


def _rand_prime(bits, rng):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if all(pow(a, c - 1, c) == 1 for a in (2, 3, 5, 7, 11, 13, 17, 19)):
            return c


def _base_a(ctx):
    return rn._primes_desc()[0:2 * ctx.k:2]


def _crt_val(ctx, v_np, b):
    """Exact value from base-A residues (host CRT; v_np is [2k, B])."""
    acc, mod = 0, 1
    for i, mi in enumerate(_base_a(ctx)):
        t = ((int(v_np[i, b]) - acc) * pow(mod % mi, -1, mi)) % mi
        acc += mod * t
        mod *= mi
    return acc


@pytest.mark.parametrize("bits", [80, 220, 515, 800, 2060])
def test_rns_mul_exact(bits):
    """800 and 2060 exercise the wide path (k > 64: staged combine
    reduction + fp32-sum alpha; the narrow single-_red combine would be
    inexact there -- see fieldcore/rns.py _K_NARROW)."""
    rng = random.Random(bits)
    p = _rand_prime(bits, rng)
    ctx = rn.make_rns_ctx(p)
    A = 1
    for q in _base_a(ctx):
        A *= q
    Ainv = pow(A, -1, p)

    B = 48
    xs = [rng.randrange(p) for _ in range(B)]
    ys = [rng.randrange(p) for _ in range(B)]
    xs[:3] = [0, 1, p - 1]
    ys[:3] = [0, p - 1, p - 1]
    xv = rn.RVal(rn.limbs_to_rns(ctx, jnp.asarray(lb.ints_to_limbs(xs, ctx.L))), 1)
    yv = rn.RVal(rn.limbs_to_rns(ctx, jnp.asarray(lb.ints_to_limbs(ys, ctx.L))), 1)

    z = rn.r_mul(ctx, xv, yv)
    z_np = np.asarray(z.v)
    for b in range(B):
        want = xs[b] * ys[b] * Ainv % p
        got = _crt_val(ctx, z_np, b)
        assert got % p == want
        assert got < 3 * p

    # exit conversion is exact and canonical
    back = lb.limbs_to_ints(np.asarray(rn.rns_to_limbs(ctx, z)))
    for b in range(B):
        assert back[b] == xs[b] * ys[b] * Ainv % p


def test_rns_bound_growth_and_domain():
    """Adds/subs up to the pairing's worst-case bounds, then multiply;
    plus limb-Montgomery entry/exit round trip."""
    rng = random.Random(99)
    p = _rand_prime(200, rng)
    ctx = rn.make_rns_ctx(p)
    mctx = mg.make_mont_ctx(p)
    A = 1
    for q in _base_a(ctx):
        A *= q
    Ainv = pow(A, -1, p)

    B = 16
    xs = [rng.randrange(p) for _ in range(B)]
    ys = [rng.randrange(p) for _ in range(B)]
    xv = rn.RVal(rn.limbs_to_rns(ctx, jnp.asarray(lb.ints_to_limbs(xs, ctx.L))), 1)
    yv = rn.RVal(rn.limbs_to_rns(ctx, jnp.asarray(lb.ints_to_limbs(ys, ctx.L))), 1)

    a = rn.r_mul(ctx, xv, yv)
    bb = rn.r_mul(ctx, yv, yv)
    s = a
    for _ in range(8):
        s = rn.r_add(ctx, s, bb)      # bound 27
    d = rn.r_sub(ctx, xv, s)          # bound 28
    z = rn.r_mul(ctx, d, s)           # 28*27 = 756 <= h
    z_np = np.asarray(z.v)
    for b in range(B):
        va = xs[b] * ys[b] * Ainv % p
        vb = ys[b] * ys[b] * Ainv % p
        want = (xs[b] - (va + 8 * vb)) * (va + 8 * vb) * Ainv % p
        assert _crt_val(ctx, z_np, b) % p == want

    # Montgomery-domain entry/exit: x*R limbs -> x*A residues -> x*R limbs
    xm = mg.to_mont(mctx, jnp.asarray(lb.ints_to_limbs(xs, ctx.L)))
    rv = rn.to_rns_mont(ctx, xm)
    rv_np = np.asarray(rv.v)
    for b in range(B):
        assert _crt_val(ctx, rv_np, b) % p == xs[b] * A % p
    back = rn.from_rns_mont(ctx, rv)
    assert lb.limbs_to_ints(np.asarray(back)) == \
        lb.limbs_to_ints(np.asarray(xm))


def test_rns_miller_matches_xla(shared_keypair64):
    """The RNS Miller loop agrees bit-for-bit with the XLA reference path
    (same pairing, different field representation)."""
    from bgn_jax.ops import pairing as pairing_mod
    from bgn_jax.ops import rns_pairing

    rng = random.Random(5)
    pk, _sk = shared_keypair64
    dev = pk.dev
    assert dev.rns is not None

    ms = [0, 1, 2, 7, 100, 55]
    ks = [1, 3, 5, 2, 99, 4]
    a = pk.encrypt(ms, rng=rng).data
    b = pk.encrypt(ks, rng=rng).data

    f_ref = pairing_mod.miller_loop(dev.ctx, a, b, dev.n_bits)
    f_rns = rns_pairing.miller_loop_rns(dev.ctx, dev.rns, a, b, dev.n_bits)
    np.testing.assert_array_equal(np.asarray(f_ref), np.asarray(f_rns))

    # full pairing (Miller + RNS final exponentiation) bit-identical too
    z_ref = pairing_mod.final_exponentiation(dev.ctx, f_ref, dev.l_bits)
    z_rns = rns_pairing.pairing_rns(dev.ctx, dev.rns, a, b,
                                    dev.n_bits, dev.l_bits)
    np.testing.assert_array_equal(np.asarray(z_ref), np.asarray(z_rns))


def test_rns_scheme_end_to_end(monkeypatch, shared_keypair64,
                               shared_tables64):
    """Force the RNS pairing inside the scheme: EMult + decrypt round trip."""
    monkeypatch.setattr(
        __import__("bgn_jax.ops.pairing", fromlist=["x"]), "_RNS_MODE", "1")

    rng = random.Random(21)
    pk, sk = shared_keypair64
    tables = shared_tables64

    ms = [0, 1, 5, 9]
    ks = [7, 3, 0, 9]
    c1 = pk.encrypt(ms, rng=rng)
    c2 = pk.encrypt(ks, rng=rng)
    prod = pk.mult(c1, c2)
    got = sk.decrypt(prod, pk, tables)
    assert list(got) == [m * k for m, k in zip(ms, ks)]


def test_rns_encrypt_matches_limb(monkeypatch, shared_keypair64):
    """The RNS fixed-base window ladder (fixed_base_mul_rns) produces
    bit-identical ciphertexts to the limb path, incl. m=0 / r=0 lanes
    (identity handling is flag-based)."""

    from bgn_jax.ops import pairing as pairing_mod

    pk, _sk = shared_keypair64
    ms = [0, 1, -7, 100, 55, 13, 0, 2]
    rs = [5, 0, 12345, 1, 999999, 424242, 0, pk.n - 1]
    a1 = pk.encrypt_with_randomness(ms, rs)
    d1 = pk.encrypt_deterministic(ms)

    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    a2 = pk.encrypt_with_randomness(ms, rs)
    d2 = pk.encrypt_deterministic(ms)
    clear_mode_kernels()

    for u, v in ((a1, a2), (d1, d2)):
        np.testing.assert_array_equal(np.asarray(u.data.x),
                                      np.asarray(v.data.x))
        np.testing.assert_array_equal(np.asarray(u.data.y),
                                      np.asarray(v.data.y))
        np.testing.assert_array_equal(np.asarray(u.data.inf),
                                      np.asarray(v.data.inf))


def test_rns_add_complete_matches_limb(monkeypatch, shared_keypair64):
    """add_complete_rns (the L1 Add/Sub fast path, VERDICT r4 weak #4)
    is bit-identical to the complete limb madd on every edge: generic
    a+b, a+a (doubling), a+(-a) (identity), O+b, a+O, O+O."""

    from bgn_jax.ops import pairing as pairing_mod

    pk, _sk = shared_keypair64
    rng = random.Random(77)
    ms = [rng.randrange(90) for _ in range(8)]
    ks = [rng.randrange(90) for _ in range(8)]
    a = pk.encrypt(ms, rng=rng)
    b = pk.encrypt(ks, rng=rng)
    o = pk.encrypt_zero(batch=8)          # deterministic E(0) = O
    na = pk.sub(o, a)                     # -a
    cases = [(a, b), (a, a), (a, na), (o, b), (a, o), (o, o)]
    base = [pk.add(u, v) for u, v in cases]

    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    try:
        got = [pk.add(u, v) for u, v in cases]
    finally:
        clear_mode_kernels()
    for u, v in zip(base, got):
        np.testing.assert_array_equal(np.asarray(u.data.x),
                                      np.asarray(v.data.x))
        np.testing.assert_array_equal(np.asarray(u.data.y),
                                      np.asarray(v.data.y))
        np.testing.assert_array_equal(np.asarray(u.data.inf),
                                      np.asarray(v.data.inf))


def test_rns_decrypt_matches_limb(monkeypatch, shared_keypair64,
                                  shared_tables64):
    """RNS decrypt ladders (scalar_mul_rns / fp2_pow_rns) produce the
    same decrypts as the limb path at both levels, incl. zero/negatives."""

    from bgn_jax.ops import pairing as pairing_mod

    rng = random.Random(31)
    pk, sk = shared_keypair64
    tables = shared_tables64
    ms = [0, 1, -7, 55, 100, -100, 13, 2]
    ct = pk.encrypt(ms, rng=rng)
    l2 = pk.make_l2(ct)

    v1, ok1 = sk.decrypt_with_status(ct, pk, tables)
    w1, okw1 = sk.decrypt_with_status(l2, pk, tables)

    # the dispatch is trace-time: drop cached traces before flipping mode
    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    v2, ok2 = sk.decrypt_with_status(ct, pk, tables)
    w2, okw2 = sk.decrypt_with_status(l2, pk, tables)
    clear_mode_kernels()

    assert list(v1) == list(v2) == ms
    assert list(ok1) == list(ok2) == [True] * len(ms)
    assert list(w1) == list(w2) == ms
    assert list(okw1) == list(okw2) == [True] * len(ms)


def test_rns_mult_const_matches_limb(monkeypatch, shared_keypair64,
                                     shared_tables64):
    """The per-element RNS MultConstant ladders (scalar_mul_vec_rns /
    fp2_pow_vec_rns) are bit-identical to the complete limb ladders at
    both levels, over adversarial constants: 0, +-1, +-2, k == 0 mod n
    (order multiples), k = n - 1, and identity-base lanes (VERDICT r3
    item 3; reference MultConst semantics bgn.go:253-291)."""

    from bgn_jax.ops import pairing as pairing_mod

    rng = random.Random(47)
    pk, sk = shared_keypair64
    n = pk.n
    ms = [3, 1, 7, 9, 5, 2, 0, 4, 6, 8]
    ks = [0, 1, -1, 2, -2, int(n), int(2 * n), int(-n), 5, 12]
    ct = pk.encrypt(ms, rng=rng)
    det = pk.encrypt_deterministic([0] * len(ms))   # identity-base lanes
    l2 = pk.make_l2(ct)

    a1 = pk.mult_const(ct, ks)
    d1 = pk.mult_const(det, ks)
    w1 = pk.mult_const(l2, ks)

    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    a2 = pk.mult_const(ct, ks)
    d2 = pk.mult_const(det, ks)
    w2 = pk.mult_const(l2, ks)
    clear_mode_kernels()

    for u, v in ((a1, a2), (d1, d2)):
        np.testing.assert_array_equal(np.asarray(u.data.x),
                                      np.asarray(v.data.x))
        np.testing.assert_array_equal(np.asarray(u.data.y),
                                      np.asarray(v.data.y))
        np.testing.assert_array_equal(np.asarray(u.data.inf),
                                      np.asarray(v.data.inf))
    np.testing.assert_array_equal(np.asarray(w1.data), np.asarray(w2.data))

    # semantics vs decrypt: k*m mod n, negatives via the failsafe retry
    tables = shared_tables64
    clear_mode_kernels()
    got = sk.decrypt_failsafe(a2, pk, tables)
    want = []
    for m, k in zip(ms, ks):
        v = (m * k) % n
        want.append(v if v <= pk.msg_space else v - n)
    assert list(got) == want


def test_rns_mult_const_wide_exponent_falls_back(monkeypatch,
                                                 shared_keypair64,
                                                 shared_tables64):
    """Exponents ~ n bits exceed the vec-ladder safety bound
    (2^nbits < min(q1, q2)) and must route through the complete limb
    ladder, still giving correct results."""

    from bgn_jax.ops import pairing as pairing_mod

    rng = random.Random(53)
    pk, sk = shared_keypair64
    tables = shared_tables64
    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    ms = [2, 3, 5]
    ct = pk.encrypt(ms, rng=rng)
    # k = n - 1 == -1 (mod n): nbits ~ 64 > key_bits//2 - 2 -> limb path
    got = sk.decrypt_failsafe(pk.mult_const(ct, int(pk.n - 1)), pk, tables)
    clear_mode_kernels()
    assert list(got) == [-2, -3, -5]


def test_rns_rerandomize_matches_limb(monkeypatch, shared_keypair64):
    """L1/L2 re-randomization (pt * Q^r, z * e(Q,Q)^r) on the RNS path is
    bit-identical to the limb path, incl. identity points and r = 0."""
    from bgn_jax import scheme as s
    from bgn_jax.ops import pairing as pairing_mod

    pk, _sk = shared_keypair64
    ms = [0, 1, 5, 0, 9, 13, 2, 7]              # m = 0: identity points
    rs = [0, 1, 12345, 0, pk.n - 1, 77, 5, 3]
    ct = pk.encrypt_deterministic(ms)
    l2 = pk.make_l2(ct)
    r_digits, _ = s._signed_digits(rs, pk.n)
    r_bits, _ = s._signed_bits(rs, pk.n)
    a1 = s._rerand_l1_kernel(pk.dev, ct.data, r_digits)
    w1 = s._rerand_l2_kernel(pk.dev, l2.data, r_bits)

    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    try:
        a2 = s._rerand_l1_kernel(pk.dev, ct.data, r_digits)
        w2 = s._rerand_l2_kernel(pk.dev, l2.data, r_bits)
    finally:
        clear_mode_kernels()
    for u, v in zip(a1, a2):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
