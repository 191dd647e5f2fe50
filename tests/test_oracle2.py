"""Cross-validation of the two independent host pairing oracles
(hostmath.tate_pairing vs hostmath2.tate_pairing_indep) -- VERDICT r3
item 5: the oracle behind the repo's bit-exactness claims must not be
single-sourced.  Host-only (no JAX), so this runs in seconds.

The reference oracle both implementations model is PBC's Tate pairing
(/root/reference/bgn.go:300 Element.Pair); real reference-produced
fixtures (tools/dump_reference.go) remain the final gate
(docs/INTEROP.md)."""

import random

from bgn_jax import hostmath as hm
from bgn_jax import hostmath2 as hm2


def _random_subgroup_point(params, rng):
    return hm.random_curve_point(params, rng)


def test_pairing_oracles_agree_many_keys():
    """The two pairings agree bit-for-bit over ~100 random keys of
    varying sizes and random subgroup points."""
    rng = random.Random(20260820)
    sizes = [16, 20, 24, 28, 32, 40, 48, 56, 64]
    keys = 0
    while keys < 100:
        bits = sizes[keys % len(sizes)]
        params = hm.gen_a1_params(bits, rng)
        P = _random_subgroup_point(params, rng)
        Q = _random_subgroup_point(params, rng)
        z1 = hm.tate_pairing(P, Q, params)
        z2 = hm2.tate_pairing_indep(P, Q, params)
        assert z1 == z2, (bits, params, P, Q)
        # symmetric-pairing sanity on the independent oracle too
        assert hm2.tate_pairing_indep(Q, P, params) == z1
        keys += 1


def test_pairing_oracles_agree_realistic_size():
    """One realistic key size (160-bit) incl. bilinearity
    e(aP, bQ) = e(P, Q)^(a*b) checked on the independent oracle against
    the primary one."""
    rng = random.Random(7)
    params = hm.gen_a1_params(160, rng)
    p = params.p
    P = _random_subgroup_point(params, rng)
    Q = _random_subgroup_point(params, rng)
    base1 = hm.tate_pairing(P, Q, params)
    base2 = hm2.tate_pairing_indep(P, Q, params)
    assert base1 == base2
    for a, b in [(2, 3), (5, 1), (17, 29)]:
        lhs = hm2.tate_pairing_indep(hm.ec_mul(a, P, p),
                                     hm.ec_mul(b, Q, p), params)
        assert lhs == hm.fp2_pow(base1, a * b, p)
        assert lhs == hm.tate_pairing(hm.ec_mul(a, P, p),
                                      hm.ec_mul(b, Q, p), params)


def test_weil_tate_triangle():
    """w(P, phi(Q))^((p^2-1)/n) == t(P,phi(Q))/t(phi(Q),P): a third
    independent consistency relation between the Miller evaluations,
    over several keys."""
    rng = random.Random(99)
    for bits in (16, 24, 32, 48):
        params = hm.gen_a1_params(bits, rng)
        P = _random_subgroup_point(params, rng)
        Q = _random_subgroup_point(params, rng)
        assert hm2.weil_tate_consistent(P, Q, params), (bits, params)


def test_identity_inputs():
    rng = random.Random(3)
    params = hm.gen_a1_params(24, rng)
    P = _random_subgroup_point(params, rng)
    assert hm2.tate_pairing_indep(None, P, params) == (1, 0)
    assert hm2.tate_pairing_indep(P, None, params) == (1, 0)
