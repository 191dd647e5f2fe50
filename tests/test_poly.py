"""Polynomial encoding + poly-ciphertext tests (mirrors poly_test.go)."""

import random

import pytest

from bgn_jax import encoding, polyct, scheme

KEY_BITS = 64   # shared_keypair width (see conftest r5 note)
MSG_SPACE = 1021
# reference test constants: POLYBASE=3, FPSCALEBASE=3, FPPREC=0.0001
# (bgn_test.go:8-13)


@pytest.fixture(scope="module")
def keypair(shared_keypair):
    return shared_keypair


def approx1(a, b):
    """%.1f comparison used throughout poly_test.go (e.g. :75)."""
    return f"{a:.1f}" == f"{b:.1f}"


def test_encode_balanced(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 9.123)
    assert approx1(p1.poly_eval(), 9.123)          # poly_test.go:68-78
    assert all(c in (-1, 0, 1) for c in p1.coefficients)


def test_encode_unbalanced(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_unbalanced_plaintext(pk, 9.123)
    assert approx1(p1.poly_eval(), 9.123)          # poly_test.go:80-90
    assert all(c in (0, 1, 2) for c in p1.coefficients)


def test_encode_integers(keypair):
    pk, _, _ = keypair
    for v in [0, 1, 2, 3, 7, 100, 1000]:
        b = encoding.balanced_encode(pk._encoding_tables, v, 3)
        assert encoding.PolyPlaintext(pk, b[0], b[1], 0).poly_eval() == v
        u = encoding.unbalanced_encode(pk._encoding_tables, v, 3)
        assert encoding.PolyPlaintext(pk, u[0], u[1], 0).poly_eval() == v


def test_encrypt_decrypt_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 9.123)
    c1 = polyct.encrypt_poly(pk, p1)
    got = polyct.decrypt_poly(sk, c1, pk, tables).poly_eval()
    assert approx1(got, 9.123)                     # poly_test.go:92-104


def test_add_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 0.1)
    p2 = encoding.new_poly_plaintext(pk, 4.2)
    c1 = polyct.encrypt_poly(pk, p1)
    c2 = polyct.encrypt_poly(pk, p2)
    r = polyct.add_poly(pk, c1, c2)
    got = polyct.decrypt_poly(sk, r, pk, tables).poly_eval()
    want = p1.poly_eval() + p2.poly_eval()
    assert approx1(got, want)                      # poly_test.go:106-123


def test_add_poly_l2(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 50.1)
    p2 = encoding.new_poly_plaintext(pk, 41.2)
    c1 = polyct.make_poly_l2(pk, polyct.encrypt_poly(pk, p1))
    c2 = polyct.make_poly_l2(pk, polyct.encrypt_poly(pk, p2))
    r = polyct.add_poly(pk, c1, c2)
    got = polyct.decrypt_poly(sk, r, pk, tables).poly_eval()
    want = p1.poly_eval() + p2.poly_eval()
    assert approx1(got, want)                      # poly_test.go:125-144


def test_mult_const_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 9.13)
    p2 = encoding.new_poly_plaintext(pk, 4.12)
    c1 = polyct.encrypt_poly(pk, p1)
    want = p1.poly_eval() * p2.poly_eval()
    r = polyct.mult_const_poly(pk, c1, 4.12)
    got = polyct.decrypt_poly(sk, r, pk, tables).poly_eval()
    assert approx1(got, want)                      # poly_test.go:146-161 L1
    c1l2 = polyct.make_poly_l2(pk, c1)
    r2 = polyct.mult_const_poly(pk, c1l2, 4.12)
    got2 = polyct.decrypt_poly(sk, r2, pk, tables).poly_eval()
    assert approx1(got2, want)                     # poly_test.go:163-169 L2


def test_mult_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 1.1)
    p2 = encoding.new_poly_plaintext(pk, 40.2)
    c1 = polyct.encrypt_poly(pk, p1)
    c2 = polyct.encrypt_poly(pk, p2)
    r = polyct.mult_poly(pk, c1, c2)
    assert r.level2
    got = polyct.decrypt_poly(sk, r, pk, tables).poly_eval()
    want = p1.poly_eval() * p2.poly_eval()
    assert approx1(got, want)                      # poly_test.go:172-189


def test_sub_and_neg_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 5.0)
    p2 = encoding.new_poly_plaintext(pk, 2.0)
    c1 = polyct.encrypt_poly(pk, p1)
    c2 = polyct.encrypt_poly(pk, p2)
    r = polyct.sub_poly(pk, c1, c2)
    assert approx1(polyct.decrypt_poly(sk, r, pk, tables).poly_eval(), 3.0)


def test_eval_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 27.0)
    c1 = polyct.encrypt_poly(pk, p1)
    ct = polyct.eval_poly(pk, c1)
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert ok[0] and int(vals[0]) == 27            # poly.go:58-68


def test_negative_constant_poly(keypair):
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 6.0)
    c1 = polyct.encrypt_poly(pk, p1)
    r = polyct.mult_const_poly(pk, c1, -2.0)
    assert approx1(polyct.decrypt_poly(sk, r, pk, tables).poly_eval(), -12.0)


def test_rationalize_roundtrip(keypair):
    pk, _, _ = keypair
    for x in [0.5, 0.25, 0.1, 0.0111, 0.99]:
        num, powr = encoding.rationalize(x, 3, 0.0001)
        approx = num / (3.0 ** powr)
        assert abs(approx - x) <= 0.0001 + 1e-12


def _slice_poly(pct, b):
    """Extract poly b from a (degree, B) batch as a plain (degree,)
    PolyCiphertext (test-only helper)."""
    from bgn_jax.ops import curve as cv
    from bgn_jax.scheme import Ciphertext

    if pct.ct.level2:
        ct = Ciphertext(pct.ct.data[:, :, :, b], True)
    else:
        d = pct.ct.data
        ct = Ciphertext(cv.AffinePoint(d.x[:, :, b], d.y[:, :, b],
                                       d.inf[:, b]), False)
    return polyct.PolyCiphertext(ct, pct.degree, pct.scale_factor)


def test_poly_batch_roundtrip(keypair):
    """encrypt_poly_batch -> decrypt_poly_batch over distinct values
    (degree-padded lanes included)."""
    pk, sk, tables = keypair
    vals = [5.0, 7.0, 11.0, 2.0]
    pts = [encoding.new_poly_plaintext(pk, v) for v in vals]
    assert len({p.degree for p in pts}) > 1    # exercises zero-padding
    batch = polyct.encrypt_poly_batch(pk, pts)
    got = polyct.decrypt_poly_batch(sk, batch, pk, tables)
    for g, v in zip(got, vals):
        assert approx1(g.poly_eval(), v)


def test_poly_batch_ops_match_per_poly(keypair):
    """Batched MultPoly / MultConstPoly / AddPoly / EvalPoly must be
    BIT-identical per lane to the single-poly path (deterministic mode):
    the batch axis may not change any group element."""
    import numpy as np

    pk, sk, tables = keypair
    vals = [5.0, 7.0, 11.0]
    pts = [encoding.new_poly_plaintext(pk, v) for v in vals]
    d = max(p.degree for p in pts)
    batch = polyct.encrypt_poly_batch(pk, pts)
    singles = [_slice_poly(batch, b) for b in range(len(vals))]

    prod_b = polyct.mult_poly(pk, batch, batch)
    add_b = polyct.add_poly(pk, batch, batch)
    mc_b = polyct.mult_const_poly(pk, batch, -2.0)
    ev_b = polyct.eval_poly(pk, batch)
    for b, s in enumerate(singles):
        for got, single in [
            (prod_b, polyct.mult_poly(pk, s, s)),
            (add_b, polyct.add_poly(pk, s, s)),
            (mc_b, polyct.mult_const_poly(pk, s, -2.0)),
        ]:
            lane = _slice_poly(got, b)
            assert lane.degree == single.degree
            assert lane.scale_factor == single.scale_factor
            if single.ct.level2:
                assert np.array_equal(np.asarray(lane.ct.data),
                                      np.asarray(single.ct.data))
            else:
                assert np.array_equal(np.asarray(lane.ct.data.x),
                                      np.asarray(single.ct.data.x))
                assert np.array_equal(np.asarray(lane.ct.data.y),
                                      np.asarray(single.ct.data.y))
        ev_s = polyct.eval_poly(pk, s)
        # eval_poly's add tree collapses the coefficient axis to 1:
        # batch output shape (1, B), single (1,)
        assert np.array_equal(np.asarray(ev_b.data.x[:, 0, b]),
                              np.asarray(ev_s.data.x[:, 0]))
    # decrypted semantics of the batch (values squared / doubled / *-2)
    got_prod = polyct.decrypt_poly_batch(sk, prod_b, pk, tables)
    for g, v in zip(got_prod, vals):
        assert approx1(g.poly_eval(), v * v)
    assert prod_b.degree == 2 * d


def test_poly_batch_l2_promotion(keypair):
    """make_poly_l2 on a batch (broadcast E(1) lane) + batched L2 add."""
    pk, sk, tables = keypair
    vals = [3.0, 6.0]
    pts = [encoding.new_poly_plaintext(pk, v) for v in vals]
    batch = polyct.encrypt_poly_batch(pk, pts)
    l2 = polyct.make_poly_l2(pk, batch)
    assert l2.level2
    r = polyct.add_poly(pk, l2, batch)     # mixed-level: promotes batch
    got = polyct.decrypt_poly_batch(sk, r, pk, tables)
    for g, v in zip(got, vals):
        assert approx1(g.poly_eval(), 2 * v)


def test_poly_accumulators_degree32(keypair):
    """The skew-gather diagonal accumulators at the reference's degree
    scale (d1=32; degreeBound=128 in plaintext.go:11 -- VERDICT r3 item
    7: trace size O(1) in degree), against per-diagonal sums."""
    import numpy as np

    from bgn_jax.scheme import Ciphertext

    pk, sk, tables = keypair
    d1, d2 = 32, 2
    ms = [(i % 7) + 1 for i in range(d1 * d2)]
    want = [0] * (d1 + d2)
    for i in range(d1):
        for k in range(d2):
            want[i + k] += ms[i * d2 + k]

    ct = pk.encrypt(ms)
    acc = polyct._poly_accumulate_l1(pk.dev, ct.data, d1, d2)
    got = sk.decrypt_failsafe(Ciphertext(acc, False), pk, tables)
    assert list(got) == want

    l2 = pk.make_l2(ct)
    acc2 = polyct._poly_accumulate_l2(pk.dev, l2.data, d1, d2)
    got2 = sk.decrypt_failsafe(Ciphertext(acc2, True), pk, tables)
    assert list(got2) == want
