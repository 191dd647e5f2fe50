"""Multi-device tests on the 8-device CPU mesh (conftest.py): DP batch
sharding + giant-step-sharded BSGS -- the distributed layer the reference
lacks entirely (SURVEY.md §2.3)."""

import random

import pytest

from _kernels import clear_mode_kernels

from bgn_jax import scheme
from bgn_jax.parallel import make_mesh, replicate, shard_ciphertext
from bgn_jax.parallel import sharded as sh

KEY_BITS = 64   # shared_keypair width (see conftest r5 note)
MSG_SPACE = 1021


@pytest.fixture(scope="module")
def keypair(shared_keypair):
    return shared_keypair


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8


def test_dp_add_mult(keypair):
    """Scheme kernels run SPMD on sharded batches and agree with the
    unsharded result."""
    pk, sk, tables = keypair
    mesh = make_mesh()
    ms_a = list(range(8))
    ms_b = [3] * 8
    a = pk.encrypt(ms_a)
    b = pk.encrypt(ms_b)
    a_sh = shard_ciphertext(a, mesh)
    b_sh = shard_ciphertext(b, mesh)
    s = pk.add(a_sh, b_sh)
    assert list(sk.decrypt(s, pk, tables)) == [m + 3 for m in ms_a]
    prod = pk.mult(a_sh, b_sh)
    assert list(sk.decrypt(prod, pk, tables)) == [m * 3 for m in ms_a]


def test_dp_decrypt_sharded_batch(keypair):
    pk, sk, tables = keypair
    mesh = make_mesh()
    ms = [11, 22, 33, 44, 55, 66, 77, 88]
    ct = shard_ciphertext(pk.encrypt(ms), mesh)
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert all(ok) and list(vals) == ms


def test_giant_step_sharded_gt_decrypt(keypair):
    """The SP analog: i-range of the BSGS scan split over the mesh
    (SURVEY.md §2.3 row SP/CP)."""
    pk, sk, tables = keypair
    mesh = make_mesh()
    ms = [0, 1, 12, 900, 33]
    ks = [1, 5, 1, 1, 31]
    a = pk.encrypt(ms)
    b = pk.encrypt(ks)
    prod = pk.mult(a, b)         # L2 values m*k
    want = [m * k for m, k in zip(ms, ks)]
    vals, ok = sh.decrypt_gt_sharded(pk, sk, tables, prod, mesh)
    assert list(ok) == [True] * len(ms)
    assert list(vals) == want
    # negative values through the inverse lane
    negs = pk.neg(prod)
    vals, ok = sh.decrypt_gt_sharded(pk, sk, tables, negs, mesh)
    assert list(ok) == [True] * len(ms)
    assert list(vals) == [-w for w in want]


def test_giant_step_sharded_g1_decrypt(keypair):
    """The G1 (level-1) giant-step-sharded path, incl. negatives and 0."""
    pk, sk, tables = keypair
    mesh = make_mesh()
    ms = [0, 1, 12, 900, -33, -1000]
    ct = pk.encrypt(ms)
    vals, ok = sh.decrypt_g1_sharded(pk, sk, tables, ct, mesh)
    assert list(ok) == [True] * len(ms)
    assert list(vals) == ms


def test_giant_step_sharded_rns_matches_single_chip(monkeypatch,
                                                     shared_keypair64,
                                                     shared_tables64):
    """The RNS-domain sharded scans (_bsgs_g1_rns_sharded /
    _bsgs_gt_rns_sharded, VERDICT r3 item 4) return bit-identical
    (values, found) to the single-device RNS decrypt kernels, both groups,
    incl. zero / negative / out-of-range lanes."""
    from bgn_jax.ops import pairing as pairing_mod

    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    rng = random.Random(64)
    pk, sk = shared_keypair64
    tables = shared_tables64
    mesh = make_mesh()

    ms = [0, 1, 7, 100, -5, -100, 42, 3]
    ct = pk.encrypt(ms, rng=rng)
    l2 = pk.make_l2(ct)
    # out-of-range lane: m*k beyond the BSGS range must report found=False
    big = pk.mult(pk.encrypt([50], rng=rng), pk.encrypt([50], rng=rng))

    v1, ok1 = sk.decrypt_with_status(ct, pk, tables)
    w1, okw1 = sk.decrypt_with_status(l2, pk, tables)
    b1, okb1 = sk.decrypt_with_status(big, pk, tables)

    v2, ok2 = sh.decrypt_g1_sharded(pk, sk, tables, ct, mesh)
    w2, okw2 = sh.decrypt_gt_sharded(pk, sk, tables, l2, mesh)
    b2, okb2 = sh.decrypt_gt_sharded(pk, sk, tables, big, mesh)
    clear_mode_kernels()

    assert list(v1) == list(v2) == ms
    assert list(ok1) == list(ok2) == [True] * len(ms)
    assert list(w1) == list(w2) == ms
    assert list(okw1) == list(okw2) == [True] * len(ms)
    assert list(okb1) == list(okb2) == [False]
    # the value of a not-found lane is unspecified (the reference raises
    # there, bgn.go:205-207); only the found flag must agree
