"""End-to-end at the reference's exact test constants (bgn_test.go:8-13):
KEYBITS=512, POLYBASE=3, MSGSPACE=1021, FPSCALEBASE=3, FPPREC=0.0001,
DET=true.  One compact pass to bound CPU compile time; the full behavior
matrix runs at 160 bits in the other test files with identical kernels."""

import random

import pytest

from bgn_jax import encoding, polyct, scheme

KEYBITS = 512
POLYBASE = 3
MSGSPACE = 1021
FPSCALEBASE = 3
FPPREC = 0.0001
DET = True


@pytest.fixture(scope="module")
def keypair():
    rng = random.Random(512512)
    pk, sk = scheme.keygen(KEYBITS, MSGSPACE, POLYBASE, FPSCALEBASE, FPPREC,
                           DET, rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)
    return pk, sk, tables


def test_512bit_end_to_end(keypair):
    pk, sk, tables = keypair
    assert pk.key_bits == KEYBITS
    assert pk.n.bit_length() in (KEYBITS - 1, KEYBITS)
    # decryptable range is bound^2 + bound + 2 = 1058 at msgSpace 1021
    a = pk.encrypt([3, 0, -7, 500])
    b = pk.encrypt([5, 9, 2, 1])
    assert list(sk.decrypt(a, pk, tables)) == [3, 0, -7, 500]
    assert list(sk.decrypt(pk.add(a, b), pk, tables)) == [8, 9, -5, 501]
    prod = pk.mult(a, b)
    assert list(sk.decrypt(prod, pk, tables)) == [15, 0, -14, 500]
    assert list(sk.decrypt(pk.mult_const(a, 2), pk, tables)) == \
        [6, 0, -14, 1000]


def test_512bit_poly_rational(keypair):
    """The cmd/main.go rational demo core at full key size."""
    pk, sk, tables = keypair
    p1 = encoding.new_poly_plaintext(pk, 2.75)
    p2 = encoding.new_poly_plaintext(pk, 2.99)
    c1 = polyct.encrypt_poly(pk, p1)
    c2 = polyct.encrypt_poly(pk, p2)
    r = polyct.mult_poly(pk, c1, c2)
    got = polyct.decrypt_poly(sk, r, pk, tables).poly_eval()
    want = p1.poly_eval() * p2.poly_eval()
    assert f"{got:.1f}" == f"{want:.1f}"
