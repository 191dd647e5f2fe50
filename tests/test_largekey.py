"""1024-bit end-to-end test (BASELINE.json config 5's key size).

Slow on the CPU backend (compiles the full 1024-bit kernel graphs);
skipped unless BGN_RUN_SLOW=1 (see conftest.py).  The fast wide-path
field arithmetic coverage at this size lives in test_rns.py
(test_rns_mul_exact[800/2060]).
"""

import random

import pytest

from bgn_jax import scheme

pytestmark = pytest.mark.slow

KEY_BITS = 1024
MSG_SPACE = 1021


@pytest.fixture(scope="module")
def keypair():
    rng = random.Random(10241024)
    pk, sk = scheme.keygen(KEY_BITS, MSG_SPACE, rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)
    return pk, sk, tables


def test_1024_bit_end_to_end(keypair):
    pk, sk, tables = keypair
    assert pk.key_bits == KEY_BITS
    assert pk.dev.rns is not None, "RNS must cover 1024-bit keys"
    assert pk.dev.rns.k > 64, "1024-bit keys take the wide RNS path"
    ms = [0, 1, 17, -9, 1020]
    ks = [5, 9, 3, 2, 1]
    a = pk.encrypt(ms, rng=random.Random(1))
    b = pk.encrypt(ks, rng=random.Random(2))
    s = pk.add(a, b)
    vals, ok = sk.decrypt_with_status(s, pk, tables)
    assert all(ok) and list(vals) == [m + k for m, k in zip(ms, ks)]


def test_1024_bit_pairing_mult(keypair):
    pk, sk, tables = keypair
    ms = [1, 3, 0, 11]
    ks = [2, 7, 9, 31]
    a = pk.encrypt(ms, rng=random.Random(3))
    b = pk.encrypt(ks, rng=random.Random(4))
    prod = pk.mult(a, b)
    vals, ok = sk.decrypt_with_status(prod, pk, tables)
    assert all(ok) and list(vals) == [m * k for m, k in zip(ms, ks)]
