"""Host golden model self-consistency + native accelerator agreement.

Pure-Python/ctypes tests (no JAX): fast coverage of the number-theory
foundation everything else is measured against."""

import random

import pytest

from bgn_jax import hostmath as hm
from bgn_jax.utils import native

RNG = random.Random(4242)


def test_prime_gen_exact_bits():
    for bits in (17, 80, 128):
        p = hm.gen_prime(bits, RNG)
        assert p.bit_length() == bits
        assert hm.is_probable_prime(p)


def test_a1_params_structure():
    params = hm.gen_a1_params(80, RNG)
    assert params.n == params.q1 * params.q2
    assert params.l % 4 == 0
    assert params.p == params.l * params.n - 1
    assert params.p % 4 == 3
    assert hm.is_probable_prime(params.p)


def test_pairing_bilinearity_small():
    params = hm.gen_a1_params(80, RNG)
    G = hm.find_generator(params, RNG)
    e = hm.tate_pairing(G, G, params)
    assert e != hm.FP2_ONE
    assert hm.fp2_pow(e, params.n, params.p) == hm.FP2_ONE
    a, b = 37, 91
    lhs = hm.tate_pairing(hm.ec_mul(a, G, params.p),
                          hm.ec_mul(b, G, params.p), params)
    assert lhs == hm.fp2_pow(e, a * b, params.p)
    # symmetry
    assert hm.tate_pairing(hm.ec_mul(a, G, params.p), G, params) == \
        hm.tate_pairing(G, hm.ec_mul(a, G, params.p), params)


def test_golden_scheme_roundtrip():
    key = hm.golden_keygen(80, 101, RNG)
    for m in (0, 1, 5, -3, 100):
        C = hm.golden_encrypt(key, m % key.n, RNG.randrange(key.n))
        assert hm.golden_decrypt_l1(key, C) == m
    C1 = hm.golden_encrypt(key, 7, RNG.randrange(key.n))
    C2 = hm.golden_encrypt(key, 9, RNG.randrange(key.n))
    prod = hm.tate_pairing(C1, C2, key.params)
    assert hm.golden_decrypt_l2(key, prod) == 63
    assert hm.golden_decrypt_l1(key, None) == 0


def test_golden_out_of_range():
    key = hm.golden_keygen(80, 101, RNG)
    big = 5000  # beyond bound*bound + bound + 2 for msg_space 101
    C = hm.golden_encrypt(key, big, 1)
    assert hm.golden_decrypt_l1(key, C) is None


def _py_miller_rabin(n: int, rounds: int = 40) -> bool:
    """Reference MR, independent of both the native lib and hostmath."""
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13):
        if n % sp == 0:
            return n == sp
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = RNG.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_matches_python():
    for bits in (64, 200):
        for _ in range(10):
            x = RNG.getrandbits(bits) | 1
            assert native.is_probable_prime(x) == _py_miller_rabin(x), x
    q1, q2 = hm.gen_prime(100, RNG), hm.gen_prime(100, RNG)
    n = q1 * q2
    l_nat = native.find_cofactor(n)
    assert l_nat % 4 == 0
    assert _py_miller_rabin(l_nat * n - 1)
    for l in range(4, l_nat, 4):
        assert not _py_miller_rabin(l * n - 1)
