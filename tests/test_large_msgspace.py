"""Large-message-space BSGS: msg_space 10^7 (VERDICT r4 weak #9).

The reference's BSGS caps msgSpace at int64 and builds its tables with one
group op per entry under a sync.Map (gsbs.go:17-51); here the baby-step
table build is a Jacobian chain with ONE batched inversion
(ops/bsgs._ec_multiples) and the giant-step scan is a device scan, sharded
over the 8-virtual-device mesh for the multi-device path.

Slow (the bound-3163 giant-step scan runs ~3k device steps on CPU);
skipped unless BGN_RUN_SLOW=1.
"""

import random
import time

import pytest

from bgn_jax import scheme

pytestmark = pytest.mark.slow

KEY_BITS = 64
MSG_SPACE = 10_000_019          # prime-ish, > 2^23; bound = 3163


@pytest.fixture(scope="module")
def keypair():
    rng = random.Random(777)
    pk, sk = scheme.keygen(KEY_BITS, MSG_SPACE, rng=rng)
    t0 = time.time()
    tables = pk.setup_decryption(sk, rng=rng)
    build_s = time.time() - t0
    return pk, sk, tables, build_s


def test_table_build_fast(keypair):
    """2 * 3165-entry tables (G1 + GT) must build in seconds, not the
    minutes the per-entry gcd-inverse loop took (r3 item 9 done half)."""
    pk, sk, tables, build_s = keypair
    assert tables.bound == 3163
    assert tables.table_g1.digests.shape[0] == 3165
    assert build_s < 10.0, f"table build took {build_s:.1f}s"


def test_decrypt_large_values(keypair):
    """Round-trip values spanning the full 10^7 space, incl. the
    negative-retry lane."""
    pk, sk, tables, _ = keypair
    ms = [0, 1, 3163, 3164, 1_000_000, 9_999_000, -5_000_000]
    ct = pk.encrypt(ms, rng=random.Random(8))
    vals, ok = sk.decrypt_with_status(ct, pk, tables)
    assert all(ok) and [int(v) for v in vals] == ms


def test_decrypt_sharded_large_space(keypair):
    """Giant-step-sharded decrypt over the 8-device mesh: each device
    scans ~bound/8 giant steps; first-hit reduced via pmin collectives.
    Values must match the single-device path exactly."""
    from bgn_jax.parallel import mesh as mesh_mod
    from bgn_jax.parallel import sharded as sh

    pk, sk, tables, _ = keypair
    mesh = mesh_mod.make_mesh(8)
    ms = [7, 12345, 9_876_543, 3_200_000, 1, 0, 4_999_999, 2_718_281]
    ct = mesh_mod.shard_ciphertext(pk.encrypt(ms, rng=random.Random(9)),
                                   mesh)
    vals, ok = sh.decrypt_g1_sharded(pk, sk, tables, ct, mesh)
    assert all(ok) and [int(v) for v in vals] == ms
