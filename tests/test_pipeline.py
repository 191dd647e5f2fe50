"""Pipeline-parallel pairing (parallel/pipeline.py): bit-identical to the
single-device RNS pairing on 2- and 4-stage CPU meshes (SURVEY.md §2.3
'PP (Miller/final-exp stage split)')."""

import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from bgn_jax import scheme
from bgn_jax.ops import rns_pairing as rp
from bgn_jax.parallel import pipeline as pp


@pytest.fixture(scope="module")
def setup(shared_keypair64):
    rng = random.Random(17)
    pk, sk = shared_keypair64
    ms = [0, 1, 2, 7, 100, 55, 13, 9]
    ks = [1, 3, 5, 2, 99, 4, 8, 6]
    a = pk.encrypt(ms, rng=rng).data
    b = pk.encrypt(ks, rng=rng).data
    z_ref = rp.pairing_rns(pk.dev.ctx, pk.dev.rns, a, b,
                           pk.dev.n_bits, pk.dev.l_bits)
    return pk, a, b, np.asarray(z_ref)


@pytest.mark.parametrize("stages,microbatches", [(2, 4), (4, 2)])
def test_pipeline_matches_pairing(setup, stages, microbatches):
    pk, a, b, z_ref = setup
    devs = np.asarray(jax.devices()[:stages])
    mesh = Mesh(devs, (pp.STAGE_AXIS,))
    z = pp.pairing_pipeline(pk.dev, a, b, mesh, microbatches)
    np.testing.assert_array_equal(z_ref, np.asarray(z))


def test_plan_segments_covers_all_bits():
    n = 0b1011011101111
    rows = pp.plan_segments(n, 16, 4, 128)
    ops = [int(v) for r in rows for v in r if v >= 0]
    bits = [int(v) for v in np.binary_repr(n, 16)]
    assert ops == bits[:-1] + [0]
    # the last stage carries the final-exp charge: fewer real bits
    real = [(r >= 0).sum() for r in rows]
    assert real[-1] <= min(real[:-1])
