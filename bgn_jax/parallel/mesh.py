"""Device mesh construction and sharding helpers.

The reference has no distributed backend at all (SURVEY.md §2.3: its only
parallelism is goroutine fan-out under mutexes, poly.go:95-153); callers
ship gob bytes themselves.  Here scaling is first-class: ciphertext batches
are arrays, so data parallelism is a NamedSharding over a 1-D 'data' mesh
axis and every scheme kernel runs SPMD unchanged, with XLA inserting any
needed collectives."""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def batch_spec(batch_axis_pos: int, ndim: int, axis: str = DATA_AXIS) -> P:
    """PartitionSpec sharding one axis, replicating the rest."""
    spec = [None] * ndim
    spec[batch_axis_pos] = axis
    return P(*spec)


def shard_ciphertext(ct, mesh: Mesh, axis: str = DATA_AXIS,
                     batch_dim: int = 0):
    """Place a Ciphertext batch on the mesh, sharded along one batch axis.

    L1 ciphertexts are AffinePoint(x[L,*batch], y[L,*batch], inf[*batch]);
    L2 are [2, L, *batch] GT arrays.  Limb/coordinate axes replicate.
    batch_dim indexes into the BATCH dims (negative ok): 0 shards the
    leading batch axis (plain DP batches); -1 shards the trailing axis
    (e.g. the poly axis of a (degree, B) polyct batch, where the
    coefficient axis must stay on-device for the convolution gathers)."""
    from ..ops.curve import AffinePoint
    from ..scheme import Ciphertext

    nb = len(ct.batch_shape)
    d = batch_dim % nb if nb else 0

    if ct.level2:
        sh = NamedSharding(mesh, batch_spec(2 + d, 2 + nb, axis))
        return Ciphertext(jax.device_put(ct.data, sh), True)
    co = NamedSharding(mesh, batch_spec(1 + d, 1 + nb, axis))
    pt = AffinePoint(
        jax.device_put(ct.data.x, co),
        jax.device_put(ct.data.y, co),
        jax.device_put(ct.data.inf, NamedSharding(mesh,
                                                  batch_spec(d, nb, axis))))
    return Ciphertext(pt, False)


def shard_poly_ciphertext(pct, mesh: Mesh, axis: str = DATA_AXIS):
    """Shard a (degree, B) poly-ciphertext batch along the POLY axis
    (coefficients replicate within a device; the MultPoly convolution's
    coefficient gathers then stay local and B partitions over the mesh,
    the DP layout for the reference's flagship MultPoly workload)."""
    from ..polyct import PolyCiphertext
    return PolyCiphertext(shard_ciphertext(pct.ct, mesh, axis=axis,
                                           batch_dim=-1),
                          pct.degree, pct.scale_factor)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree (keys, tables) across the mesh."""
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), tree)
