"""Host <-> device conversions for curve points and GT elements.

Device arrays hold Montgomery-form limbs; host values are Python ints /
tuples as used by bgn_jax.hostmath.  These run at keygen/serialization
boundaries only (the analog of pbc Element Bytes/SetBytes,
reference ciphertext.go:76-116, bgn.go:501-560).

The Montgomery scaling (x*R mod p on entry, x*R^-1 mod p on exit) happens
HOST-SIDE on exact Python ints: a device `to_mont` here would trace and
compile the CIOS kernel once per batch shape at every key build -- several
minutes of cold XLA compiles per keygen on the device for work
that is microseconds of host bignum math.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..fieldcore import limbs as lb
from ..fieldcore.montgomery import MontCtx
from ..ops.curve import AffinePoint

HostPoint = Optional[Tuple[int, int]]
HostFp2 = Tuple[int, int]


def _host_mod(ctx: MontCtx) -> Tuple[int, int]:
    """(p, R) as host ints.  Prefers the static ctx.p_host over a device
    readback of the limb array (montgomery.MontCtx.p_host)."""
    p = ctx.p_host or lb.limbs_to_int(np.asarray(ctx.p))
    return p, 1 << (lb.LIMB_BITS * ctx.L)


def _to_mont_limbs(ctx: MontCtx, vals: Sequence[int]) -> np.ndarray:
    """Host ints -> Montgomery-form limb array [L, B] (all host math)."""
    p, R = _host_mod(ctx)
    return lb.ints_to_limbs([int(v) * R % p for v in vals], ctx.L)


def _from_mont_ints(ctx: MontCtx, limbs) -> List[int]:
    """Montgomery-form limb array [L, B] -> canonical host ints."""
    p, R = _host_mod(ctx)
    rinv = pow(R, -1, p)
    return [v * rinv % p for v in lb.limbs_to_ints(np.asarray(limbs))]


def affine_from_host(ctx: MontCtx, points: Sequence[HostPoint],
                     batch_shape=None) -> AffinePoint:
    """Host affine points (None = identity) -> AffinePoint [L, B].

    All reshaping happens in numpy BEFORE the upload: device-side
    reshape/slice each compile a program on first use -- pure overhead
    at key build."""
    L = ctx.L
    xs = [0 if P is None else P[0] for P in points]
    ys = [0 if P is None else P[1] for P in points]
    infs = np.array([1 if P is None else 0 for P in points], dtype=np.uint32)
    x = _to_mont_limbs(ctx, xs)
    y = _to_mont_limbs(ctx, ys)
    if batch_shape is not None:
        x = x.reshape((L,) + batch_shape)
        y = y.reshape((L,) + batch_shape)
        infs = infs.reshape(batch_shape)
    return AffinePoint(jnp.asarray(x), jnp.asarray(y), jnp.asarray(infs))


def point_from_host(ctx: MontCtx, P: HostPoint) -> AffinePoint:
    """Single host point -> AffinePoint with scalar batch shape ()."""
    x = _to_mont_limbs(ctx, [0 if P is None else P[0]])[:, 0]
    y = _to_mont_limbs(ctx, [0 if P is None else P[1]])[:, 0]
    inf = np.uint32(1 if P is None else 0)
    return AffinePoint(jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf))


def affine_to_host(ctx: MontCtx, ap: AffinePoint) -> List[HostPoint]:
    """AffinePoint [L, B] -> list of host points."""
    xs = _from_mont_ints(ctx, ap.x)
    ys = _from_mont_ints(ctx, ap.y)
    inf = np.asarray(ap.inf)
    return [None if inf[b] else (xs[b], ys[b]) for b in range(len(xs))]


def fp2_from_host(ctx: MontCtx, vals: Sequence[HostFp2], batch_shape=None):
    """Host (re, im) tuples -> [2, L, B] Montgomery fp2 array."""
    L = ctx.L
    re = _to_mont_limbs(ctx, [v[0] for v in vals])
    im = _to_mont_limbs(ctx, [v[1] for v in vals])
    z = np.stack([re, im], axis=0)
    if batch_shape is not None:
        z = z.reshape((2, L) + batch_shape)
    return jnp.asarray(z)


def fp2_single_from_host(ctx: MontCtx, v: HostFp2):
    z = np.stack([_to_mont_limbs(ctx, [v[0]])[:, 0],
                  _to_mont_limbs(ctx, [v[1]])[:, 0]], axis=0)
    return jnp.asarray(z)


def fp2_to_host(ctx: MontCtx, z) -> List[HostFp2]:
    """[2, L, B] -> list of host (re, im) tuples."""
    re = _from_mont_ints(ctx, z[0])
    im = _from_mont_ints(ctx, z[1])
    return list(zip(re, im))
