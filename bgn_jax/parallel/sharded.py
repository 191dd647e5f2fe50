"""Sharded scheme operations: data-parallel batches + giant-step-parallel
BSGS decryption.

Two scaling axes (SURVEY.md §2.3 / §5):
  - DP (batch sharding): ciphertext batches are sharded along 'data'; the
    scheme kernels are elementwise over the batch, so under jit with
    sharded inputs they run SPMD with zero communication (tested directly
    in tests/test_parallel.py).  The helpers here place data and keep the
    key replicated.
  - Giant-step sharding (the SP/CP analog): the BSGS lookup loop scales as
    sqrt(msg_space); for large message spaces the i-range i in [0, bound]
    is partitioned across devices under shard_map.  Each device starts its
    chunk at csk * gamma_inv^(device*chunk) (the ndev offsets are exact
    host arithmetic and arrive pre-sharded along 'data', so no device
    ladder or inversion is needed for them), scans its slice against the replicated
    baby-step table, and the first hit is combined with one pmin over the
    mesh axis -- all hits for a given csk encode the same m, so min is
    exact first-hit semantics (gsbs.go:98).

Both the positive and the negative lane (the reference's decrypt-then-
retry-Neg order, bgn.go:235-242) ride ONE giant-step scan: the lanes are
stacked on an extra axis exactly like the single-device kernel
(ops/bsgs.py:200-210), so a sharded decrypt costs one scan, not two.
Both groups are covered: G1 (level-1 ciphertexts) and GT (level-2),
mirroring the reference's getDL serving both (gsbs.go:54-106).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import hostmath as hm
from ..fieldcore import limbs as lb
from ..ops import bsgs as bsgs_mod
from ..ops import curve as cv
from ..ops import fp2
from ..ops.curve import AffinePoint, JacPoint
from ..utils import convert
from .mesh import DATA_AXIS, replicate, shard_ciphertext

_NOT_FOUND = jnp.int32(2 ** 31 - 1)


# ---------------------------------------------------------------------------
# Data-parallel scheme ops
# ---------------------------------------------------------------------------
# The scheme kernels are batch-elementwise, so DP needs no special kernels:
# shard the inputs, replicate the key, and XLA runs them SPMD.  These
# helpers encapsulate exactly that placement.


def encrypt_sharded(pk, ms, mesh, rng=None):
    """Encrypt a host batch directly into a sharded ciphertext."""
    ct = pk.encrypt(ms, rng=rng)
    return shard_ciphertext(ct, mesh)


def mult_sharded(pk, a, b, mesh, rng=None):
    """Pairing EMult on sharded batches: pure DP, no collectives."""
    dev = replicate(pk.dev, mesh)
    pk2 = _with_dev(pk, dev)
    return pk2.mult(a, b, rng=rng)


def _with_dev(pk, dev):
    import copy
    pk2 = copy.copy(pk)
    pk2.dev = dev
    return pk2


# ---------------------------------------------------------------------------
# Giant-step-sharded BSGS decryption
# ---------------------------------------------------------------------------


def _device_chunk(bound: int, ndev: int) -> int:
    return -(-(bound + 1) // ndev)


def _g1_offsets(ctx, gamma_inv: AffinePoint, chunk: int, ndev: int):
    """(d*chunk)*gamma_inv, d = 0..ndev-1, in host bignum arithmetic ->
    affine Montgomery x, y [ndev, L] and inf [ndev, 1] (d = 0: identity)."""
    p, _ = convert._host_mod(ctx)
    L = ctx.L
    (g,) = convert.affine_to_host(ctx, AffinePoint(
        np.asarray(gamma_inv.x).reshape(L, 1),
        np.asarray(gamma_inv.y).reshape(L, 1),
        np.asarray(gamma_inv.inf).reshape(1)))
    pts = [hm.ec_mul(d * chunk, g, p) for d in range(ndev)]
    xs = convert._to_mont_limbs(ctx, [0 if P is None else P[0] for P in pts])
    ys = convert._to_mont_limbs(ctx, [0 if P is None else P[1] for P in pts])
    inf = np.array([[P is None] for P in pts], dtype=np.uint32)
    return xs.T, ys.T, inf


def _gt_offsets(ctx, gamma_inv, chunk: int, ndev: int):
    """gamma_inv^(d*chunk), d = 0..ndev-1, in host bignum arithmetic ->
    Montgomery fp2 [ndev, 2, L]."""
    p, _ = convert._host_mod(ctx)
    (g,) = convert.fp2_to_host(ctx, np.asarray(gamma_inv).reshape(2, ctx.L, 1))
    zs = [hm.fp2_pow(g, d * chunk, p) for d in range(ndev)]
    return np.stack([convert._to_mont_limbs(ctx, [z[0] for z in zs]).T,
                     convert._to_mont_limbs(ctx, [z[1] for z in zs]).T],
                    axis=1)


def _encode_candidates(hits, vals, d, chunk: int, bound: int, batch_ndim):
    """hits/vals [chunk, 2, *batch] -> candidate m or NOT_FOUND, min over
    the local chunk; reference indexing m = i*bound + val + 1 (gsbs.go:98)."""
    jidx = jnp.arange(chunk, dtype=jnp.int32)
    i_global = (d.astype(jnp.int32) * chunk + jidx).reshape(
        (chunk,) + (1,) * (1 + batch_ndim))
    in_range = i_global <= bound
    cand = jnp.where(hits.astype(bool) & in_range,
                     i_global * bound + vals.astype(jnp.int32) + 1,
                     _NOT_FOUND)
    return jnp.min(cand, axis=0)                   # [2, *batch]


def _combine_lanes(best, is_zero):
    """best [2, *batch] int32 (pos lane, neg lane) -> (m, found), matching
    the reference's positive-then-negative preference (bgn.go:235-242) and
    identity => 0 (bgn.go:359-362)."""
    found_p = best[0] != _NOT_FOUND
    found_n = best[1] != _NOT_FOUND
    m = jnp.where(found_p, best[0], -best[1])
    m = jnp.where(is_zero, 0, m)
    found = is_zero | found_p | found_n
    return jnp.where(found, m, 0), found


def _shard_offsets(offs, mesh):
    """Per-device chunk-start offsets [ndev, ...] -> sharded along 'data'."""
    spec = P(*((DATA_AXIS,) + (None,) * (offs.ndim - 1)))
    return jax.lax.with_sharding_constraint(offs, NamedSharding(mesh, spec))


@partial(jax.jit, static_argnames=("mesh", "bound"))
def _bsgs_gt_sharded(ctx, table, gamma_inv, offs, csk, mesh, bound: int):
    """Giant-step-sharded GT lookup; csk [2, L, *batch] already = c^q1,
    offs = _gt_offsets [ndev, 2, L].

    Positive and negative (conjugate: GT is unitary) lanes share the scan.
    Returns best [2, *batch]: candidate m per lane or NOT_FOUND."""
    ndev = mesh.shape[DATA_AXIS]
    chunk = _device_chunk(bound, ndev)
    L = ctx.L
    batch_shape = csk.shape[2:]
    offs = _shard_offsets(offs, mesh)              # each device: its row

    neg_csk = fp2.conj(ctx, csk)                   # GT inverse = conjugate
    both = jnp.stack([csk, neg_csk], axis=2)       # [2, L, 2, *batch]
    gi = lb.expand_to(gamma_inv, (2, L) + (2,) + batch_shape)

    def shard_fn(both_l, gi_l, offs_l, table_l):
        d = jax.lax.axis_index(DATA_AXIS)
        off = offs_l[0].reshape((2, L) + (1,) * (1 + len(batch_shape)))
        aux0 = fp2.mul(ctx, both_l, off)

        def chain(z, _):
            return fp2.mul(ctx, z, gi_l), z

        _, auxs = jax.lax.scan(chain, aux0, None, length=chunk)
        # auxs [chunk, 2, L, 2, *batch] -> words [2L, chunk, 2, *batch]
        auxs = jnp.moveaxis(auxs, 0, 2)
        words = auxs.reshape((2 * L,) + auxs.shape[2:])
        hits, vals = bsgs_mod._lookup(table_l, words)
        local = _encode_candidates(hits, vals, d, chunk, bound,
                                   len(batch_shape))
        return jax.lax.pmin(local, DATA_AXIS)

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )(both, gi, offs, table)


@partial(jax.jit, static_argnames=("mesh", "bound"))
def _bsgs_g1_sharded(ctx, table, gamma_inv: AffinePoint, offs, csk: JacPoint,
                     mesh, bound: int):
    """Giant-step-sharded G1 lookup; csk = C^q1 (Jacobian [*, L, *batch]),
    offs = _g1_offsets (x, y, inf).

    Same structure as the GT variant: pos/neg lanes stacked, per-device
    offsets presharded, one scan of complete mixed additions, candidates
    normalized with one batch inversion per device, then lookup + pmin."""
    ndev = mesh.shape[DATA_AXIS]
    chunk = _device_chunk(bound, ndev)
    L = ctx.L
    batch_shape = csk.Z.shape[1:]
    offs_x, offs_y, offs_inf = (_shard_offsets(o, mesh) for o in offs)

    from ..fieldcore import montgomery as mg
    neg_csk = JacPoint(csk.X, mg.mod_neg(ctx, csk.Y), csk.Z)
    both = JacPoint(*(jnp.stack([a, b], axis=1)
                      for a, b in zip(csk, neg_csk)))  # [L, 2, *batch]

    base = AffinePoint(
        lb.expand_to(gamma_inv.x, (L, 2) + batch_shape),
        lb.expand_to(gamma_inv.y, (L, 2) + batch_shape),
        jnp.broadcast_to(gamma_inv.inf.reshape((1,) * (1 + len(batch_shape))),
                         (2,) + batch_shape))
    base2 = cv.dbl(ctx, cv.to_jac(ctx, base))

    def shard_fn(bX, bY, bZ, ox, oy, oinf, bx, by, binf,
                 b2X, b2Y, b2Z, table_l):
        d = jax.lax.axis_index(DATA_AXIS)
        off = AffinePoint(
            lb.expand_to(ox[0], (L, 2) + batch_shape),
            lb.expand_to(oy[0], (L, 2) + batch_shape),
            jnp.broadcast_to(oinf[0].reshape((1,) * (1 + len(batch_shape))),
                             (2,) + batch_shape))
        aux0 = cv.madd(ctx, JacPoint(bX, bY, bZ), off)
        base_l = AffinePoint(bx, by, binf)
        base2_l = JacPoint(b2X, b2Y, b2Z)

        def chain(v, _):
            return cv.madd(ctx, v, base_l, base2_l), v

        _, auxs = jax.lax.scan(chain, aux0, None, length=chunk)
        # one batch inversion for all chunk*2*batch candidates
        aff = cv.normalize(ctx, JacPoint(
            jnp.moveaxis(auxs.X, 0, 1), jnp.moveaxis(auxs.Y, 0, 1),
            jnp.moveaxis(auxs.Z, 0, 1)))          # [L, chunk, 2, *batch]
        words = jnp.concatenate([aff.x, aff.y], axis=0)
        hits, vals = bsgs_mod._lookup(table_l, words)
        hits = hits * (1 - aff.inf)   # identity never matches a table entry
        local = _encode_candidates(hits, vals, d, chunk, bound,
                                   len(batch_shape))
        return jax.lax.pmin(local, DATA_AXIS)

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(both.X, both.Y, both.Z, offs_x, offs_y, offs_inf,
      base.x, base.y, base.inf, base2.X, base2.Y, base2.Z, table)


# ---------------------------------------------------------------------------
# RNS-domain giant-step-sharded scans
# ---------------------------------------------------------------------------
# Same sharding structure as the limb variants above, but the per-device
# chains run in the RNS domain of ops/bsgs.py's single-device scans
# (bsgs_g1_rns / bsgs_gt_rns): the decrypt ladder's raw RNS output feeds
# the scan directly, each device batch-inverts its own candidate stack,
# and only the final affine candidates convert to canonical limbs for the
# digest lookup.  Degenerate-addition audit for the incomplete _add_pt at
# the per-device offset entry point: with off_d = -(d*chunk*bound)*gsk,
# V == +off_d needs lane-value == -(d*chunk*bound) (impossible for the
# small in-range magnitudes both lanes carry), and V == -off_d means the
# true aux0 IS the identity -- _add_pt then encodes Z = 0, every later
# candidate stays Z = 0 and is masked; the lane's true hit (if any) lies
# at a giant-step index < d*chunk, i.e. on an earlier device, so no hit
# is lost (the single-device audit in ops/bsgs.py, applied per device).


@partial(jax.jit, static_argnames=("mesh", "bound"))
def _bsgs_g1_rns_sharded(ctx, rns, table, gamma_inv, offs, Xr, Yr, Zr,
                         base_inf, mesh, bound: int):
    """RNS giant-step-sharded G1 scan; Xr/Yr/Zr raw residues [2k, B] (the
    output of rns_pairing.scalar_mul_rns(raw=True)), offs = _g1_offsets.
    Returns (best [2, B], is_zero [B])."""
    from ..fieldcore import rns as rn
    from ..ops import rns_pairing as rp

    ndev = mesh.shape[DATA_AXIS]
    chunk = _device_chunk(bound, ndev)
    k2 = 2 * rns.k
    L = ctx.L
    B = Xr.shape[-1]

    # negative lane: (X, K*p - Y, Z), K = the ladder's Y bound
    from ..ops.rns_pairing import _BY, _BZ
    kpK = rns.kp[:, _BY:_BY + 1]
    tneg = kpK - Yr
    negY = jnp.where(tneg < 0, tneg + rns.m, tneg)
    X0 = jnp.concatenate([Xr, Xr], axis=-1)            # [2k, 2B]
    Y0 = jnp.concatenate([Yr, negY], axis=-1)
    Z0 = jnp.concatenate([Zr, Zr], axis=-1)

    offs_x, offs_y, offs_inf = (_shard_offsets(o, mesh) for o in offs)

    gx = rn.to_rns_mont(rns, gamma_inv.x.reshape(L, 1))
    gy = rn.to_rns_mont(rns, gamma_inv.y.reshape(L, 1))

    # is_zero (m = 0): canonical limb Z of the raw csk == 0, or input inf
    Zl0 = rn.from_rns_mont(rns, rn.RVal(Zr, _BZ))
    is_zero = (lb.is_zero(Zl0) | base_inf.astype(jnp.uint32)).astype(bool)

    def shard_fn(X0, Y0, Z0, ox, oy, oinf, gxv, gyv, inf2, table_l):
        d = jax.lax.axis_index(DATA_AXIS)
        orx = rn.to_rns_mont(rns, ox[0].reshape(L, 1))
        ory = rn.to_rns_mont(rns, oy[0].reshape(L, 1))
        orxb = jnp.broadcast_to(orx.v, (k2, 2 * B))
        oryb = jnp.broadcast_to(ory.v, (k2, 2 * B))
        aX, aY, aZ = rp._add_pt(rns, X0, Y0, Z0,
                                rn.RVal(orxb, 3), rn.RVal(oryb, 3))
        # offset identity (d = 0): keep csk as-is
        oid = oinf[0, 0].astype(bool)
        aX = jnp.where(oid, X0, aX)
        aY = jnp.where(oid, Y0, aY)
        aZ = jnp.where(oid, Z0, aZ)

        gxb = rn.RVal(jnp.broadcast_to(gxv, (k2, 2 * B)), 3)
        gyb = rn.RVal(jnp.broadcast_to(gyv, (k2, 2 * B)), 3)

        def chain(carry, _):
            nxt = rp._add_pt(rns, *carry, gxb, gyb)
            return nxt, carry                 # collect BEFORE the add

        _, (Xs, Ys, Zs) = jax.lax.scan(chain, (aX, aY, aZ), None,
                                       length=chunk)
        C = chunk

        Zlc = rn.from_rns_mont(
            rns, rn.RVal(jnp.moveaxis(Zs, 0, 1).reshape(k2, C * 2 * B), 6))
        zmask = lb.is_zero(Zlc).reshape(C, 2 * B)
        zmask = zmask | inf2[None].astype(jnp.uint32)

        one_b = jnp.broadcast_to(rns.one_rns, (k2, 2 * B))
        zsub = jnp.where(zmask[:, None].astype(bool), one_b[None], Zs)
        zinv = rn.r_batch_inv(rns, zsub, ctx.pm2_bits)

        def wide(a):
            return jnp.moveaxis(a, 0, 1).reshape(k2, C * 2 * B)

        iw = rn.RVal(wide(zinv), 3)
        i2 = rn.r_mul(rns, iw, iw)
        i3 = rn.r_mul(rns, i2, iw)
        x = rn.r_mul(rns, rn.RVal(wide(Xs), 27), i2)
        y = rn.r_mul(rns, rn.RVal(wide(Ys), 27), i3)
        xl = rn.from_rns_mont(rns, x).reshape(L, C, 2, B)
        yl = rn.from_rns_mont(rns, y).reshape(L, C, 2, B)
        mask4 = zmask.reshape(C, 2, B)
        zero = jnp.zeros_like(xl)
        xl = lb.select(mask4, zero, xl)
        yl = lb.select(mask4, zero, yl)

        words = jnp.concatenate([xl, yl], axis=0)
        hits, vals = bsgs_mod._lookup(table_l, words)
        hits = hits * (1 - mask4)
        local = _encode_candidates(hits, vals, d, chunk, bound, 1)
        return jax.lax.pmin(local, DATA_AXIS)

    inf2 = jnp.concatenate([base_inf, base_inf], axis=-1)
    best = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(X0, Y0, Z0, offs_x, offs_y, offs_inf, gx.v, gy.v, inf2, table)
    return best, is_zero


@partial(jax.jit, static_argnames=("mesh", "bound"))
def _bsgs_gt_rns_sharded(ctx, rns, table, gamma_inv, offs, zr, zi, mesh,
                         bound: int):
    """RNS giant-step-sharded GT scan; zr/zi raw residues [2k, B] (the
    output of rns_pairing.fp2_pow_rns(raw=True), bound 9), offs =
    _gt_offsets.  Returns (best [2, B], is_zero [B])."""
    from ..fieldcore import rns as rn
    from ..ops import rns_pairing as rp

    ndev = mesh.shape[DATA_AXIS]
    chunk = _device_chunk(bound, ndev)
    k2 = 2 * rns.k
    L = ctx.L
    B = zr.shape[-1]

    kpK = rns.kp[:, 9:10]
    tneg = kpK - zi
    negI = jnp.where(tneg < 0, tneg + rns.m, tneg)
    R0 = jnp.concatenate([zr, zr], axis=-1)            # [2k, 2B]
    I0 = jnp.concatenate([zi, negI], axis=-1)

    offs = _shard_offsets(offs, mesh)                  # [ndev, 2, L]

    gr = rn.to_rns_mont(rns, gamma_inv[0].reshape(L, 1))
    gi_ = rn.to_rns_mont(rns, gamma_inv[1].reshape(L, 1))

    # is_zero (m = 0): canonical csk == 1
    rl0 = rn.from_rns_mont(rns, rn.RVal(zr, 9))
    il0 = rn.from_rns_mont(rns, rn.RVal(zi, 9))
    one_ext = lb.expand_to(ctx.one, rl0.shape)
    is_zero = (lb.eq(rl0, one_ext) & lb.is_zero(il0)).astype(bool)

    def shard_fn(R0, I0, offs_l, grv, giv, table_l):
        d = jax.lax.axis_index(DATA_AXIS)
        orr = rn.to_rns_mont(rns, offs_l[0, 0].reshape(L, 1))
        ori = rn.to_rns_mont(rns, offs_l[0, 1].reshape(L, 1))
        orrb = rn.RVal(jnp.broadcast_to(orr.v, (k2, 2 * B)), 3)
        orib = rn.RVal(jnp.broadcast_to(ori.v, (k2, 2 * B)), 3)
        a0 = rp._fp2_mul(rns, (rn.RVal(R0, 9), rn.RVal(I0, 9)),
                         (orrb, orib))

        grb = rn.RVal(jnp.broadcast_to(grv, (k2, 2 * B)), 3)
        gib = rn.RVal(jnp.broadcast_to(giv, (k2, 2 * B)), 3)

        def chain(carry, _):
            cr, ci = carry
            nr, ni = rp._fp2_mul(rns, (rn.RVal(cr, 9), rn.RVal(ci, 9)),
                                 (grb, gib))
            return (nr.v, ni.v), carry

        _, (Rs, Is) = jax.lax.scan(chain, (a0[0].v, a0[1].v), None,
                                   length=chunk)
        C = chunk
        rl = rn.from_rns_mont(
            rns, rn.RVal(jnp.moveaxis(Rs, 0, 1).reshape(k2, C * 2 * B), 9))
        il = rn.from_rns_mont(
            rns, rn.RVal(jnp.moveaxis(Is, 0, 1).reshape(k2, C * 2 * B), 9))
        words = jnp.concatenate([rl.reshape(L, C, 2, B),
                                 il.reshape(L, C, 2, B)], axis=0)
        hits, vals = bsgs_mod._lookup(table_l, words)
        local = _encode_candidates(hits, vals, d, chunk, bound, 1)
        return jax.lax.pmin(local, DATA_AXIS)

    best = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(R0, I0, offs, gr.v, gi_.v, table)
    return best, is_zero


def decrypt_gt_sharded(pk, sk, tables, ct, mesh):
    """Sharded L2 decryption: DP over the batch is implicit; the giant-step
    range is split over the mesh.  One scan covers both the positive and
    the negative lane (reference decrypt order, bgn.go:235-242).  On RNS
    keys the whole scan runs in the RNS domain."""
    from ..ops import pairing as pairing_mod

    ctx = pk.dev.ctx
    batch_shape = ct.data.shape[2:]
    ndev = mesh.shape[DATA_AXIS]
    offs = _gt_offsets(ctx, tables.gamma_inv_gt,
                       _device_chunk(tables.bound, ndev), ndev)
    if pairing_mod.use_rns(pk.dev.rns):
        from ..ops import rns_pairing
        digits = getattr(sk, "q1_naf", None)
        digits = sk.q1_bits if digits is None else digits
        zr, zi = rns_pairing.fp2_pow_rns(ctx, pk.dev.rns, ct.data, digits,
                                         unitary=True, raw=True)
        best, is_zero = _bsgs_gt_rns_sharded(
            ctx, pk.dev.rns, tables.table_gt, tables.gamma_inv_gt, offs,
            zr.v, zi.v, mesh, tables.bound)
        m, found = _combine_lanes(best, is_zero)
        m = m.reshape(batch_shape)
        found = found.reshape(batch_shape)
        return np.asarray(m, dtype=np.int64), np.asarray(found)
    csk = _csk_gt(pk.dev, sk.q1_bits, ct.data, getattr(sk, "q1_naf", None))
    best = _bsgs_gt_sharded(ctx, tables.table_gt, tables.gamma_inv_gt, offs,
                            csk, mesh, tables.bound)
    is_zero = fp2.is_one(ctx, csk).astype(bool)
    m, found = _combine_lanes(best, is_zero)
    return np.asarray(m, dtype=np.int64), np.asarray(found)


def decrypt_g1_sharded(pk, sk, tables, ct, mesh):
    """Sharded L1 decryption (the reference's getDL also serves G1,
    gsbs.go:54-106): csk = C^q1 then the giant-step-sharded scan (RNS
    domain end-to-end on RNS keys)."""
    from ..ops import pairing as pairing_mod

    ctx = pk.dev.ctx
    ndev = mesh.shape[DATA_AXIS]
    offs = _g1_offsets(ctx, tables.gamma_inv_g1,
                       _device_chunk(tables.bound, ndev), ndev)
    if pairing_mod.use_rns(pk.dev.rns):
        from ..ops import rns_pairing
        digits = getattr(sk, "q1_naf", None)
        digits = sk.q1_bits if digits is None else digits
        batch_shape = ct.data.inf.shape
        Xr, Yr, Zr = rns_pairing.scalar_mul_rns(ctx, pk.dev.rns, ct.data,
                                                digits, raw=True)
        best, is_zero = _bsgs_g1_rns_sharded(
            ctx, pk.dev.rns, tables.table_g1, tables.gamma_inv_g1, offs,
            Xr.v, Yr.v, Zr.v, ct.data.inf.reshape(-1), mesh, tables.bound)
        m, found = _combine_lanes(best, is_zero)
        m = m.reshape(batch_shape)
        found = found.reshape(batch_shape)
        return np.asarray(m, dtype=np.int64), np.asarray(found)
    csk = _csk_g1(pk.dev, sk.q1_bits, ct.data, getattr(sk, "q1_naf", None))
    best = _bsgs_g1_sharded(ctx, tables.table_g1, tables.gamma_inv_g1, offs,
                            csk, mesh, tables.bound)
    is_zero = lb.is_zero(csk.Z).astype(bool)
    m, found = _combine_lanes(best, is_zero)
    return np.asarray(m, dtype=np.int64), np.asarray(found)


@jax.jit
def _csk_gt(dev, q1_bits, z, q1_naf=None):
    from ..ops import pairing as pairing_mod
    if pairing_mod.use_rns(dev.rns):
        from ..ops import rns_pairing
        digits = q1_bits if q1_naf is None else q1_naf
        return rns_pairing.fp2_pow_rns(dev.ctx, dev.rns, z, digits,
                                       unitary=True)
    return fp2.pow_bits(dev.ctx, z, q1_bits)


@jax.jit
def _csk_g1(dev, q1_bits, pt, q1_naf=None):
    from ..ops import pairing as pairing_mod
    if pairing_mod.use_rns(dev.rns):
        from ..ops import rns_pairing
        digits = q1_bits if q1_naf is None else q1_naf
        return rns_pairing.scalar_mul_rns(dev.ctx, dev.rns, pt, digits)
    return cv.scalar_mul(dev.ctx, pt, q1_bits)
