"""Pipeline parallelism (PP) for the pairing: the Miller loop's bit range
is split into per-stage segments laid out on a 'stage' mesh axis, and
microbatches flow through the stages with a `ppermute` hand-off each tick
(SURVEY.md §2.3 row 'PP (Miller/final-exp stage split)').

How it maps to the hardware: each stage holds one microbatch's loop state
(V, f, inputs) resident while it advances its bit segment; at every scan
tick the state pytree moves to the next device.  Stage 0 seeds a
fresh microbatch per tick, stage S-1 finishes the last Miller bits AND
runs the final exponentiation, so a batch of M microbatches completes in
M + S - 1 ticks instead of M serial pairings.

Segment balance: bit segments are sized on the host so every stage costs
about the same in r_mul units, charging the final exponentiation
(~nbits*3.5 + |p|*1.5 muls) to the last stage -- its bit share shrinks
accordingly.  Rows are sentinel-padded (-1 = skip) so unequal segments
still trace as one static scan.

The math is the exact RNS Miller/final-exp step set of ops/rns_pairing.py
(same functions), so the pipeline output is bit-identical to
pairing_rns / the XLA path; tests/test_pipeline.py asserts that on 2- and
4-stage CPU meshes.

The reference has no pairing pipeline at all (a single pbc Element.Pair
call, bgn.go:294-314); this is new structure, not a port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..fieldcore import limbs as lb
from ..fieldcore import rns as rn
from ..fieldcore.rns import RVal
from ..ops import rns_pairing as rp

STAGE_AXIS = "stage"

# r_mul-unit costs per Miller bit and for the final exponentiation
# (ops/rns_pairing.py step audits)
_DBL, _ADD = 21, 17


def _fexp_rmul(nbits: int, pbits: int) -> float:
    """final exp ~ conj/inv (fp2 pow over l) + Fermat inversion pow."""
    return nbits * (2 + 1.5) + pbits * 1.5 + 10


def plan_segments(n: int, nbits: int, stages: int, pbits: int) -> np.ndarray:
    """[S, seg] int32 bit-op rows, -1 = skip.

    The global op string is n_bits[:-1] followed by one 0 (the tail
    doubling with the final addition elided -- a 0 bit is exactly 'double,
    no add').  Splits are chosen so stage costs balance with the final
    exponentiation charged to the last stage."""
    bits = [int(b) for b in lb.int_to_bits(n, nbits)]  # MSB first
    ops = bits[:-1] + [0]
    # cost of each op position (leading zeros before the MSB are free:
    # the started flag skips them)
    msb = bits.index(1)
    cost = [0.0 if i < msb else (_DBL + _ADD * ops[i]) for i in
            range(len(ops))]
    fexp = _fexp_rmul(nbits, pbits)
    total = sum(cost) + fexp
    per = total / stages
    # greedy boundaries: stage s takes ops until its budget is spent;
    # the last stage's budget is reduced by the final-exp charge
    rows, start = [], 0
    for s in range(stages):
        budget = per - (fexp if s == stages - 1 else 0.0)
        acc, end = 0.0, start
        while end < len(ops) and (acc < budget or s == stages - 1):
            acc += cost[end]
            end += 1
        rows.append(ops[start:end])
        start = end
    assert start == len(ops), (start, len(ops))
    seg = max(len(r) for r in rows)
    out = np.full((stages, seg), -1, dtype=np.int32)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
    return out


def _seg_step(rns):
    """One sentinel-aware Miller bit step over the carry pytree."""

    def step(carry, op):
        def skip(c):
            return c

        def active(c):
            started = c["started"]
            bit_b = op > 0

            def not_started(c):
                c = dict(c)
                c["started"] = jnp.where(bit_b, jnp.uint32(1),
                                         jnp.uint32(0))
                return c

            def normal(c):
                X, Y, Z, fr, fi = (c[k] for k in ("X", "Y", "Z", "fr",
                                                  "fi"))
                xb, yb = rp._pt(c["xb"]), rp._pt(c["yb"])
                s1 = rp._dbl_step(rns, X, Y, Z, fr, fi, xb, yb)
                s2 = jax.lax.cond(
                    bit_b,
                    lambda s: rp._add_step(rns, *s, rp._pt(c["ax"]),
                                           rp._pt(c["ay"]), xb, yb),
                    lambda s: s, s1)
                out = dict(c)
                out["X"], out["Y"], out["Z"], out["fr"], out["fi"] = s2
                return out

            return jax.lax.cond(started.astype(bool), normal, not_started,
                                c)

        return jax.lax.cond(op < 0, skip, active, carry), None

    return step


def pairing_pipeline(dev, a, b, mesh: Mesh, microbatches: int):
    """Batched Tate pairing through the stage pipeline.

    dev: PublicDeviceKey with an RNS context; a, b: AffinePoint batches
    [L, B] with B divisible by `microbatches`; mesh: 1-D Mesh over
    STAGE_AXIS.  Returns [2, L, B] limb-Montgomery GT elements,
    bit-identical to ops/rns_pairing.pairing_rns."""
    ctx, rns = dev.ctx, dev.rns
    assert rns is not None, "pipeline needs the RNS context"
    S = mesh.shape[STAGE_AXIS]
    M = microbatches
    B = a.x.shape[1]
    assert B % M == 0, (B, M)
    mb = B // M
    ch = 2 * rns.k
    nbits = int(dev.n_bits.shape[0])

    def prep(x):
        return rn.to_rns_mont(rns, x).v

    ax = prep(a.x).reshape(ch, M, mb)
    ay = prep(a.y).reshape(ch, M, mb)
    xb = prep(b.x).reshape(ch, M, mb)
    yb = prep(b.y).reshape(ch, M, mb)
    ins = jnp.stack([ax, ay, xb, yb], axis=0)      # [4, ch, M, mb]
    ins = jnp.moveaxis(ins, 2, 0)                  # [M, 4, ch, mb]

    # n is public; recover it from the device bits for the host planner
    n_int = int("".join(str(int(v)) for v in np.asarray(dev.n_bits)), 2)
    from jax.sharding import NamedSharding
    rows = jax.device_put(
        jnp.asarray(plan_segments(n_int, nbits, S, 16 * ctx.L)),
        NamedSharding(mesh, P(STAGE_AXIS)))        # [S, seg]
    # inputs may arrive sharded over a different (e.g. data-parallel)
    # mesh; re-home them replicated onto the stage mesh
    rep = NamedSharding(mesh, P())
    ins = jax.device_put(ins, rep)
    l_bits = jax.device_put(dev.l_bits, rep)
    T = M + S - 1

    def spmd(rows_l, ins_l, l_bits_l):
        d = jax.lax.axis_index(STAGE_AXIS)
        my_ops = rows_l[0]                         # [seg]
        zeros = jnp.zeros((ch, mb), jnp.float32)
        one = jnp.broadcast_to(
            rns.one_rns.reshape(ch, 1), (ch, mb))
        step = _seg_step(rns)
        S_ = jax.lax.axis_size(STAGE_AXIS)

        def tick(carry, t):
            # hand the loop state to the next stage
            perm = [(i, i + 1) for i in range(S_ - 1)]
            carry = jax.tree.map(
                lambda x: jax.lax.ppermute(x, STAGE_AXIS, perm), carry)
            # stage 0 seeds microbatch t (clamped; results past M-1 are
            # never consumed)
            idx = jnp.clip(t, 0, M - 1)
            fresh_in = jax.lax.dynamic_index_in_dim(ins_l, idx, axis=0,
                                                    keepdims=False)
            fresh = {
                "X": fresh_in[0], "Y": fresh_in[1], "Z": one,
                "fr": one, "fi": zeros,
                "ax": fresh_in[0], "ay": fresh_in[1],
                "xb": fresh_in[2], "yb": fresh_in[3],
                "started": jnp.uint32(0),
            }
            is0 = d == 0
            carry = jax.tree.map(
                lambda f, c: jax.lax.cond(is0, lambda _: f, lambda _: c,
                                          None), fresh, carry)
            # advance my bit segment
            carry, _ = jax.lax.scan(step, carry, my_ops)

            # last stage: final exponentiation of the finished Miller f
            def fin(c):
                zr, zi = rp.final_exponentiation_rns(
                    ctx, rns, (RVal(c["fr"], 9), RVal(c["fi"], 9)),
                    l_bits_l)
                return jnp.stack([zr.v, zi.v], axis=0)

            y = jax.lax.cond(d == S_ - 1, fin,
                             lambda c: jnp.zeros((2, ch, mb), jnp.float32),
                             carry)
            return carry, y

        carry0 = {k: zeros for k in ("X", "Y", "Z", "fr", "fi", "ax",
                                     "ay", "xb", "yb")}
        carry0["started"] = jnp.uint32(0)
        _, ys = jax.lax.scan(tick, carry0, jnp.arange(T))
        return ys[None]                            # [1, T, 2, ch, mb]

    shard = jax.shard_map(
        spmd, mesh=mesh,
        in_specs=(P(STAGE_AXIS), P(), P()),
        out_specs=P(STAGE_AXIS), check_vma=False)
    ys = shard(rows, ins, l_bits)                  # [S, T, 2, ch, mb]
    zs = ys[S - 1, S - 1:]                         # [M, 2, ch, mb]

    # RNS -> limb Montgomery, reassembled to the flat batch
    zflat = jnp.moveaxis(zs, 0, 2).reshape(2, ch, B)
    out_re = rn.from_rns_mont(rns, RVal(zflat[0], 9))
    out_im = rn.from_rns_mont(rns, RVal(zflat[1], 9))
    return jnp.stack([out_re, out_im], axis=0)
