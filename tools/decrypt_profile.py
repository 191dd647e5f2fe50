"""Stage timing for the two decrypt paths (L1 vs L2): ladder vs scan.

The GT ladder does ~4x fewer r_muls per digit than the Jacobian ladder;
this probe splits each decrypt path into its ladder and BSGS-scan halves
to show where each one's time goes.  Run it alone on the card.
"""
import os
import random
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bgn_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def rate(fn, iters=8, min_window=3.0):
    """Calls per second over a window of at least min_window seconds."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < min_window:
        out = None
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        done += iters
    return done / (time.perf_counter() - t0)


def main():
    from bgn_jax.config import BGNParams
    from bgn_jax.ops import bsgs as bsgs_mod
    from bgn_jax.ops import rns_pairing as rp

    B = int(os.environ.get("B", "2048"))
    rng = random.Random(1234)
    pk, sk = BGNParams(key_bits=512, msg_space=1021).keygen(
        rng=random.Random(1234))
    tables = pk.setup_decryption(sk, rng=rng)
    dev, ctx, rns = pk.dev, pk.dev.ctx, pk.dev.rns

    ms = [rng.randrange(300) for _ in range(B)]
    a = pk.encrypt(ms, rng=rng)
    l2 = pk.make_l2(a)
    jax.block_until_ready(a)

    lad1 = jax.jit(lambda pt: rp.scalar_mul_rns(ctx, rns, pt, sk.q1_naf,
                                                raw=True))
    r1 = rate(lambda: lad1(a.data)[0].v)
    print(f"L1 ladder (scalar_mul_rns, q1_naf): {B * r1:.0f} elem/s",
          file=sys.stderr, flush=True)

    Xr, Yr, Zr = lad1(a.data)
    scan1 = jax.jit(lambda x, y, z, i: bsgs_mod.bsgs_g1_rns(
        ctx, rns, tables, x, y, z, i))
    inf = a.data.inf.reshape(-1)
    r2 = rate(lambda: scan1(Xr, Yr, Zr, inf)[1])
    print(f"L1 scan (bsgs_g1_rns): {B * r2:.0f} elem/s",
          file=sys.stderr, flush=True)

    lad2 = jax.jit(lambda z: rp.fp2_pow_rns(ctx, rns, z, sk.q1_naf,
                                            unitary=True, raw=True))
    r3 = rate(lambda: lad2(l2.data)[0].v)
    print(f"L2 ladder (fp2_pow_rns, q1_naf): {B * r3:.0f} elem/s",
          file=sys.stderr, flush=True)

    zr, zi = lad2(l2.data)
    scan2 = jax.jit(lambda r, i: bsgs_mod.bsgs_gt_rns(ctx, rns, tables,
                                                      r, i))
    r4 = rate(lambda: scan2(zr, zi)[1])
    print(f"L2 scan (bsgs_gt_rns): {B * r4:.0f} elem/s",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
