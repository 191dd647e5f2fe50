"""Device-time readings of the RNS hot path from a jax.profiler trace.

Measures, at the reference key (512-bit, BGNParams.reference_test_config)
and batch 8192 on the GPU:

  * the XLA RNS Miller doubling step (ops/rns_pairing._dbl_step): device
    time per step and kernels launched per step, from a trace of a
    lax.scan of STEPS steps -- the number any hand-written Miller kernel
    has to beat;
  * the whole Mult (scheme._mult_kernel): wall time, device busy time and
    kernel count of one call;
  * compile seconds of the unrolled limb CIOS (montgomery.mont_mul) at
    L = 32 and L = 64 limbs (512- and 1024-bit keys).

Usage: python tools/trace_rns.py [--out results/trace_rns]
Traces are written under --out; the reduction (reduce_trace) reads them
back with jax.profiler.ProfileData and prints one line per device stream.
"""

import argparse
import glob
import os
import random
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bgn_jax import hostmath as hm  # noqa: E402
from bgn_jax.config import BGNParams  # noqa: E402
from bgn_jax.fieldcore import limbs as lb  # noqa: E402
from bgn_jax.fieldcore import montgomery as mg  # noqa: E402
from bgn_jax.ops import rns_pairing as rp  # noqa: E402
from bgn_jax.utils import convert  # noqa: E402
from bgn_jax.utils.cache import enable_compile_cache  # noqa: E402

BATCH = 8192
STEPS = 64


def _union_ns(events) -> int:
    """Length of the union of [start, end) intervals, in ns."""
    total, end = 0, None
    for s, e in sorted((ev.start_ns, ev.end_ns) for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return int(total)


def reduce_trace(trace_dir: str) -> dict:
    """{(plane, line): (events, summed ns, busy ns)} for device planes of
    the newest trace under trace_dir."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = ProfileData.from_file(files[-1])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            if evs:
                out[(plane.name, line.name)] = (
                    len(evs), int(sum(e.duration_ns for e in evs)),
                    _union_ns(evs))
    return out


def traced(name: str, out_dir: str, fn, per: int = 1) -> None:
    """Warm fn, trace one call, print the per-`per` device readings."""
    jax.block_until_ready(fn())
    d = os.path.join(out_dir, name)
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        jax.block_until_ready(fn())
    wall = time.perf_counter() - t0
    print(f"{name}: traced wall {wall * 1e3:.3f} ms", flush=True)
    for (plane, line), (n, summed, busy) in sorted(reduce_trace(d).items()):
        print(f"  {plane} | {line}: {n / per:.2f} events, "
              f"{summed / per / 1e3:.3f} us summed, "
              f"{busy / per / 1e3:.3f} us busy (per {'step' if per > 1 else 'call'})",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/trace_rns")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args()
    batch = args.batch
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)

    pk, sk = BGNParams.reference_test_config().keygen(rng=random.Random(0))
    rns, ctx = pk.dev.rns, pk.dev.ctx
    ch = 2 * rns.k
    rng = np.random.default_rng(0)
    m = np.asarray(rns.m)

    def residues():
        return jnp.asarray(np.floor(rng.random((ch, batch)) * m)
                           .astype(np.float32))

    state = tuple(residues() for _ in range(5))
    xb, yb = rp._pt(residues()), rp._pt(residues())

    @jax.jit
    def dbl_scan(rns, state, xb_v, yb_v):
        def step(s, _):
            return rp._dbl_step(rns, *s, rp._pt(xb_v), rp._pt(yb_v)), None
        return jax.lax.scan(step, state, None, length=STEPS)[0]

    traced("miller_dbl_step", args.out,
           lambda: dbl_scan(rns, state, xb.v, yb.v), per=STEPS)

    prm = sk.a1_params
    prng = random.Random(1)
    pts = [hm.random_curve_point(prm, prng) for _ in range(64)]
    a = convert.affine_from_host(ctx, [pts[i % 64] for i in range(batch)])
    b = convert.affine_from_host(ctx, [pts[(i * 7 + 3) % 64]
                                       for i in range(batch)])
    from bgn_jax.scheme import _mult_kernel
    traced("mult", args.out, lambda: _mult_kernel(pk.dev, a, b))

    for bits in (512, 1024):
        L = lb.num_limbs_for_bits(bits + 32)
        p = hm.gen_prime(L * 16 - 8, random.Random(bits))
        c = mg.make_mont_ctx(p, L=L)
        x = jnp.asarray(lb.ints_to_limbs(
            [prng.randrange(p) for _ in range(batch)], L))
        t0 = time.perf_counter()
        jax.jit(mg.mont_mul).lower(c, x, x).compile()
        print(f"limb CIOS mont_mul L={L} batch {batch}: compile "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
