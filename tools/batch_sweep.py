"""Throughput vs batch size for the hot ops (EMult pairing, Encrypt,
Decrypt) on the GPU.  Picks the knee of the curve so bench.py's BATCH
constant is evidence-based, not folklore.  Run it alone on the card: the
dispatch thread starves under concurrent host load.

Usage: python tools/batch_sweep.py [--bits 512] [--batches 1024,2048,...]
"""
import argparse
import json
import os
import random
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bgn_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=512)
    ap.add_argument("--batches", default="1024,2048,4096,8192")
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args()

    from bench import _same, timed  # autoranged >=3s windows
    from bgn_jax.config import BGNParams
    from bgn_jax.scheme import _decrypt_l1_kernel, _mult_kernel

    rng = random.Random(1234)
    pk, sk = BGNParams(key_bits=args.bits, msg_space=1021).keygen(
        rng=random.Random(1234))
    tables = pk.setup_decryption(sk, rng=rng)
    out = {}
    for B in [int(b) for b in args.batches.split(",")]:
        ms = [rng.randrange(300) for _ in range(B)]
        a = pk.encrypt(ms, rng=rng)
        b = pk.encrypt(ms, rng=rng)
        jax.block_until_ready((a, b))

        def rate(fn, iters=args.iters):
            return timed(fn, _same, iters, B * iters)

        r = {}
        r["encrypt"] = rate(lambda: pk.encrypt(ms, rng=rng))
        r["mult"] = rate(lambda: _mult_kernel(pk.dev, a.data, b.data))
        r["decrypt"] = rate(
            lambda: _decrypt_l1_kernel(pk.dev, tables, sk.q1_bits, a.data,
                                       sk.q1_naf)[1])
        out[B] = r
        print(f"batch {B}: " + json.dumps(out[B]), file=sys.stderr,
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
