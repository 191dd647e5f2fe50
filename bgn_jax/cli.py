"""Demo CLI mirroring the reference's cmd/main.go.

Runs the 0/1 truth-table check (runSimpleCheck, cmd/main.go:74-107) and the
rational-arithmetic polynomial demo (runPolyArithmeticCheck,
cmd/main.go:24-72).  `python -m bgn_jax.cli [--key-bits N]`."""

from __future__ import annotations

import argparse
import random
import time


BANNER = r"""
====================================
 ____   _____ _   _
|  _ \ / ____| \ | |
| |_) | |  __|  \| |
|  _ <| | |_ | . ` |
| |_) | |__| | |\  |
|____/ \_____|_| \_|

Boneh Goh Nissim Cryptosystem in JAX
====================================
"""


def run_simple_check(key_bits: int, poly_base: int, seed=None) -> None:
    from .config import BGNParams

    rng = random.Random(seed)
    params = BGNParams(key_bits=key_bits, msg_space=1021,
                       poly_base=poly_base, fp_scale_base=3,
                       fp_precision=2, deterministic=True)
    pk, sk = params.keygen(rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)

    zero = pk.encrypt([0])
    one = pk.encrypt([1])
    negone = pk.encrypt([-1])

    def d(ct):
        return int(sk.decrypt_failsafe(ct, pk, tables)[0])

    print("\n---------RUNNING BASIC CHECK----------\n")
    print("0 + 0 =", d(pk.add(zero, zero)))
    print("0 + 1 =", d(pk.add(zero, one)))
    print("1 + 1 =", d(pk.add(one, one)))
    print("1 + 0 =", d(pk.add(one, zero)))

    print("0 * 0 =", d(pk.mult(zero, zero)))
    print("0 * 1 =", d(pk.mult(zero, one)))
    print("1 * 0 =", d(pk.mult(one, zero)))
    print("1 * 1 =", d(pk.mult(one, one)))

    print("0 - 0 =", d(pk.add(zero, pk.neg(zero))))
    print("0 - 1 =", d(pk.add(zero, pk.neg(one))))
    print("0 + (-1) =", d(pk.add(zero, negone)))
    print("1 - 1 =", d(pk.add(one, pk.neg(one))))
    print("1 - 0 =", d(pk.add(one, pk.neg(zero))))

    print("0 * (-0) =", d(pk.mult(zero, pk.neg(zero))))
    print("0 * (-1) =", d(pk.mult(zero, pk.neg(one))))
    print("1 * (-0) =", d(pk.mult(one, pk.neg(zero))))
    print("1 * (-1) =", d(pk.mult(one, pk.neg(one))))
    print("(-1) * (-1) =", d(pk.mult(pk.neg(one), pk.neg(one))))
    print("\n---------DONE----------")


def run_poly_arithmetic_check(key_bits: int, msg_space: int, poly_base: int,
                              fp_scale_base: int, fp_precision: float,
                              seed=None) -> None:
    from . import encoding, polyct
    from .config import BGNParams

    rng = random.Random(seed)
    params = BGNParams(key_bits=key_bits, msg_space=msg_space,
                       poly_base=poly_base, fp_scale_base=fp_scale_base,
                       fp_precision=fp_precision, deterministic=True)
    pk, sk = params.keygen(rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)

    def dec(pct):
        return polyct.decrypt_poly(sk, pct, pk, tables).poly_eval()

    m1 = encoding.new_poly_plaintext(pk, 0.0111)
    m2 = encoding.new_poly_plaintext(pk, 9.1)
    m3 = encoding.new_poly_plaintext(pk, 2.75)
    m4 = encoding.new_poly_plaintext(pk, 2.99)

    c1 = polyct.encrypt_poly(pk, m1)
    c2 = polyct.encrypt_poly(pk, m2)
    c3 = polyct.encrypt_poly(pk, m3)
    c4 = polyct.encrypt_poly(pk, m4)
    c6 = polyct.neg_poly(pk, c4)

    print("\n----------RUNNING ARITHMETIC TEST----------\n")
    for name, c in [("c1", c1), ("c2", c2), ("c3", c3), ("c4", c4)]:
        print(f"{name} = E({dec(c)})")
    print()

    r1 = polyct.add_poly(pk, c1, c4)
    print(f"[Add] E({m1}) + E({m4}) = E({dec(r1)})\n")

    r2 = polyct.mult_const_poly(pk, c2, 10.0)
    print(f"[MultConst] E({m2}) * 10.0 = E({dec(r2)})\n")

    r3 = polyct.mult_poly(pk, c3, c4)
    dr3 = dec(r3)
    print(f"[Mult] E({m3}) * E({m4}) = E({dr3})\n")

    r4 = polyct.mult_const_poly(pk, r3, 0.5)
    print(f"[MultConst] E({dr3}) * 0.5 = E({dec(r4)})\n")

    r5 = polyct.add_poly(pk, r3, r3)
    print(f"[Add] E({dr3}) + E({dr3}) = E({dec(r5)})\n")

    r6 = polyct.add_poly(pk, c1, c6)
    print(f"[Add] E({m1}) + Neg(E({m4})) = E({dec(r6)})\n")

    print("\n----------DONE----------")


def main() -> None:
    ap = argparse.ArgumentParser(description="bgn_jax demo")
    ap.add_argument("--key-bits", type=int, default=512,
                    help="length of q1 and q2 (reference default: 512)")
    ap.add_argument("--msg-space", type=int, default=1021)
    ap.add_argument("--poly-base", type=int, default=3)
    ap.add_argument("--fp-scale-base", type=int, default=3)
    ap.add_argument("--fp-precision", type=float, default=0.0001)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args()

    from .utils.cache import enable_compile_cache
    enable_compile_cache()
    print(BANNER)
    t0 = time.time()
    run_simple_check(args.key_bits, args.poly_base, seed=args.seed)
    run_poly_arithmetic_check(args.key_bits, args.msg_space, args.poly_base,
                              args.fp_scale_base, args.fp_precision,
                              seed=args.seed)
    print(f"\ntotal wall time: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
