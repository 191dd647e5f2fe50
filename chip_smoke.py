#!/usr/bin/env python3
"""Smoke run of the BGN main path on the GPU, through the public API.

    python chip_smoke.py            # one card: device, exactness, main path
    python chip_smoke.py --four     # four cards: DP Mult + sharded decrypts

Phases (each a function that tests/test_chip_smoke.py also calls on the
CPU at a 64-bit key):

1. device     -- a GPU backend is required; there is no CPU carry-on.
                 Prints the device kind and nvidia-smi's name and power
                 limit.
2. exactness  -- r_mul on random and edge operands, the limbs<->RNS round
                 trip and the batched pairing, at a 512-bit key and a
                 1024-bit key (the wide RNS path), all bit-exact against
                 Python ints and hostmath's Tate pairing; the dispatch
                 must have chosen the RNS field path.
3. main path  -- BGNParams.reference_test_config() (512-bit, msg_space
                 1021, deterministic) and the same group in randomized
                 mode: encrypt, encrypt_device, add, mult_const, mult, L2
                 add and decrypt at both levels; every decrypted value is
                 checked against the plaintext arithmetic.
4. four       -- only with --four: Mult on a 1-D mesh of four cards and the
                 giant-step-sharded decrypts, bit-for-bit against one card.

Compile seconds and steady-state rates are printed as information.  The
last stdout line is {"ok": true, "device": {...}}; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from typing import NamedTuple

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bgn_jax import hostmath as hm  # noqa: E402
from bgn_jax import scheme  # noqa: E402
from bgn_jax.config import BGNParams  # noqa: E402
from bgn_jax.fieldcore import limbs as lb  # noqa: E402
from bgn_jax.fieldcore import montgomery as mg  # noqa: E402
from bgn_jax.fieldcore import rns as rn  # noqa: E402
from bgn_jax.ops import pairing as pairing_mod  # noqa: E402
from bgn_jax.utils import convert  # noqa: E402
from bgn_jax.utils.cache import enable_compile_cache  # noqa: E402

BATCH = 8192          # lanes per main-path op
DECRYPT_BATCH = 2048  # lanes per decrypt call
RNS_LANES = 8192      # random r_mul lanes per key size
PAIR_LANES = 32       # pairing lanes checked against hostmath
WIDE_KEY_BITS = 1024  # exercises the wide RNS path (k > 64 channels)
BOUND = 30            # r_mul operand bound: 30 * 30 = 900 <= headroom


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """(result, seconds) of fn() with its device work finished."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# -- phase 1: device ---------------------------------------------------------


def require_gpu() -> jax.Device:
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's backend is "
                         f"{backend!r}")
    return jax.devices()[0]


def gpu_name_power() -> list:
    """nvidia-smi's `name, power.limit` line for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# -- phase 2: exactness -------------------------------------------------------


class Field(NamedTuple):
    """One modulus on both field paths, plus its pairing exponents."""
    params: hm.A1Params
    key_bits: int
    ctx: mg.MontCtx
    rns: rn.RNSCtx
    n_naf: jax.Array
    l_bits: jax.Array


def field_of_key(pk, sk) -> Field:
    d = pk.dev
    return Field(sk.a1_params, pk.key_bits, d.ctx, d.rns, d.n_naf, d.l_bits)


def field_for_bits(key_bits: int, rng) -> Field:
    """Fresh A1 parameters at key_bits, laid out as keygen lays them."""
    params = hm.gen_a1_params(key_bits, rng)
    L = lb.num_limbs_for_bits(key_bits + scheme._L_MARGIN_BITS)
    naf, _ = scheme._exp_digits(params.n, key_bits,
                                (params.q1, params.q2, params.n))
    return Field(params, key_bits, mg.make_mont_ctx(params.p, L=L),
                 rn.make_rns_ctx(params.p, L=L), naf,
                 np.asarray(lb.int_to_bits(params.l, 32)))


def _residues(xs, moduli) -> np.ndarray:
    obj = np.array(xs, dtype=object)
    return np.stack([(obj % m).astype(np.float32) for m in moduli])


def _crt(res_a: np.ndarray, base_a) -> np.ndarray:
    """Exact values (object ints) from base-A residues [k, lanes]."""
    A = 1
    for a in base_a:
        A *= a
    acc = np.zeros(res_a.shape[1], dtype=object)
    for i, a in enumerate(base_a):
        c = pow(A // a % a, -1, a)
        t = (res_a[i].astype(np.int64) * c) % a
        acc = acc + t.astype(object) * (A // a)
    return acc % A


def check_rns_exact(f: Field, lanes: int, rng) -> dict:
    """r_mul on `lanes` random operands below BOUND*p plus edge operands
    (0, 1, p-1, BOUND*p-1), and the limbs<->RNS conversions, against
    Python ints.  Returns compile seconds."""
    assert pairing_mod.use_rns(f.rns), "dispatch did not choose RNS"
    p, ctx, rns = f.params.p, f.ctx, f.rns
    base_a, base_b, k = rn.select_channels(p)
    assert k == rns.k
    top = BOUND * p - 1
    edges = [(0, 0), (1, 1), (p - 1, p - 1), (top, top), (0, top),
             (1, top), (p - 1, top), (top, 1)]
    xs = [rng.randrange(BOUND * p) for _ in range(lanes)] + \
        [x for x, _ in edges]
    ys = [rng.randrange(BOUND * p) for _ in range(lanes)] + \
        [y for _, y in edges]
    moduli = base_a + base_b

    def mul(rns, x, y):
        return rn.r_mul(rns, rn.RVal(x, BOUND), rn.RVal(y, BOUND)).v

    def conversions(rns, z, limbs, mont):
        return (rn.rns_to_limbs(rns, rn.RVal(z, 3)),
                rn.limbs_to_rns(rns, limbs),
                rn.from_rns_mont(rns, rn.to_rns_mont(rns, mont)))

    z, t_mul = timed(lambda: jax.jit(mul)(rns, _residues(xs, moduli),
                                          _residues(ys, moduli)))
    z = np.asarray(z)
    A = 1
    for a in base_a:
        A *= a
    ainv = pow(A, -1, p)
    want = [x * y * ainv % p for x, y in zip(xs, ys)]
    v = _crt(z[:k], base_a)
    for i, b in enumerate(base_b):
        assert np.array_equal((v % b).astype(np.float32), z[k + i]), \
            f"r_mul base-B residues disagree with base A (channel {i})"
    assert all(vi < 3 * p and vi % p == w for vi, w in zip(v, want)), \
        "r_mul value wrong or above 3p"

    # exit of the r_mul results, entry of canonical limbs, Montgomery
    # round trip
    canon = [x % p for x in xs]
    limbs = lb.ints_to_limbs(canon, ctx.L)
    mont = convert._to_mont_limbs(ctx, canon)
    (out, res, back), t_conv = timed(
        lambda: jax.jit(conversions)(rns, z, limbs, mont))
    assert lb.limbs_to_ints(np.asarray(out)) == want, "rns_to_limbs wrong"
    assert np.array_equal(np.asarray(res), _residues(canon, moduli)), \
        "limbs_to_rns wrong"
    assert np.array_equal(np.asarray(back), mont), "RNS round trip wrong"
    return {"r_mul": t_mul, "conversions": t_conv}


def check_pairing(f: Field, lanes: int, rng) -> float:
    """Batched pairing (the Mult kernel's math) on `lanes` random G1
    pairs, lane 0 with an identity input, against hostmath.tate_pairing.
    Returns compile+first-run seconds."""
    assert pairing_mod.use_rns(f.rns), "dispatch did not choose RNS"
    prm = f.params
    ps = [None] + [hm.random_curve_point(prm, rng) for _ in range(lanes - 1)]
    qs = [hm.random_curve_point(prm, rng) for _ in range(lanes)]
    a = convert.affine_from_host(f.ctx, ps)
    b = convert.affine_from_host(f.ctx, qs)
    n_bits = np.asarray(lb.int_to_bits(prm.n, f.key_bits))

    def pair(ctx, rns, a, b, n_bits, l_bits, n_naf):
        return pairing_mod.pairing(ctx, a, b, n_bits, l_bits, rns=rns,
                                   n_naf=n_naf)

    z, t = timed(lambda: jax.jit(pair)(f.ctx, f.rns, a, b, n_bits,
                                       f.l_bits, f.n_naf))
    got = convert.fp2_to_host(f.ctx, z)
    want = [hm.tate_pairing(P, Q, prm) for P, Q in zip(ps, qs)]
    assert got == want, "pairing disagrees with hostmath.tate_pairing"
    return t


def exactness(f: Field, lanes: int, pair_lanes: int, rng) -> None:
    t = check_rns_exact(f, lanes, rng)
    tp = check_pairing(f, pair_lanes, rng)
    log(f"exactness {f.key_bits}-bit (p {f.params.p.bit_length()} bits, "
        f"k={f.rns.k} channels, L={f.ctx.L} limbs): r_mul x{lanes + 8}, "
        f"limbs<->RNS, pairing x{pair_lanes} bit-exact; compile+first run "
        f"s: r_mul {t['r_mul']:.1f}, conversions {t['conversions']:.1f}, "
        f"pairing {tp:.1f}")


# -- phase 3: main path -------------------------------------------------------


def _decrypt_all(sk, pk, tables, ct, dbatch: int) -> list:
    n = ct.batch_shape[0]
    out = []
    for i in range(0, n, dbatch):
        out.extend(int(v) for v in sk.decrypt(ct[i:i + dbatch], pk, tables))
    return out


def main_path(pk, sk, tables, batch: int, dbatch: int, rng, key,
              label: str, iters: int = 3) -> None:
    """Encrypt, encrypt_device, add, mult_const, mult, L2 add and decrypt
    at both levels through the public API; every lane of every result is
    decrypted and compared with the plaintext arithmetic."""
    assert pairing_mod.use_rns(pk.dev.rns), "dispatch did not choose RNS"
    # 2*m*k must stay inside the message space for the L2 add check
    ms = [rng.randrange(pk.msg_space // 6) for _ in range(batch)]
    ks = [rng.randrange(1, 4) for _ in range(batch)]

    def run(name, fn, lanes=batch):
        out, first = timed(fn)
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn())
        rate = iters * lanes / (time.perf_counter() - t0)
        log(f"  {label} {name}: compile+first {first:.1f}s, "
            f"{rate:.1f} ops/s at batch {lanes}")
        return out

    a = run("Encrypt", lambda: pk.encrypt(ms, rng=rng))
    b = run("EncryptDevice", lambda: pk.encrypt_device(ks, key))
    s = run("Add", lambda: pk.add(a, b, rng=rng))
    c = run("MultConstant", lambda: pk.mult_const(a, ks, rng=rng))
    z = run("Mult", lambda: pk.mult(a, b, rng=rng))
    z2 = run("AddL2", lambda: pk.add(z, z, rng=rng))
    run("Decrypt", lambda: sk.decrypt_with_status(a[:dbatch], pk, tables),
        lanes=dbatch)
    run("DecryptL2", lambda: sk.decrypt_with_status(z[:dbatch], pk, tables),
        lanes=dbatch)

    checks = [
        ("Encrypt", a, ms),
        ("EncryptDevice", b, ks),
        ("Add", s, [m + k for m, k in zip(ms, ks)]),
        ("MultConstant", c, [m * k for m, k in zip(ms, ks)]),
        ("Mult", z, [m * k for m, k in zip(ms, ks)]),
        ("AddL2", z2, [2 * m * k for m, k in zip(ms, ks)]),
    ]
    for name, ct, want in checks:
        got = _decrypt_all(sk, pk, tables, ct, dbatch)
        bad = sum(g != w for g, w in zip(got, want))
        assert bad == 0, f"{label} {name}: {bad} of {len(want)} lanes wrong"
    log(f"  {label}: all {len(checks)} x {batch} decrypted lanes match the "
        f"plaintext arithmetic")


# -- phase 4: four cards ------------------------------------------------------


def _devices_of(x) -> set:
    return {s.device for s in x.addressable_shards}


def _concat(parts):
    """One L1 Ciphertext from per-chunk ones (batch axis last)."""
    from bgn_jax.ops.curve import AffinePoint
    d = [c.data for c in parts]
    return scheme.Ciphertext(AffinePoint(
        np.concatenate([np.asarray(x.x) for x in d], axis=1),
        np.concatenate([np.asarray(x.y) for x in d], axis=1),
        np.concatenate([np.asarray(x.inf) for x in d], axis=0)), False)


def four_cards(pk, sk, tables, batch: int, dbatch: int, rng,
               n: int = 4) -> None:
    """DP Mult over a 1-D mesh of n cards at n*batch lanes and the
    giant-step-sharded decrypts at both levels, bit-for-bit against the
    same inputs on one card (in the main path's chunk shapes, so the one-
    card side reuses those compiled kernels)."""
    from bgn_jax.parallel import mesh as mesh_mod
    from bgn_jax.parallel import sharded as sh

    assert pairing_mod.use_rns(pk.dev.rns), "dispatch did not choose RNS"
    devs = jax.devices()[:n]
    assert len(devs) == n, f"need {n} devices, have {len(jax.devices())}"
    mesh = mesh_mod.make_mesh(n)
    B = n * batch
    ms = [rng.randrange(pk.msg_space // 4) for _ in range(B)]
    ks = [rng.randrange(1, 4) for _ in range(B)]
    a_parts = [pk.encrypt(ms[i:i + batch], rng=rng)
               for i in range(0, B, batch)]
    b_parts = [pk.encrypt(ks[i:i + batch], rng=rng)
               for i in range(0, B, batch)]
    z_parts, t1 = timed(lambda: [pk.mult(a, b)
                                 for a, b in zip(a_parts, b_parts)])
    a4 = mesh_mod.shard_ciphertext(_concat(a_parts), mesh)
    b4 = mesh_mod.shard_ciphertext(_concat(b_parts), mesh)
    z4, t4 = timed(lambda: sh.mult_sharded(pk, a4, b4, mesh))
    for x in (a4.data.x, b4.data.x, z4.data):
        assert _devices_of(x) == set(devs), "data is not on all cards"
    assert all(s.data.shape[-1] == batch for s in z4.data.addressable_shards)
    z1 = np.concatenate([np.asarray(z.data) for z in z_parts], axis=-1)
    assert np.array_equal(np.asarray(z4.data), z1), \
        "DP Mult differs from one card"
    log(f"  Mult on {n} cards at batch {B}: bit-identical to one card "
        f"(compile+first {t4:.1f}s; one card, {n} chunks: {t1:.1f}s)")

    # sharded decrypts of one chunk (n*dbatch lanes: dbatch per card) vs
    # one-card decrypts of the same lanes
    D = n * dbatch
    assert D <= batch, "the decrypt lanes come from one chunk"
    for name, ct, dec, want in (
            ("G1", a_parts[0][:D], sh.decrypt_g1_sharded, ms[:D]),
            ("GT", z_parts[0][:D], sh.decrypt_gt_sharded,
             [m * k for m, k in zip(ms[:D], ks[:D])])):
        v1, ok1 = zip(*(sk.decrypt_with_status(ct[i:i + dbatch], pk, tables)
                        for i in range(0, D, dbatch)))
        v1, ok1 = np.concatenate(v1), np.concatenate(ok1)
        ct4 = mesh_mod.shard_ciphertext(ct, mesh)
        (v4, ok4), t = timed(lambda: dec(pk, sk, tables, ct4, mesh))
        assert np.array_equal(np.asarray(v4), v1) and \
            np.array_equal(np.asarray(ok4), ok1), \
            f"sharded {name} decrypt differs from one card"
        assert list(v1) == want and all(ok1), f"{name} decrypt wrong"
        log(f"  sharded {name} decrypt on {n} cards x {D} lanes: matches "
            f"one card and the plaintexts (compile+first {t:.1f}s)")


# -- main ---------------------------------------------------------------------


def ok_line(used) -> dict:
    """The closing record: the first card's platform and kind, and the
    number of cards the run used (not the number visible)."""
    return {"ok": True, "device": {"platform": used[0].platform,
                                   "kind": used[0].device_kind,
                                   "count": len(used)}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the keys and the data")
    args = ap.parse_args(argv)

    dev = require_gpu()
    enable_compile_cache()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    for line in gpu_name_power():
        log(f"nvidia-smi name, power.limit: {line}")

    rng = random.Random(args.seed)
    t_start = t0 = time.perf_counter()
    cfg = BGNParams.reference_test_config()
    pk, sk = cfg.keygen(rng=random.Random(args.seed))
    tables = pk.setup_decryption(sk, rng=random.Random(args.seed))
    log(f"keygen + decrypt tables ({cfg.key_bits}-bit, msg_space "
        f"{cfg.msg_space}): {time.perf_counter() - t0:.1f}s")

    if args.four:
        four_cards(pk, sk, tables, BATCH, DECRYPT_BATCH, rng)
        used = jax.devices()[:4]
    else:
        exactness(field_of_key(pk, sk), RNS_LANES, PAIR_LANES, rng)
        exactness(field_for_bits(WIDE_KEY_BITS, rng), RNS_LANES,
                  PAIR_LANES, rng)
        key = jax.random.key(args.seed)
        main_path(pk, sk, tables, BATCH, DECRYPT_BATCH, rng, key,
                  "deterministic")
        # same group (same seed), randomized mode: shares every compiled
        # kernel and adds the re-randomization ones
        cfg_r = BGNParams.reference_test_config()
        cfg_r.deterministic = False
        pk_r, sk_r = cfg_r.keygen(rng=random.Random(args.seed))
        main_path(pk_r, sk_r, tables, BATCH, DECRYPT_BATCH, rng, key,
                  "randomized")
        used = [dev]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(ok_line(used)), flush=True)


if __name__ == "__main__":
    main()
