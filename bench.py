"""Benchmark harness.

Default: the headline batched pairing-EMult metric as ONE JSON line on
stdout plus encrypt/BSGS-decrypt secondaries on stderr.  Mirrors the
reference's benchmark config (bgn_test.go:8-13, 127-140: KEYBITS=512,
MSGSPACE=1021, deterministic).  The reference publishes no numbers
(BASELINE.md).  Needs a GPU: there is no CPU fallback.

--full: every config with the reference's bench names
(bgn_test.go:87-140 KeyGen/Add/MultConstant/Mult, poly_test.go:10-66
EncryptPoly/DecryptPoly/AddPoly/MultConstantPoly/MultPoly,
gadgets_test.go:110-140 ProofOfPlaintextKnowledgeGen/Verify), the
fixed-point encrypted dot product (config 4), a 1024-bit section
(config 5's key size; --skip-1024 to omit), and a DP multi-chip scaling
section when >1 device is visible.  Results land in
results/bench_full.json.

Prints exactly ONE JSON line to stdout:
  {"metric": "emult_pairings_per_sec", "value": N, "unit": "ops/s",
   "device": {"platform", "kind", "count", "nvidia_smi"}}
Everything else goes to stderr / the results file.  A failed section
fails the run.
"""

import argparse
import json
import os
import random
import sys
import time

import jax
import numpy as np

from bgn_jax.utils.cache import enable_compile_cache
from chip_smoke import gpu_name_power, require_gpu

KEY_BITS = 512
MSG_SPACE = 1021
BATCH = 8192          # starting sizes; re-sweep on the card with
DECRYPT_BATCH = 2048  # tools/batch_sweep.py
ITERS = 8


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def section(name, fn):
    """Run one bench section; a failure is logged and re-raised, so a
    failed section fails the run."""
    try:
        return fn()
    except Exception as e:
        log(f"  !! section {name} FAILED: {type(e).__name__}: "
            f"{str(e)[:200]}")
        raise


RESULTS = {}


def record(name, ops_per_sec, batch, config, note=""):
    RESULTS[name] = {"ops_per_sec": ops_per_sec, "batch": batch,
                     "config": config, "note": note}
    log(f"  {name}: {ops_per_sec:.1f} ops/s (batch {batch})"
        + (f" -- {note}" if note else ""))


MIN_WINDOW_S = 3.0   # autorange floor for the timed window
MAX_CHUNKS = 64


def _same(out):
    return out


def _poly_ct(out):
    return out.ct


def timed(fn, arrays, iters, total_ops):
    """Compile+warm once, then rate the steady state (total_ops items per
    `iters` calls).  arrays(out) picks the device arrays of fn's result
    that the window waits for.  The timing loop autoranges: chunks of
    `iters` calls, each ending in block_until_ready, repeat until
    MIN_WINDOW_S of wall time is covered."""
    jax.block_until_ready(arrays(fn()))
    t0 = time.perf_counter()
    done = 0
    for _ in range(MAX_CHUNKS):
        out = None
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(arrays(out))
        done += total_ops
        if time.perf_counter() - t0 >= MIN_WINDOW_S:
            break
    return done / (time.perf_counter() - t0)


def bench_core(pk, sk, tables, rng, batch, iters, config, label="",
               decrypt_batch=None):
    """Config 1+3 core ops at one key size: Encrypt/Add/MultConstant/
    Mult/AddL2/Decrypt/DecryptL2 (reference names where they exist).
    Decrypt sections run at decrypt_batch (default: batch) -- the BSGS
    scan's throughput knee is lower than the ladder ops'."""
    from bgn_jax.scheme import _decrypt_l1_kernel, _decrypt_l2_kernel, \
        _mult_kernel

    sfx = label and f"_{label}"
    dbatch = decrypt_batch or batch
    # ms*ks must stay inside MSG_SPACE for the L2 decrypt section
    ms = [rng.randrange(MSG_SPACE // 3) for _ in range(batch)]
    ks = [rng.randrange(1, 4) for _ in range(batch)]
    a = pk.encrypt(ms, rng=rng)
    b = pk.encrypt(ks, rng=rng)
    jax.block_until_ready((a, b))

    section(f"Encrypt{sfx}", lambda: record(
        f"Encrypt{sfx}",
        timed(lambda: pk.encrypt(ms, rng=rng), _same, iters,
              batch * iters), batch, config,
        "host CSPRNG + digit prep included (see EncryptDevice for the "
        "on-device-RNG path)"))

    dev_key = jax.random.key(42)
    section(f"EncryptDevice{sfx}", lambda: record(
        f"EncryptDevice{sfx}",
        timed(lambda: pk.encrypt_device(ms, dev_key), _same, iters,
              batch * iters), batch, config,
        "on-device threefry randomness (utils/rng.py): the jitted-"
        "pipeline production path; only message-digit prep on host"))
    section(f"Add{sfx}", lambda: record(
        f"Add{sfx}",
        timed(lambda: pk.add(a, b), _same, iters, batch * iters),
        batch, config))
    section(f"MultConstant{sfx}", lambda: record(
        f"MultConstant{sfx}",
        timed(lambda: pk.mult_const(a, ks), _same, iters,
              batch * iters), batch, config))

    def _mult_section():
        t0 = time.time()
        prod_raw = _mult_kernel(pk.dev, a.data, b.data)
        jax.block_until_ready(prod_raw)
        log(f"  pairing compile+first batch: {time.time() - t0:.1f}s")
        emult = timed(lambda: _mult_kernel(pk.dev, a.data, b.data),
                      _same, iters, batch * iters)
        record(f"Mult{sfx}", emult, batch, 3 if not label else config)
        return emult

    emult = section(f"Mult{sfx}", _mult_section)

    def _l2_sections():
        ad = pk.encrypt(ms[:dbatch], rng=rng) if dbatch != batch else a
        bd = pk.encrypt(ks[:dbatch], rng=rng) if dbatch != batch else b
        prod = pk.mult(a, b)
        prod_d = pk.mult(ad, bd) if dbatch != batch else prod
        section(f"AddL2{sfx}", lambda: record(
            f"AddL2{sfx}",
            timed(lambda: pk.add(prod, prod), _same, iters,
                  batch * iters), batch, 3 if not label else config))

        def _dec_l2():
            # raw-kernel timing, symmetric with the L1 Decrypt section
            found, m = _decrypt_l2_kernel(pk.dev, tables, sk.q1_bits,
                                          prod_d.data, sk.q1_naf)
            jax.block_until_ready(m)
            record(f"DecryptL2{sfx}",
                   timed(lambda: _decrypt_l2_kernel(
                             pk.dev, tables, sk.q1_bits, prod_d.data,
                             sk.q1_naf)[1],
                         _same,
                         max(1, iters // 2),
                         dbatch * max(1, iters // 2)),
                   dbatch, 3 if not label else config)
            got = [int(v) for v in np.asarray(m)[:8]]
            assert got == [m_ * k_ for m_, k_ in zip(ms[:8], ks[:8])], \
                "L2 decrypt mismatch"

        section(f"DecryptL2{sfx}", _dec_l2)

    section(f"L2{sfx}", _l2_sections)

    def _decrypt_section():
        ad = pk.encrypt(ms[:dbatch], rng=rng) if dbatch != batch else a
        t0 = time.time()
        found, m = _decrypt_l1_kernel(pk.dev, tables, sk.q1_bits, ad.data,
                                      sk.q1_naf)
        jax.block_until_ready(m)
        log(f"  decrypt compile+first batch: {time.time() - t0:.1f}s")
        record(f"Decrypt{sfx}",
               timed(lambda: _decrypt_l1_kernel(pk.dev, tables, sk.q1_bits,
                                                ad.data, sk.q1_naf)[1],
                     _same, iters, dbatch * iters),
               dbatch, config)
        assert [int(v) for v in np.asarray(m)[:8]] == ms[:8], \
            "decrypt mismatch"

    section(f"Decrypt{sfx}", _decrypt_section)
    return emult


def bench_batch_10k(pk, rng, iters):
    """Config 2: EAdd + EMultC over 10^4 level-1 ciphertexts."""
    B = 10_000
    ms = [rng.randrange(MSG_SPACE) for _ in range(B)]
    ks = [rng.randrange(-3, 4) or 1 for _ in range(B)]
    a = pk.encrypt(ms, rng=rng)
    b = pk.encrypt(ms, rng=rng)
    jax.block_until_ready((a, b))
    record("Add_10k", timed(lambda: pk.add(a, b), _same, iters, B * iters),
           B, 2)
    record("MultConstant_10k",
           timed(lambda: pk.mult_const(a, ks), _same, iters, B * iters),
           B, 2)


def bench_poly(pk, sk, tables, rng, iters):
    """Config 2 poly ops, the reference's exact workloads
    (poly_test.go:10-66: value 100.1, MultConstPoly by 1.0)."""
    from bgn_jax import encoding, polyct

    pt = encoding.new_poly_plaintext(pk, 100.1)
    ct = polyct.encrypt_poly(pk, pt, rng=rng)
    jax.block_until_ready(ct.ct)

    note = "single-value op; dominated by per-dispatch latency off-batch"
    record("EncryptPoly",
           timed(lambda: polyct.encrypt_poly(pk, pt, rng=rng), _poly_ct,
                 iters, iters), 1, 2, note)
    record("DecryptPoly",
           timed(lambda: polyct.decrypt_poly(sk, ct, pk, tables),
                 _same, iters, iters), 1, 2, note)
    record("AddPoly",
           timed(lambda: polyct.add_poly(pk, ct, ct, rng=rng), _poly_ct,
                 iters, iters), 1, 2, note)
    record("MultConstantPoly",
           timed(lambda: polyct.mult_const_poly(pk, ct, 1.0, rng=rng),
                 _poly_ct, iters, iters), 1, 2, note)
    record("MultPoly",
           timed(lambda: polyct.mult_poly(pk, ct, ct, rng=rng), _poly_ct,
                 max(1, iters // 2), max(1, iters // 2)), 1, 2, note)


def bench_poly_batched(pk, sk, tables, rng, iters, B=512, value=100.1):
    """Config 2 poly ops at production batch: B polynomials (the
    reference's poly bench value 100.1, degree 3) per launch via the
    (degree, B) coefficient-batch layout (polyct poly batches).  This is
    the throughput the batched design exists for -- the batch-1 numbers
    above are dominated by dispatch latency; MultPoly here runs
    degree^2 * B pairings in one launch."""
    from bgn_jax import encoding, polyct

    pt = encoding.new_poly_plaintext(pk, value)
    pts = [pt] * B
    batch = polyct.encrypt_poly_batch(pk, pts, rng=rng)
    jax.block_until_ready(batch.ct)
    d = batch.degree

    record(f"EncryptPoly_b{B}",
           timed(lambda: polyct.encrypt_poly_batch(pk, pts, rng=rng),
                 _poly_ct, iters, B * iters), B, 2,
           f"degree {d}; polys/s")
    record(f"DecryptPoly_b{B}",
           timed(lambda: polyct.decrypt_poly_batch(sk, batch, pk, tables),
                 _same, iters, B * iters),
           B, 2, f"degree {d}; polys/s")
    record(f"AddPoly_b{B}",
           timed(lambda: polyct.add_poly(pk, batch, batch, rng=rng),
                 _poly_ct, iters, B * iters), B, 2, f"degree {d}; polys/s")
    record(f"MultConstantPoly_b{B}",
           timed(lambda: polyct.mult_const_poly(pk, batch, 1.0, rng=rng),
                 _poly_ct, iters, B * iters), B, 2, f"degree {d}; polys/s")
    record(f"MultPoly_b{B}",
           timed(lambda: polyct.mult_poly(pk, batch, batch, rng=rng),
                 _poly_ct, max(1, iters // 4), B * max(1, iters // 4)),
           B, 2, f"degree {d}: {d * d} pairings/poly; polys/s")
    record(f"EvalPoly_b{B}",
           timed(lambda: polyct.eval_poly(pk, batch, rng=rng), _same,
                 iters, B * iters), B, 2, f"degree {d}; polys/s")


def bench_gadgets(pk, sk, rng, iters, batch=256):
    """Config 4: PoK gen/verify (gadgets_test.go:110-140, batched) + the
    fixed-point encrypted dot product."""
    from bgn_jax import gadgets
    from bgn_jax.models import encrypted_dot as ed

    for B in (batch, 2048):
        sfx = "" if B == batch else f"_{B}"
        vs = [rng.randrange(pk.n) % MSG_SPACE for _ in range(B)]
        zs = [rng.randrange(pk.n) for _ in range(B)]
        proof = gadgets.new_proof_of_plaintext_knowledge(pk, sk, vs, zs,
                                                         rng=rng)
        ct = proof.ct
        record(f"ProofOfPlaintextKnowledgeGen{sfx}",
               timed(lambda: gadgets.new_proof_of_plaintext_knowledge(
                         pk, sk, vs, zs, rng=rng),
                     _poly_ct, max(1, iters // 2),
                     B * max(1, iters // 2)), B, 4)
        ok = gadgets.check_proof_of_plaintext_knowledge(pk, ct, proof)
        assert bool(ok.all()), "PoK verify rejected a valid proof"
        record(f"ProofOfPlaintextKnowledgeVerify{sfx}",
               timed(lambda: gadgets.check_proof_of_plaintext_knowledge(
                         pk, ct, proof),
                     _same,
                     max(1, iters // 2), B * max(1, iters // 2)), B, 4)

    # encrypted dot product: D-element vectors, batch columns (the
    # second batch runs 8192 Miller loops per launch)
    for D, B in ((16, 128), (16, 512)):
        xs = np.array([[rng.randrange(8) for _ in range(B)]
                       for _ in range(D)])
        ys = np.array([[rng.randrange(8) for _ in range(B)]
                       for _ in range(D)])
        ct_x = pk.encrypt(xs.ravel().tolist(), rng=rng).reshape((D, B))
        ct_y = pk.encrypt(ys.ravel().tolist(), rng=rng).reshape((D, B))
        jax.block_until_ready((ct_x, ct_y))
        record(f"EncryptedDot_d{D}_b{B}",
               timed(lambda: ed.encrypted_dot(pk, ct_x, ct_y), _same,
                     max(1, iters // 4), B * max(1, iters // 4)), B, 4,
               f"{D}-element dot: {D} fused Miller loops + ONE final "
               "exp per item")


def bench_multichip(pk, sk, tables, rng, iters):
    """DP scaling: shard the EMult batch over all visible devices
    (lights up the moment >1 chip exists; scaling efficiency vs 1 chip)."""
    from bgn_jax.parallel import mesh as mesh_mod
    from bgn_jax.parallel import multihost as mh
    from bgn_jax.scheme import _mult_kernel

    ndev = len(jax.devices())
    if ndev < 2:
        log("  multichip: 1 device visible -- skipped")
        return
    B = BATCH * ndev
    ms = [rng.randrange(MSG_SPACE) for _ in range(B)]
    mesh = mh.make_global_mesh()
    a = mesh_mod.shard_ciphertext(pk.encrypt(ms, rng=rng), mesh)
    b = mesh_mod.shard_ciphertext(pk.encrypt(ms, rng=rng), mesh)
    jax.block_until_ready((a, b))
    rate = timed(lambda: _mult_kernel(pk.dev, a.data, b.data),
                 _same, iters, B * iters)
    one_chip = RESULTS.get("Mult", {}).get("ops_per_sec")
    eff = f"; scaling efficiency {rate / (one_chip * ndev):.2f}" \
        if one_chip else ""
    record(f"Mult_dp{ndev}", rate, B, 5, f"DP over {ndev} devices{eff}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="all configs -> results/bench_full.json")
    ap.add_argument("--skip-1024", action="store_true")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()

    from bgn_jax.config import BGNParams

    dev = require_gpu()
    enable_compile_cache()
    # one card unless --full, whose DP section spans every visible card
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()) if args.full else 1,
              "nvidia_smi": gpu_name_power()}
    log(f"device: {device}")
    t0 = time.time()
    rng = random.Random(1234)
    params = BGNParams(key_bits=KEY_BITS, msg_space=MSG_SPACE)
    pk, sk = params.keygen(rng=random.Random(1234))
    rng = random.Random(5678)   # data stream, independent of the key's
    keygen_s = time.time() - t0
    log(f"keygen({KEY_BITS}): {keygen_s:.1f}s "
        f"(l={pk.l}, L={pk.dev.ctx.L} limbs)")
    t0 = time.time()
    tables = pk.setup_decryption(sk, rng=rng)
    log(f"setup_decryption: {time.time() - t0:.1f}s")

    log(f"== config 1+3: core ops at {KEY_BITS}-bit, batch {BATCH}")
    record("KeyGen", 1.0 / keygen_s, 1, 1, "host-side (single)")
    emult = bench_core(pk, sk, tables, rng, BATCH, args.iters, 1,
                       decrypt_batch=DECRYPT_BATCH)

    if args.full:
        log("== config 2: 10^4-batch EAdd/EMultC + poly ops")
        section("batch_10k",
                lambda: bench_batch_10k(pk, rng, max(2, args.iters // 2)))
        section("poly",
                lambda: bench_poly(pk, sk, tables, rng,
                                   max(2, args.iters // 2)))
        section("poly_batched",
                lambda: bench_poly_batched(pk, sk, tables, rng,
                                           max(2, args.iters // 2)))
        # degree-3 variant (value 7.0 -> balanced digits [1,-1,1]): nine
        # pairings per polynomial product
        section("poly_batched_d3",
                lambda: bench_poly_batched(pk, sk, tables, rng,
                                           max(2, args.iters // 2),
                                           B=1024, value=7.0))
        log("== config 4: gadgets")
        section("gadgets", lambda: bench_gadgets(pk, sk, rng, args.iters))
        log("== config 5: multi-chip DP scaling")
        section("multichip",
                lambda: bench_multichip(pk, sk, tables, rng,
                                        max(2, args.iters // 2)))
        if not args.skip_1024:
            log("== config 5: 1024-bit")

            def _bench_1024():
                t0 = time.time()
                rng2 = random.Random(4321)
                pk2, sk2 = BGNParams(key_bits=1024,
                                     msg_space=MSG_SPACE).keygen(rng=rng2)
                record("KeyGen_1024", 1.0 / (time.time() - t0), 1, 5,
                       "host-side (single)")
                tables2 = pk2.setup_decryption(sk2, rng=rng2)
                bench_core(pk2, sk2, tables2, rng2, 512,
                           max(2, args.iters // 2), 5, label="1024")

            section("core_1024", _bench_1024)
        out = {
            "device": device,
            "key_bits": KEY_BITS,
            "msg_space": MSG_SPACE,
            "results": RESULTS,
        }
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results", "bench_full.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        log(f"wrote {path}")

    print(json.dumps({
        "metric": "emult_pairings_per_sec",
        "value": emult,
        "unit": "ops/s",
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
