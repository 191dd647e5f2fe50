"""Batched SHA-256 on device (jnp uint32).

Purpose: the Fiat-Shamir transform of the PoK gadget hashes the canonical
bytes of every (ct, nonce) pair (gadgets.go:80-96).  Hashing on host
forces a full coordinate-plane readback -- ~1 MB per batch-2048 verify.
  Hashing on device reads back only the 32-byte digests.

Standard FIPS 180-4 SHA-256, vectorized over the batch: every lane's
message is the same static length, so padding is static and the 64-round
compression unrolls into straight-line uint32 ops (adds wrap mod 2^32 by
dtype).  Byte-for-byte identical to hashlib.sha256 on the same messages
(tests/test_gadgets_serialize.py::test_device_sha256_matches_hashlib).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)


def _rotr(x, n: int):
    return (x >> jnp.uint32(n)) | (x << jnp.uint32(32 - n))


def sha256_words(msg_words):
    """SHA-256 over a batch of equal-length messages.

    msg_words: [B, W] uint32 big-endian message words, W a multiple of
    16 (the message must already carry FIPS padding -- use pad_words).
    Returns [B, 8] uint32 big-endian digest words.

    The schedule and the 64 rounds run as lax.scans (a fully unrolled
    round chain hangs XLA:CPU's scheduler for minutes at compile time;
    the scan body is one round, compiled once)."""
    import jax

    B, W = msg_words.shape
    if W % 16:
        raise ValueError("message words must be a multiple of 16")
    ks = jnp.asarray(_K)

    def sched_step(win, _):
        # win [16, B] = words t-16..t-1; emit word t
        s0 = _rotr(win[1], 7) ^ _rotr(win[1], 18) \
            ^ (win[1] >> jnp.uint32(3))
        s1 = _rotr(win[14], 17) ^ _rotr(win[14], 19) \
            ^ (win[14] >> jnp.uint32(10))
        new = win[0] + s0 + win[9] + s1
        return jnp.concatenate([win[1:], new[None]], axis=0), new

    def round_step(carry, kw):
        k, wt = kw
        a, b, c, d, e, f, g, h = carry
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + k + wt
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        return (t1 + t2, a, b, c, d + t1, e, f, g), None

    hs = tuple(jnp.broadcast_to(jnp.uint32(v), (B,)) for v in _H0)
    for blk in range(W // 16):
        block = msg_words[:, blk * 16:(blk + 1) * 16].T      # [16, B]
        _, rest = jax.lax.scan(sched_step, block, None, length=48)
        w = jnp.concatenate([block, rest], axis=0)           # [64, B]
        out, _ = jax.lax.scan(round_step, hs, (ks, w))
        hs = tuple(x + y for x, y in zip(hs, out))
    return jnp.stack(hs, axis=1)


def pad_words(nbytes: int):
    """Static FIPS padding for an nbytes message (nbytes % 4 == 0):
    returns (pad_words uint32 [P], total_words) to append so the padded
    length is a multiple of 64 bytes."""
    if nbytes % 4:
        raise ValueError("message length must be word-aligned")
    total = ((nbytes + 8) // 64 + 1) * 64
    nzero_words = (total - nbytes - 4 - 8) // 4
    pad = [0x80000000] + [0] * nzero_words
    bits = nbytes * 8
    pad += [(bits >> 32) & 0xFFFFFFFF, bits & 0xFFFFFFFF]
    return np.asarray(pad, dtype=np.uint32), total // 4
