"""Fixed-width big integers as limb-major uint32 arrays on the device.

Representation: a non-negative integer x < 2^(16*L) is stored as a uint32
array of shape [L, *batch] holding 16-bit limbs, little-endian along axis 0
(limb 0 = least significant).  16-bit limbs are chosen so that a full 16x16
product fits exactly in a uint32 lane and lazy carry accumulation never
overflows (see montgomery.py for the audit) -- this is the batched
replacement for GMP's mpz layer in the reference stack (reference:
README.md:10-25; every pbc Element op bottoms out in GMP).

The limb axis is axis 0 ("limb-major") so that elementwise work vectorizes
over the batch in the trailing (lane) dimensions.

All functions are pure jnp and jit/shard_map friendly: fixed shapes, no
data-dependent control flow.  Carry/borrow propagation uses a carry-lookahead
(generate/propagate) associative scan rather than a sequential ripple.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LIMB_BITS = 16
LIMB_MASK = 0xFFFF


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def num_limbs_for_bits(bits: int) -> int:
    """Limb count for a given bit width."""
    return max(1, -(-bits // LIMB_BITS))


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> uint16-limb vector [L] (host, numpy)."""
    if x < 0:
        raise ValueError("negative")
    if x >> (LIMB_BITS * L):
        raise ValueError(f"{x.bit_length()}-bit value does not fit {L} limbs")
    out = np.zeros((L,), dtype=np.uint32)
    for i in range(L):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def ints_to_limbs(xs: Sequence[int], L: int) -> np.ndarray:
    """[B] python ints -> [L, B] limb array (host, bytes-vectorized)."""
    nbytes = 2 * L
    buf = bytearray(nbytes * len(xs))
    for b, x in enumerate(xs):
        x = int(x)
        if x < 0:
            raise ValueError("negative")
        buf[b * nbytes:(b + 1) * nbytes] = x.to_bytes(nbytes, "little")
    a16 = np.frombuffer(bytes(buf), dtype=np.uint16).reshape(len(xs), L)
    return np.ascontiguousarray(a16.T).astype(np.uint32)


def limbs_to_int(a) -> int:
    """[L] limb vector -> python int (host)."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint16))
    return int.from_bytes(a.tobytes(), "little")


def limbs_to_ints(a) -> list:
    """[L, B] -> list of B python ints (host, bytes-vectorized)."""
    a = np.asarray(a).astype(np.uint16)
    rows = np.ascontiguousarray(a.T)  # [B, L]
    return [int.from_bytes(rows[b].tobytes(), "little")
            for b in range(rows.shape[0])]


def int_to_bits(x: int, nbits: int) -> np.ndarray:
    """Python int -> uint32 bit vector [nbits], MSB first (host)."""
    if x < 0 or (nbits < x.bit_length()):
        raise ValueError("value does not fit")
    return np.array([(x >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.uint32)


def int_to_naf(x: int, width: int) -> np.ndarray:
    """Python int >= 0 -> non-adjacent form, int32 [width+1] digits in
    {-1, 0, 1}, MSB first (host).

    sum_i d_i * 2^(width-i) == x; NAF has no two adjacent nonzeros, so its
    nonzero density is ~1/3 vs ~1/2 for plain bits -- the signed-digit
    ladders in ops/rns_pairing.py do proportionally fewer additions."""
    if x < 0 or width < x.bit_length():
        raise ValueError("value does not fit")
    digits = []
    v = x
    while v:
        if v & 1:
            d = 2 - (v & 3)            # +1 if v%4==1, -1 if v%4==3
            v -= d
        else:
            d = 0
        digits.append(d)
        v >>= 1
    digits += [0] * (width + 1 - len(digits))
    return np.array(digits[::-1], dtype=np.int32)


# ---------------------------------------------------------------------------
# Carry propagation (carry-lookahead via associative scan)
# ---------------------------------------------------------------------------


def _shift_up(x):
    """Shift limbs one position toward the MSB end: out[j] = x[j-1], out[0]=0.
    Returns (shifted, spill) where spill = x[-1] (the limb pushed out)."""
    zero = jnp.zeros_like(x[:1])
    return jnp.concatenate([zero, x[:-1]], axis=0), x[-1]


def _carry_combine(left, right):
    """Carry-lookahead combine: (G, P) over concatenated limb ranges."""
    gl, pl = left
    gr, pr = right
    return (gr | (pr & gl), pr & pl)


def normalize(t) -> Tuple[jax.Array, jax.Array]:
    """Normalize lazy limbs (< 2^32 each) to canonical 16-bit limbs.

    Input value is sum_j t[j] * 2^(16 j).  Returns (limbs, overflow) with
    limbs[j] < 2^16 and value = limbs + overflow * 2^(16 L).  overflow can be
    up to ~2^16 * L for extreme inputs; for sums of two canonical numbers it
    is the usual 0/1 carry-out.
    """
    t = t.astype(jnp.uint32)
    # Pass 1: entries drop to < 2^17.
    hi, lo = t >> LIMB_BITS, t & LIMB_MASK
    shifted, spill1 = _shift_up(hi)
    t = lo + shifted
    # Pass 2: entries drop to <= 2^16.
    hi, lo = t >> LIMB_BITS, t & LIMB_MASK
    shifted, spill2 = _shift_up(hi)
    t = lo + shifted
    # Remaining carries are binary; resolve with carry-lookahead scan.
    g = (t >> LIMB_BITS).astype(jnp.uint32)          # generate (t == 2^16)
    p = (t == LIMB_MASK).astype(jnp.uint32)          # propagate
    G, _ = jax.lax.associative_scan(_carry_combine, (g, p), axis=0)
    c_in, spill3 = _shift_up(G)
    limbs = (t + c_in) & LIMB_MASK
    overflow = spill1 + spill2 + spill3
    return limbs, overflow


def add(a, b) -> Tuple[jax.Array, jax.Array]:
    """a + b -> (limbs mod 2^(16L), carry in {0,1})."""
    return normalize(a + b)


def sub(a, b) -> Tuple[jax.Array, jax.Array]:
    """a - b (two's complement) -> (limbs mod 2^(16L), borrow in {0,1}).

    borrow == 1 iff a < b."""
    t = a + (LIMB_MASK - b)
    one = jnp.zeros_like(t).at[0].add(1)
    limbs, carry = normalize(t + one)
    return limbs, (1 - carry).astype(jnp.uint32)


def geq(a, b) -> jax.Array:
    """a >= b elementwise over the batch; uint32 {0,1} of batch shape."""
    _, borrow = sub(a, b)
    return (1 - borrow).astype(jnp.uint32)


def eq(a, b) -> jax.Array:
    """Exact limb equality; uint32 {0,1} of batch shape."""
    return jnp.all(a == b, axis=0).astype(jnp.uint32)


def is_zero(a) -> jax.Array:
    return jnp.all(a == 0, axis=0).astype(jnp.uint32)


def select(mask, a, b) -> jax.Array:
    """where(mask, a, b) with mask of batch shape broadcast over limbs."""
    return jnp.where(mask.astype(bool)[None], a, b)


def expand_to(v, shape) -> jax.Array:
    """Broadcast v to `shape` by appending trailing batch axes.

    Unlike plain broadcast_to (which aligns trailing dims), this treats the
    leading dims of v as structural (limb/coordinate axes) and the missing
    trailing dims as batch: [L] -> [L, *batch]."""
    v = v.reshape(v.shape + (1,) * (len(shape) - v.ndim))
    return jnp.broadcast_to(v, shape)


def limbs_to_bits_msb(a, nbits: int) -> jax.Array:
    """[L, *B] limbs -> [nbits, *B] bits, MSB first (device).

    nbits must be <= 16*L; the top limbs beyond nbits must be zero for the
    result to represent the full value."""
    L = a.shape[0]
    shifts = jnp.arange(LIMB_BITS, dtype=jnp.uint32)
    # bits_lsb[j, k, ...] = bit k of limb j
    bits = (a[:, None] >> shifts[None, :].reshape((1, LIMB_BITS) + (1,) * (a.ndim - 1))) & 1
    bits = bits.reshape((L * LIMB_BITS,) + a.shape[1:])  # LSB-first
    bits = jnp.flip(bits, axis=0)                         # MSB-first
    return bits[L * LIMB_BITS - nbits:]
