"""RNS (residue number system) Montgomery arithmetic as bf16 matmuls.

The limb CIOS (montgomery.py) is an O(L^2) sequential carry chain per
512-bit modmul.  This module re-represents F_p elements as residues
modulo ~2k independent 12-bit primes, which turns a modular
multiplication into

  1. channelwise products            (O(k) elementwise, all values < 2^24
                                      so plain fp32 FMAs are exact)
  2. two *base extensions*, each a   [3k+1, 2k] x [2k, batch] bf16 matmul
     (Bajard/Kawamura RNS Montgomery  against a host-precomputed constant
     reduction)                       matrix, with fp32 accumulation.

That moves the O(k^2) inner work onto the matrix units.  Functional
replacement for the GMP mulmod layer underneath PBC (reference
README.md:10-25); consumed by ops/rns_pairing.py for the Miller loop of
Element.Pair (reference bgn.go:300).  On the GPU this is the field path
of every hot kernel (ops/pairing.py:use_rns).

Representation
--------------
A value x (0 <= x < ~30p) is a float32 array [2k, *batch] of residues
x mod m_c, CHANNEL-MAJOR (channels on the leading axis, batch on the
trailing axis -- the same convention as the limb layout).  Moduli are
12-bit primes: base A = m[:k], base B = m[k:].  Montgomery domain uses
R_rns = A = prod(m[:k]); the context guarantees the *headroom* h = A//p
>= 1024, so all the static value bounds below hold.  `RVal` pairs the
residue array with its static bound (a Python int multiple of p); `r_mul`
asserts bound_x*bound_y <= h at trace time -- the bound bookkeeping is
free at runtime.

Algorithm (one r_mul, following Bajard et al. / Kawamura's Cox-Rower
approximate base extension):
  d    = x*y mod m           (both bases, channelwise)
  q~   = (d_A * (-p)^-1 * (A/a_i)^-1) mod a_i    (one fused constant)
  ext1 = sum_i q~_i * ((A/a_i) * p * A^-1 mod b_j)  -  alpha * (p mod b_j)
         == q_ext * p * A^-1  (mod b_j); the per-channel constant
         p*A^-1 is folded into the extension matrix, and alpha =
         floor(sum_i q~_i / a_i) is estimated from an extra matmul row
         (an alpha underestimate only adds +p to the result -- tolerated
         by the bound algebra, see _combine_ext).
  r    = (d_B * A^-1 + ext1) mod b_j             (base B; r < 3p)
  ext2 = standard extension of r~ = r * (B/b_j)^-1 back to base A
         (alpha exact here since r/B < 2^-8).
The 6-bit digit splitting keeps every matmul partial sum < 2^24 so bf16
inputs with fp32 accumulation are bit-exact: neither the accumulation
order nor TF32 applies (both operands are already bf16 and every partial
sum is an integer < 2^24).

Exactness audit: every fp32 value in this module is a nonnegative integer
< 2^24 (or an exact product <= 4095*4095 < 2^24), every bf16 matmul input
has <= 8 significant bits, and every fp32 matmul accumulator stays < 2^24
except the alpha row (which only needs ~2^5 absolute accuracy against a
2^19 scale).  Division only appears as multiply-by-reciprocal with a
two-sided fixup (_red).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import limbs as lb

# Static algorithm constants (see module docstring for the audit).
_ALPHA_SCALE = 19          # alpha weights w = round(2^19 / m): 8-bit values
_EPS_UNDER = -0.4          # ext1: bias alpha DOWN so the error is {0,+1}*A
_EPS_EXACT = 0.5           # ext2/CRT: centered -> exact (value/base small)
_KC = 128                  # C = KC*m bias in _combine_ext; needs alpha < KC
_H_MIN = 1024              # required headroom A/p (max static bound product
                           # in the pairing formulas is 900 -- rns_pairing)

# Channel-count threshold between the narrow fast path and the wide path.
# Narrow (k <= 64): the matmul digit blocks recombine in ONE _red
# (worst input k*3969*66 <= 2^24 - 2^12 exactly at k = 64) and alpha
# rides the matmul as a bf16 row (error k*2^-8 < the 0.4 bias window).
# Wide (k > 64): the O1/O2 blocks are reduced separately before
# recombination (exact to k ~ 4000) and alpha comes from an fp32
# channel-reduction against the biased reciprocals (error ~k^2*2^-24,
# fine to k ~ 2500); the KC bias grows with k since alpha <= k.
_K_NARROW = 64


def _kc(k: int) -> int:
    """The C = KC*m bias constant: must exceed the largest alpha (<= k)."""
    return _KC if k <= _K_NARROW else 1 << max(7, (k + 1).bit_length())


def _primes_desc(lo: int = 1031, hi: int = 4096) -> list:
    """11/12-bit channel primes, descending (host, tiny sieve).

    The pool spans [2^10, 2^12): largest-first keeps small keys on few
    big channels; the low tail only engages for multi-thousand-bit
    moduli (~390 primes -> ~195 channels/base -> p up to ~2260 bits,
    covering 2048-bit keys)."""
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(hi ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    ps = np.nonzero(sieve)[0]
    ps = ps[ps >= lo]
    return [int(v) for v in ps[::-1]]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RNSCtx:
    """Device constants for one modulus p.  Meta fields are static ints.
    Per-channel vectors are stored as [*, 1] columns so they broadcast
    against channel-major [*, batch] arrays."""

    # channel moduli and reciprocals, both bases concatenated: [2k, 1]
    m: jax.Array               # f32 moduli
    recip: jax.Array           # f32 1/m (f64-accurate, rounded to f32)
    kp: jax.Array              # f32 [2k, KMAX+1]: (K*p) mod m_c (r_sub);
                               #   K on the lane axis so a static column
                               #   slice needs no relayout in-kernel
    # ext A->B (inside r_mul)
    qc_a: jax.Array            # f32 [k, 1]: (-p)^-1 * (A/a_i)^-1 mod a_i
    w1: jax.Array              # bf16 [3k+1, 2k]: split ext matrix
                               #   (entries (A/a_i)*p*A^-1 mod b_j) + alpha
    p_mod_b: jax.Array         # f32 [k, 1]: p mod b_j (ext1 alpha corr.)
    ainv_b: jax.Array          # f32 [k, 1]: A^-1 mod b_j
    # ext B->A
    crt_inv_b: jax.Array       # f32 [k, 1]: (B/b_j)^-1 mod b_j
    w2: jax.Array              # bf16 [3k+1, 2k]
    b_mod_a: jax.Array         # f32 [k, 1]: B mod a_i
    # exit CRT (base A)
    crt_inv_a: jax.Array       # f32 [k, 1]: (A/a_i)^-1 mod a_i
    w_alpha_a: jax.Array       # f32 [k, 1]: round(2^19/a_i)
    # domain constants (residues over both bases): [2k, 1]
    one_rns: jax.Array         # f32: residues of A mod p  (Montgomery 1)
    c_in: jax.Array            # f32: residues of A^2 * R^-1 mod p (entry)
    c_out: jax.Array           # f32: residues of R mod p          (exit)
    # conversions
    pow2_8: jax.Array          # i32 [2k, D8in]: 2^(8*d) mod m_c
    crt_rows: jax.Array        # i32 [D8, k]: 8-bit digit rows of A/a_i
    a_rows: jax.Array          # i32 [D8, 1]: 8-bit digit rows of A
    p_limbs: jax.Array         # u32 [L+1]: p as 16-bit limbs (exit reduce)
    # static
    k: int = dataclasses.field(metadata=dict(static=True))
    h: int = dataclasses.field(metadata=dict(static=True))
    L: int = dataclasses.field(metadata=dict(static=True))


_KMAX = 32  # largest ceil(bound) ever passed to r_sub (max in pairing: 27)


def select_channels(p: int):
    """Deterministic channel choice for modulus p: interleave the prime
    pool between the bases so their products stay balanced, growing k
    until BOTH have headroom >= _H_MIN.  Host-only; also used by key-build
    code that needs the moduli as Python ints without reading the device
    arrays back (scheme._win_rns)."""
    if p <= 1:
        raise ValueError(f"select_channels needs a modulus > 1, got {p} "
                         "(a MontCtx without p_host?)")
    primes = _primes_desc()
    A, B, k = 1, 1, 0
    target = p * _H_MIN
    while A < target or B < target:
        if 2 * k + 1 >= len(primes):
            raise ValueError(
                "modulus too large for the 12-bit RNS prime pool")
        A *= primes[2 * k]
        B *= primes[2 * k + 1]
        k += 1
    return primes[0:2 * k:2], primes[1:2 * k:2], k


def make_rns_ctx(p: int, L: int | None = None) -> RNSCtx:
    """Build the RNS context for modulus p (host-side, exact python ints).

    L: limb count of the companion limb-domain MontCtx (R = 2^(16L));
    defaults to the minimal width, matching make_mont_ctx."""
    if L is None:
        L = lb.num_limbs_for_bits(p.bit_length())
    R = 1 << (16 * L)
    if not (p % 2 and p > (1 << 13)):
        raise ValueError("modulus must be an odd prime > 2^13")

    A_list, B_list, k = select_channels(p)
    A, B = 1, 1
    for a in A_list:
        A *= a
    for b in B_list:
        B *= b
    h = A // p
    assert h >= _H_MIN and B // p >= _H_MIN

    m_all = A_list + B_list
    f32 = np.float32
    m_np = np.array(m_all, dtype=np.int64)

    def col(vals) -> np.ndarray:
        return np.asarray(vals, dtype=f32).reshape(-1, 1)

    def residues(x: int) -> np.ndarray:
        return col([x % m for m in m_all])

    # --- ext A->B constants (p*A^-1 folded into the matrix)
    Ainv_mod_b = [pow(A % b, -1, b) for b in B_list]
    AoverAi = [A // a for a in A_list]
    qc_a = [((-pow(p, -1, a)) % a) *
            pow(AoverAi[i] % a, -1, a) % a
            for i, a in enumerate(A_list)]
    mat1 = np.array(
        [[AoverAi[i] % b * p % b * Ainv_mod_b[j] % b
          for i in range(k)] for j, b in enumerate(B_list)],
        dtype=np.int64)                       # [k(dst j), k(src i)]
    w1a = np.array([round((1 << _ALPHA_SCALE) / a) for a in A_list],
                   dtype=np.int64)

    # --- ext B->A constants
    BoverBj = [B // b for b in B_list]
    crt_inv_b = [pow(BoverBj[j] % B_list[j], -1, B_list[j])
                 for j in range(k)]
    mat2 = np.array([[BoverBj[j] % a for j in range(k)]
                     for a in A_list], dtype=np.int64)
    w2a = np.array([round((1 << _ALPHA_SCALE) / b) for b in B_list],
                   dtype=np.int64)

    def split_w(mat: np.ndarray, w: np.ndarray) -> np.ndarray:
        """[k_dst, k_src] int matrix + [k_src] alpha weights ->
        bf16 [3k+1, 2k].

        Matmul is W @ x_split with x_split = [hi(6b); lo(6b)] stacked on
        the source-channel axis; output rows are the three weighted
        blocks (S = 4096*O1 + 64*O2 + O3) plus the alpha-estimate row.
        On the wide path (k > _K_NARROW) alpha comes from an fp32
        channel reduction instead, so the row is zeroed (its weights
        would not be bf16-exact for the small-prime tail anyway)."""
        hi, lo = mat >> 6, mat & 63
        W = np.zeros((3 * k + 1, 2 * k), dtype=np.float32)
        W[0:k, :k] = hi
        W[k:2 * k, :k] = lo
        W[k:2 * k, k:] = hi
        W[2 * k:3 * k, k:] = lo
        if k <= _K_NARROW:
            W[3 * k, :k] = w * 64
            W[3 * k, k:] = w
        Wb = W.astype(jnp.bfloat16)
        assert np.array_equal(np.asarray(Wb, dtype=np.float32), W)
        return Wb

    # --- conversions
    d8_in = 2 * L  # 8-bit digit rows of a 16L-bit input
    pow2_8 = np.array([[pow(256, d, m) for d in range(d8_in)]
                       for m in m_all], dtype=np.int32)
    D8 = -(-(12 * k) // 8) + 1

    def rows8(x: int, n: int) -> np.ndarray:
        return np.array([(x >> (8 * d)) & 0xFF for d in range(n)],
                        dtype=np.int32)

    crt_rows = np.stack([rows8(AoverAi[i], D8) for i in range(k)], axis=1)
    a_rows = rows8(A, D8).reshape(-1, 1)

    kmax_p = np.array(
        [[(K * p) % m for K in range(_KMAX + 1)] for m in m_all],
        dtype=f32)

    # downward-biased reciprocal: see _red
    recip = ((1.0 - 2.0 ** -21) / m_np.astype(np.float64)) \
        .astype(f32).reshape(-1, 1)

    return RNSCtx(
        m=jnp.asarray(col(m_np)),
        recip=jnp.asarray(recip),
        kp=jnp.asarray(kmax_p),
        qc_a=jnp.asarray(col(qc_a)),
        w1=jnp.asarray(split_w(mat1, w1a)),
        p_mod_b=jnp.asarray(col([p % b for b in B_list])),
        ainv_b=jnp.asarray(col(Ainv_mod_b)),
        crt_inv_b=jnp.asarray(col(crt_inv_b)),
        w2=jnp.asarray(split_w(mat2, w2a)),
        b_mod_a=jnp.asarray(col([B % a for a in A_list])),
        crt_inv_a=jnp.asarray(col(
            [pow(AoverAi[i] % A_list[i], -1, A_list[i]) for i in range(k)])),
        w_alpha_a=jnp.asarray(col(w1a)),
        one_rns=jnp.asarray(residues(A % p)),
        c_in=jnp.asarray(residues((A * A * pow(R, -1, p)) % p)),
        c_out=jnp.asarray(residues(R % p)),
        pow2_8=jnp.asarray(pow2_8),
        crt_rows=jnp.asarray(crt_rows),
        a_rows=jnp.asarray(a_rows),
        p_limbs=jnp.asarray(lb.int_to_limbs(p, L + 1)),
        k=k, h=h, L=L,
    )


# ---------------------------------------------------------------------------
# Channelwise primitives (all fp32, all values exact integers < 2^24)
# ---------------------------------------------------------------------------


def _red(v, m, recip):
    """v mod m for integer-valued fp32 v with v <= 2^24 - 2^12.

    recip is the DOWNWARD-BIASED reciprocal (1/m)*(1 - 2^-21): the
    product error v*recip - v/m is then strictly negative with magnitude
    < 2^-7, so q in {floor(v/m)-1, floor(v/m)} and a single conditional
    subtraction restores exactness (one-sided; saves 2 elementwise ops
    per call over a two-sided fixup -- _red is ~500 of the ~3k ops per
    r_mul).  Only v*recip is inexact: every other product here is an
    exact integer < 2^24, so FMA contraction cannot move the window."""
    q = jnp.floor(v * recip)
    r = v - q * m
    return jnp.where(r >= m, r - m, r)


class RVal(NamedTuple):
    """Residues + static value bound (value < bound * p).  NOT a pytree --
    unwrap to .v before crossing scan/cond boundaries."""
    v: jax.Array      # f32 [2k, *batch]
    bound: int


def _split6(x):
    """6-bit digit split for the bf16 matmul: [k, *b] -> [2k, *b]."""
    hi = jnp.floor(x * (1.0 / 64.0))
    lo = x - hi * 64.0
    return jnp.concatenate([hi, lo], axis=0).astype(jnp.bfloat16)


def _ext_dot(W, x):
    """[3k+1, 2k] @ [2k, *batch] -> [3k+1, *batch], bf16 in, fp32 out."""
    return jax.lax.dot_general(
        W, x, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _alpha_sum(digits, recip_src, eps):
    """Wide-path alpha estimate: floor(sum_i digits_i/m_i + eps) via an
    fp32 channel reduction against the biased reciprocals.  Error is
    ~k^2*2^-24 (partial sums <= k, fp32 rounding) + k*2^-21 downward bias
    -- orders of magnitude inside the eps windows for k <= ~2500."""
    bshape = (1,) * (digits.ndim - 1)
    s = jnp.sum(digits * recip_src.reshape((-1,) + bshape), axis=0)
    return jnp.floor(s + eps)


def _combine_ext(rns: RNSCtx, O, m_dst, recip_dst, base_mod_dst, eps,
                 alpha=None):
    """Matmul output -> destination-base residues of (value + e*base).

    O: [3k+1, *batch] fp32 from W @ (split source digits).
    S_j = 4096*O1 + 64*O2 + O3 is congruent to (value + alpha_true*base)
    mod each destination channel; alpha_hat = floor(Sa/2^19 + eps) on the
    narrow path, or is passed in from _alpha_sum on the wide path.  With
    eps=_EPS_UNDER the residual e = alpha_true - alpha_hat is in {0, 1}
    (value read as value + e*base); with eps=_EPS_EXACT and value/base
    < 2^-8 the extension is exact (e = 0)."""
    k = rns.k
    O1, O2, O3 = O[:k], O[k:2 * k], O[2 * k:3 * k]
    if alpha is None:
        assert k <= _K_NARROW, "wide path must pass a precomputed alpha"
        alpha = jnp.floor(O[3 * k] * (1.0 / (1 << _ALPHA_SCALE)) + eps)
    if k <= _K_NARROW:
        # single reduction: O1*64 + O2 <= k*3969*66 <= 2^24 - 2^12 exact
        v = _red(O1 * 64.0 + O2, m_dst, recip_dst)
    else:
        # staged: O1, O2 <= 2k*3969 reduced separately (exact to k~2000),
        # then v1*64 + v2 < 2^18 + 2^12
        v1 = _red(O1, m_dst, recip_dst)
        v2 = _red(O2, m_dst, recip_dst)
        v = _red(v1 * 64.0 + v2, m_dst, recip_dst)
    # digit-recombine + alpha correction in one reduction:
    # v*64 + O3 + (KC*m - alpha*base) < 2^18.8 + k*3969 + KC*4096 <= 2^24
    KC = _kc(k)
    T = v * 64.0 + O3 + (KC * m_dst - alpha[None] * base_mod_dst)
    return _red(T, m_dst, recip_dst), alpha


def r_mul(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    """RNS Montgomery product: value (x*y/A) mod-ish p, bound 3.

    Requires x.bound * y.bound <= h (checked at trace time)."""
    assert x.bound * y.bound <= rns.h, (x.bound, y.bound, rns.h)
    k = rns.k
    mA, mB = rns.m[:k], rns.m[k:]
    rA_m, rB_m = rns.recip[:k], rns.recip[k:]

    d = _red(x.v * y.v, rns.m, rns.recip)          # both bases
    dA, dB = d[:k], d[k:]
    qhat = _red(dA * rns.qc_a, mA, rA_m)
    O = _ext_dot(rns.w1, _split6(qhat))
    wide = k > _K_NARROW
    a1 = _alpha_sum(qhat, rA_m, _EPS_UNDER) if wide else None
    # ext1 yields q_ext * p * A^-1 directly (constants folded into w1)
    qpa, _ = _combine_ext(rns, O, mB, rB_m, rns.p_mod_b, _EPS_UNDER, a1)

    u = _red(dB * rns.ainv_b, mB, rB_m) + qpa      # < 2m
    r = jnp.where(u >= mB, u - mB, u)              # base-B residues, < 3p

    rhat = _red(r * rns.crt_inv_b, mB, rB_m)
    O2 = _ext_dot(rns.w2, _split6(rhat))
    a2 = _alpha_sum(rhat, rB_m, _EPS_EXACT) if wide else None
    r_a, _ = _combine_ext(rns, O2, mA, rA_m, rns.b_mod_a, _EPS_EXACT, a2)
    return RVal(jnp.concatenate([r_a, r], axis=0), 3)


def r_mul_many(rns: RNSCtx, pairs) -> list:
    """Stacked r_mul over independent (x, y) RVal pairs of equal shape.

    One dot serves the whole group (the pairs join along the matmul N
    dimension), amortizing launch overhead and filling the matrix units;
    the Miller steps feed their per-dependency-layer mul groups here.
    Concatenation along the trailing (lane) axis keeps the stacked
    arrays 2-D."""
    for x, y in pairs:
        assert x.bound * y.bound <= rns.h, (x.bound, y.bound, rns.h)
    if len(pairs) == 1:
        return [r_mul(rns, *pairs[0])]
    n = pairs[0][0].v.shape[-1]
    xs = jnp.concatenate([x.v for x, _ in pairs], axis=-1)
    ys = jnp.concatenate([y.v for _, y in pairs], axis=-1)
    out = r_mul(rns, RVal(xs, 1), RVal(ys, 1)).v
    return [RVal(out[..., i * n:(i + 1) * n], 3)
            for i in range(len(pairs))]


def r_add(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    s = x.v + y.v
    s = jnp.where(s >= rns.m, s - rns.m, s)
    return RVal(s, x.bound + y.bound)


def r_sub(rns: RNSCtx, x: RVal, y: RVal) -> RVal:
    """x - y + K*p with K = y.bound, keeping the value nonnegative."""
    K = y.bound
    assert K <= _KMAX, K
    t = x.v + rns.kp[:, K:K + 1] - y.v             # in (-m, 2m)
    t = jnp.where(t < 0, t + rns.m, t)
    t = jnp.where(t >= rns.m, t - rns.m, t)
    return RVal(t, x.bound + K)


def r_one(rns: RNSCtx, batch_shape=()) -> RVal:
    v = rns.one_rns.reshape((-1,) + (1,) * len(batch_shape))
    return RVal(jnp.broadcast_to(v, v.shape[:1] + tuple(batch_shape)), 1)


def r_zero(rns: RNSCtx, batch_shape=()) -> RVal:
    return RVal(jnp.zeros((2 * rns.k,) + tuple(batch_shape), jnp.float32), 1)


def r_pow_bits(rns: RNSCtx, x: RVal, bits) -> RVal:
    """x^e in F_p, e as MSB-first bits: a square-and-multiply scan (the
    Fermat inversions of the RNS pairing, normalize and batch inverse)."""
    assert x.bound <= 16, x.bound
    one_b = jnp.broadcast_to(
        rns.one_rns.reshape((-1,) + (1,) * (x.v.ndim - 1)), x.v.shape)

    def step(acc, bit):
        sq = r_mul(rns, RVal(acc, 3), RVal(acc, 3))
        mu = r_mul(rns, sq, x)
        return jnp.where(bit.astype(bool), mu.v, sq.v), None

    acc, _ = jax.lax.scan(step, one_b, bits)
    return RVal(acc, 3)


def r_batch_inv(rns: RNSCtx, zs, pm2_bits):
    """Montgomery batch inversion of a [C, 2k, *batch] stack of nonzero
    values (each bound <= 6): prefix-product chain along the leading axis,
    ONE Fermat inversion of the total, then a backward unscan -- ~3 r_muls
    per element instead of a Fermat each (the RNS analog of
    montgomery.batch_mont_inv; zero entries must be pre-substituted by the
    caller).  Returns [C, 2k, *batch] residues of the inverses, bound 3."""
    # forward prefix products: pre[i] = z_0 * ... * z_{i-1}  (pre[0] = 1)
    def fwd(acc, z):
        nxt = r_mul(rns, RVal(acc, 3), RVal(z, 6)).v
        return nxt, acc

    one_b = jnp.broadcast_to(
        rns.one_rns.reshape((-1,) + (1,) * (zs.ndim - 2)), zs.shape[1:])
    total, pres = jax.lax.scan(fwd, one_b, zs)
    t = r_pow_bits(rns, RVal(total, 3), pm2_bits).v      # total^-1

    # backward: inv_i = t_i * pre[i];  t_{i-1} = t_i * z_i
    def bwd(t, z_pre):
        z, pre = z_pre
        inv = r_mul(rns, RVal(t, 3), RVal(pre, 3)).v
        t2 = r_mul(rns, RVal(t, 3), RVal(z, 6)).v
        return t2, inv

    _, invs = jax.lax.scan(bwd, t, (zs, pres), reverse=True)
    return invs


# ---------------------------------------------------------------------------
# Conversions (cold path: once per pairing)
# ---------------------------------------------------------------------------


def limbs_to_rns(rns: RNSCtx, x) -> jax.Array:
    """Canonical 16-bit limbs [L, *batch] (< p) -> residues [2k, *batch]."""
    L = x.shape[0]
    lo = (x & 0xFF).astype(jnp.int32)
    hi = (x >> 8).astype(jnp.int32)
    d8 = jnp.stack([lo, hi], axis=1).reshape((2 * L,) + x.shape[1:])
    S = jax.lax.dot_general(
        rns.pow2_8, d8, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)          # [2k, *batch] < 2^26
    # int-domain reduction (S exceeds fp32 exactness)
    f = S.astype(jnp.float32)
    bshape = (1,) * (S.ndim - 1)
    recip = rns.recip.reshape((-1,) + bshape)
    m_i = rns.m.astype(jnp.int32).reshape((-1,) + bshape)
    q = jnp.floor(f * recip).astype(jnp.int32)
    r = S - q * m_i
    r = jnp.where(r < 0, r + m_i, r)
    r = jnp.where(r < 0, r + m_i, r)
    r = jnp.where(r >= m_i, r - m_i, r)
    r = jnp.where(r >= m_i, r - m_i, r)
    return r.astype(jnp.float32)


def rns_to_limbs(rns: RNSCtx, x: RVal):
    """Exact CRT: residues (value < 3p) -> canonical limbs [L, *batch] < p.

    x = sum_i xhat_i*(A/a_i) - alpha*A with alpha exact (value/A < 2^-8),
    assembled in 8-bit digit rows with a statically unrolled signed carry
    ripple, then reduced by up to two conditional subtractions of p."""
    assert x.bound <= 8, x.bound
    k, L = rns.k, rns.L
    bshape = (1,) * (x.v.ndim - 1)
    mA = rns.m[:k].reshape((k,) + bshape)
    rA_m = rns.recip[:k].reshape((k,) + bshape)
    xa = x.v[:k]
    xhat = _red(xa * rns.crt_inv_a.reshape((k,) + bshape), mA, rA_m)
    if k <= _K_NARROW:
        alpha = jnp.floor(
            jnp.sum(xhat * rns.w_alpha_a.reshape((k,) + bshape), axis=0)
            * (1.0 / (1 << _ALPHA_SCALE)) + _EPS_EXACT).astype(jnp.int32)
    else:
        alpha = _alpha_sum(xhat, rA_m, _EPS_EXACT).astype(jnp.int32)
    S = jax.lax.dot_general(
        rns.crt_rows, xhat.astype(jnp.int32), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)          # [D8, *batch] < 2^27
    T = S - alpha[None] * rns.a_rows.reshape((-1,) + bshape)
    # signed carry ripple over the D8 digit rows (cold path, unrolled)
    D8 = T.shape[0]
    digits = []
    carry = jnp.zeros(T.shape[1:], jnp.int32)
    for j in range(D8):
        t = T[j] + carry
        carry = t >> 8                             # arithmetic shift: floor
        digits.append(t - (carry << 8))
    # 8-bit digits -> 16-bit limbs [L+1, *batch]
    n16 = L + 1
    rows = digits + [jnp.zeros_like(digits[0])] * (2 * n16 - D8)
    rows = rows[:2 * n16]
    lim = jnp.stack(
        [(rows[2 * i] + (rows[2 * i + 1] << 8)).astype(jnp.uint32)
         for i in range(n16)], axis=0)             # [L+1, *batch]
    # value < 3p: subtract p up to twice
    p_ext = lb.expand_to(rns.p_limbs, lim.shape)
    for _ in range(2):
        dsub, borrow = lb.sub(lim, p_ext)
        lim = lb.select(borrow, lim, dsub)
    return lim[:L]


def to_rns_mont(rns: RNSCtx, x_mont_limbs) -> RVal:
    """Limb Montgomery form (x*R mod p, [L, *batch]) -> RNS Montgomery form
    (residues of x*A mod-ish p, bound 3)."""
    v = limbs_to_rns(rns, x_mont_limbs)
    c = rns.c_in.reshape((-1,) + (1,) * (v.ndim - 1))
    return r_mul(rns, RVal(v, 1), RVal(jnp.broadcast_to(c, v.shape), 1))


def from_rns_mont(rns: RNSCtx, x: RVal):
    """RNS Montgomery form -> limb Montgomery form (x*R mod p)."""
    c = rns.c_out.reshape((-1,) + (1,) * (x.v.ndim - 1))
    cb = RVal(jnp.broadcast_to(c, x.v.shape), 1)
    return rns_to_limbs(rns, r_mul(rns, x, cb))
