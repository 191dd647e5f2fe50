"""The BGN scheme: keygen, encryption, homomorphic ops, decryption.

Batched JAX analog of the reference's bgn.go.  Design stance (SURVEY.md §7):
*arrays of ciphertexts, not ciphertext objects* -- a Ciphertext holds a
whole batch; every op is a batched XLA kernel over limb arrays, jitted once
per (key_bits, batch_shape) and reused across keys.

Level rules, deterministic-mode branches and failure semantics mirror the
reference exactly:
  - Encrypt: C = P^m * Q^r in G1 (EncryptWithRandomness, bgn.go:340-353);
    EncryptDeterministic: C = P^m (bgn.go:325-331).
  - Add/Sub: group op in G1 or GT with auto-promotion of mixed levels via
    makeL2 = e(C, E_det(1)) (bgn.go:316-321, 442-497); re-randomization by
    Q^r / e(Q,Q)^r unless pk.deterministic.  (The reference's L2 Sub
    mislabels its randomized result L2=false, bgn.go:411 -- a known quirk we
    deliberately do NOT replicate; SURVEY.md §2.1.)
  - Mult: e(C1, C2) -> L2 (bgn.go:294-314); MultConst: C^k (bgn.go:253-291).
  - Decrypt: csk = C^q1, BSGS against gsk = P^q1 / e(P,P)^q1 with the
    negative-retry fused in (bgn.go:205-250, gsbs.go) -- see ops/bsgs.py.

Host big-int state (n, l, q1, ...) lives on plain Python objects; only limb
arrays enter jit, so one compiled kernel serves every same-width key.
"""

from __future__ import annotations

import dataclasses
import functools
import secrets
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import hostmath as hm
from .fieldcore import limbs as lb
from .fieldcore import montgomery as mg
from .fieldcore.montgomery import MontCtx
from .ops import bsgs as bsgs_mod
from .ops import curve as cv
from .ops import fp2
from .ops import pairing as pairing_mod
from .utils import convert

# Limb head-room beyond key_bits for the cofactor l (p = l*n - 1).
_L_MARGIN_BITS = 32


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PublicDeviceKey:
    """Device-resident public key material (the pytree passed into jit)."""

    ctx: MontCtx
    rns: Any                # RNSCtx (the RNS field path) or None
    P: cv.AffinePoint       # generator of G1, scalar batch ()
    Q: cv.AffinePoint       # generator of the order-q1 subgroup
    n_bits: jax.Array       # [key_bits] bits of n, MSB first (Miller loop)
    n_naf: jax.Array        # signed NAF digits of n, MSB first (RNS Miller
                            #   loop: ~1/3 the add-steps of n_bits)
    l_bits: jax.Array       # [32] bits of the cofactor l (final exp)
    pair_qq: jax.Array      # [2, L] e(Q, Q) (L2 re-randomization)
    gt_gen: jax.Array       # [2, L] e(P, P)
    p_win: cv.AffinePoint   # radix-2^w window table of P, batch (J, R)
    q_win: cv.AffinePoint   # radix-2^w window table of Q
    p_win_rns: Any          # RNS residues of p_win ([2k,J,R] x, y) or None
    q_win_rns: Any          # RNS residues of q_win, or None


@dataclasses.dataclass
class PolyEncodingParams:
    """Reference PolyEncodingParams (bgn.go:20-24)."""

    poly_base: int
    fp_scale_base: int
    fp_precision: float


class BGNPublicKey:
    """Public key: host metadata + device arrays + op methods.

    Mirrors the reference PublicKey struct (bgn.go:28-41); `dev` plays the
    role of the pbc pairing context."""

    def __init__(self, key_bits: int, n: int, l: int, p: int,
                 msg_space: int, deterministic: bool,
                 poly_params: PolyEncodingParams,
                 P_host: Tuple[int, int], Q_host: Tuple[int, int],
                 dev: PublicDeviceKey):
        self.key_bits = key_bits
        self.n = n
        self.l = l
        self.p = p
        self.msg_space = msg_space
        self.deterministic = deterministic
        self.poly_params = poly_params
        self.P_host = P_host
        self.Q_host = Q_host
        self.dev = dev
        self._encoding_tables = None  # filled by encoding.compute_tables
        self._sampler_ctx = None      # lazy device-RNG MontCtx (mod n)

    # -- encryption ---------------------------------------------------------

    def encrypt(self, ms: Sequence[int], rng=None) -> "Ciphertext":
        """Randomized encryption of a batch of ints (Encrypt, bgn.go:334)."""
        ms = list(np.atleast_1d(np.asarray(ms, dtype=object)))
        rs = [_rand_below(self.n, rng) for _ in ms]
        return self.encrypt_with_randomness(ms, rs)

    def encrypt_with_randomness(self, ms, rs) -> "Ciphertext":
        """C = P^m * Q^r (EncryptWithRandomness, bgn.go:340-353).

        Batches are padded to power-of-two buckets (min 8) so the jit
        cache sees few distinct shapes; padding lanes encrypt 0 and are
        sliced off."""
        ms = _to_list(ms)
        rs = _to_list(rs)
        B = len(ms)
        Bp = _bucket(B)
        m_digits, m_neg = _signed_digits(ms + [0] * (Bp - B), self.n)
        r_digits, r_neg = _signed_digits(rs + [0] * (Bp - B), self.n)
        if np.any(r_neg):
            raise ValueError("randomness must be non-negative")
        pt = _encrypt_kernel(self.dev, m_digits, jnp.asarray(m_neg), r_digits)
        return Ciphertext(pt, level2=False)[:B]

    def encrypt_device(self, ms, key) -> "Ciphertext":
        """Randomized encryption with fully on-device randomness.

        `key` is a jax.random key; the Q^r exponent comes from threefry
        bits reduced mod n with < 2^-64 bias (utils/rng.py), so jitted
        pipelines never leave the device for entropy.  The host-CSPRNG
        `encrypt` remains the default (mirrors crypto/rand, bgn.go:567)."""
        ms = _to_list(ms)
        B = len(ms)
        Bp = _bucket(B)
        m_digits, m_neg = _signed_digits(ms + [0] * (Bp - B), self.n)
        if self._sampler_ctx is None:
            from .utils import rng as rng_mod
            self._sampler_ctx = rng_mod.make_device_sampler_ctx(self.n)
        J = -(-self.n.bit_length() // _WINDOW_BITS)
        r_digits = _device_r_digits(self._sampler_ctx, key, Bp, J)
        pt = _encrypt_kernel(self.dev, m_digits, jnp.asarray(m_neg), r_digits)
        return Ciphertext(pt, level2=False)[:B]

    def encrypt_deterministic(self, ms) -> "Ciphertext":
        """C = P^m (EncryptDeterministic, bgn.go:325-331)."""
        ms = _to_list(ms)
        B = len(ms)
        Bp = _bucket(B)
        m_digits, m_neg = _signed_digits(ms + [0] * (Bp - B), self.n)
        pt = _encrypt_det_kernel(self.dev, m_digits, jnp.asarray(m_neg))
        return Ciphertext(pt, level2=False)[:B]

    def encrypt_zero(self, batch: int = 1) -> "Ciphertext":
        """E_det(0) = O (encryptZero, bgn.go:562-564)."""
        return self.encrypt_deterministic([0] * batch)

    # -- homomorphic ops ----------------------------------------------------

    def add(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Homomorphic addition with auto level promotion (Add, bgn.go:442)."""
        a, b = self._promote(a, b)
        if a.level2:
            out = _add_l2_kernel(self.dev, a.data, b.data)
            out = self._rerandomize_l2(out, rng)
            return Ciphertext(out, level2=True)
        out = _add_l1_kernel(self.dev, a.data, b.data)
        out = self._rerandomize_l1(out, rng)
        return Ciphertext(out, level2=False)

    def sub(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Homomorphic subtraction (Sub, bgn.go:375-433; the bgn.go:411
        level-flag bug is intentionally not replicated)."""
        a, b = self._promote(a, b)
        if a.level2:
            out = _sub_l2_kernel(self.dev, a.data, b.data)
            out = self._rerandomize_l2(out, rng)
            return Ciphertext(out, level2=True)
        out = _sub_l1_kernel(self.dev, a.data, b.data)
        out = self._rerandomize_l1(out, rng)
        return Ciphertext(out, level2=False)

    def neg(self, a: "Ciphertext", rng=None) -> "Ciphertext":
        """Additive inverse: Sub(E_det(0), c) (Neg, bgn.go:436-439)."""
        zero = self.encrypt_zero(batch=int(np.prod(a.batch_shape, dtype=int))
                                 ).reshape(a.batch_shape)
        return self.sub(zero, a, rng=rng)

    def mult(self, a: "Ciphertext", b: "Ciphertext", rng=None) -> "Ciphertext":
        """Ciphertext-ciphertext multiply via the pairing (Mult, bgn.go:294).

        Both inputs must be L1; result is L2 (one multiplication depth)."""
        if a.level2 or b.level2:
            raise ValueError("Mult requires two level-1 ciphertexts")
        out = _mult_kernel(self.dev, a.data, b.data)
        out = self._rerandomize_l2(out, rng)
        return Ciphertext(out, level2=True)

    def mult_const(self, a: "Ciphertext", ks, rng=None) -> "Ciphertext":
        """Multiply by plaintext constant(s): C^k (MultConst, bgn.go:253).

        ks: scalar or [batch] ints (negative allowed, via inversion).

        Fast path: per-element RNS ladders (rns_pairing.
        scalar_mul_vec_rns / fp2_pow_vec_rns).  The G1 ladder's incomplete
        additions are provably safe only while 2^nbits < min(q1, q2)
        (see its docstring); exponents wider than key_bits//2 - 2 bits
        (possible only for |k| ~ n) take the complete limb ladder."""
        ks = _const_list(ks, a.batch_shape)
        k_bits, k_neg = _signed_bits(ks, self.n)
        # multi-dim batches (e.g. poly batches [d, B]): bits/neg follow
        # the ciphertext's batch shape
        k_bits = k_bits.reshape((k_bits.shape[0],) + tuple(a.batch_shape))
        k_neg = k_neg.reshape(tuple(a.batch_shape))
        rns_ok = (pairing_mod.use_rns(self.dev.rns)
                  and k_bits.shape[0] <= self.key_bits // 2 - 2)
        if a.level2:
            kern = (_mult_const_l2_rns_kernel
                    if pairing_mod.use_rns(self.dev.rns)
                    else _mult_const_l2_kernel)
            out = kern(self.dev, a.data, k_bits, jnp.asarray(k_neg))
            out = self._rerandomize_l2(out, rng)
            return Ciphertext(out, level2=True)
        kern = _mult_const_l1_rns_kernel if rns_ok else _mult_const_l1_kernel
        out = kern(self.dev, a.data, k_bits, jnp.asarray(k_neg))
        out = self._rerandomize_l1(out, rng)
        return Ciphertext(out, level2=False)

    def make_l2(self, a: "Ciphertext") -> "Ciphertext":
        """Promote L1 -> L2 via e(C, E_det(1)) (makeL2, bgn.go:316-321)."""
        if a.level2:
            return a
        return Ciphertext(_make_l2_kernel(self.dev, a.data), level2=True)

    # -- decryption setup ---------------------------------------------------

    def setup_decryption(self, sk: "BGNSecretKey",
                         rng=None) -> bsgs_mod.DecryptTables:
        """Precompute gsk values + BSGS tables (SetupDecryption,
        bgn.go:195-201; PrecomputeTables, gsbs.go:41-51)."""
        import random as _random
        rng = rng or _random.Random(secrets.randbits(64))
        gk = hm.GoldenKey(params=sk.a1_params, P=self.P_host, Q=self.Q_host,
                          R=sk.r, msg_space=self.msg_space)
        return bsgs_mod.build_decrypt_tables(gk, self.dev.ctx, rng)

    # -- internals ----------------------------------------------------------

    def _promote(self, a, b):
        if a.level2 and not b.level2:
            b = self.make_l2(b)
        if b.level2 and not a.level2:
            a = self.make_l2(a)
        return a, b

    def _rerandomize_l1(self, pt: cv.AffinePoint, rng) -> cv.AffinePoint:
        """Multiply by Q^r unless deterministic (e.g. bgn.go:484-496)."""
        if self.deterministic:
            return pt
        r_digits, _ = _signed_digits(
            [_rand_below(self.n, rng)
             for _ in range(_flat(pt.inf.shape))], self.n)
        r_digits = r_digits.reshape((r_digits.shape[0],) + pt.inf.shape)
        return _rerand_l1_kernel(self.dev, pt, r_digits)

    def _rerandomize_l2(self, z, rng):
        """Multiply by e(Q,Q)^r unless deterministic (e.g. bgn.go:462-475)."""
        if self.deterministic:
            return z
        shape = z.shape[2:]
        r_bits, _ = _signed_bits([_rand_below(self.n, rng)
                                  for _ in range(_flat(shape))], self.n)
        r_bits = r_bits.reshape((r_bits.shape[0],) + shape)
        return _rerand_l2_kernel(self.dev, z, r_bits)


class BGNSecretKey:
    """Secret key {q1, R, poly_base} (reference SecretKey, bgn.go:57-62)."""

    def __init__(self, a1_params: hm.A1Params, r: int, poly_base: int):
        self.a1_params = a1_params
        self.key = a1_params.q1            # reference SecretKey.Key
        self.r = r
        self.poly_base = poly_base
        nb = a1_params.q1.bit_length()
        self.q1_bits = jnp.asarray(lb.int_to_bits(a1_params.q1, nb))
        self.q1_naf, _ = _exp_digits(
            a1_params.q1, nb,
            (a1_params.q1, a1_params.q2, a1_params.n))

    # -- decryption ---------------------------------------------------------

    def decrypt(self, ct: "Ciphertext", pk: BGNPublicKey,
                tables: bsgs_mod.DecryptTables):
        """Batched decrypt; raises if any element is out of range
        (Decrypt, bgn.go:205-207)."""
        vals, ok = self.decrypt_with_status(ct, pk, tables)
        if not bool(np.all(ok)):
            raise ValueError("cannot find discrete log; out of bounds")
        return vals

    def decrypt_failsafe(self, ct: "Ciphertext", pk: BGNPublicKey,
                         tables: bsgs_mod.DecryptTables):
        """Failed lanes decrypt to 0 (DecryptFailSafe, bgn.go:210-216)."""
        vals, ok = self.decrypt_with_status(ct, pk, tables)
        return np.where(ok, vals, 0)

    def decrypt_with_status(self, ct: "Ciphertext", pk: BGNPublicKey,
                            tables: bsgs_mod.DecryptTables):
        """Returns (values int64 [batch], ok bool [batch])."""
        if ct.level2:
            found, m = _decrypt_l2_kernel(pk.dev, tables, self.q1_bits,
                                          ct.data, self.q1_naf)
        else:
            found, m = _decrypt_l1_kernel(pk.dev, tables, self.q1_bits,
                                          ct.data, self.q1_naf)
        return (np.atleast_1d(np.asarray(m, dtype=np.int64)),
                np.atleast_1d(np.asarray(found)).astype(bool))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """A batch of BGN ciphertexts (reference Ciphertext, ciphertext.go:12).

    data: AffinePoint (level 1, G1 points) or [2, L, *batch] array
    (level 2, GT elements).  level2 is static, mirroring the L2 bool."""

    data: Any
    level2: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def batch_shape(self):
        if self.level2:
            return self.data.shape[2:]
        return self.data.inf.shape

    def reshape(self, batch_shape) -> "Ciphertext":
        if self.level2:
            d = self.data.reshape(self.data.shape[:2] + tuple(batch_shape))
            return Ciphertext(d, True)
        pt = cv.AffinePoint(
            self.data.x.reshape((self.data.x.shape[0],) + tuple(batch_shape)),
            self.data.y.reshape((self.data.y.shape[0],) + tuple(batch_shape)),
            self.data.inf.reshape(tuple(batch_shape)))
        return Ciphertext(pt, False)

    def __getitem__(self, idx) -> "Ciphertext":
        """Slice along the leading batch axis."""
        if self.level2:
            return Ciphertext(self.data[:, :, idx], True)
        return Ciphertext(cv.AffinePoint(self.data.x[:, idx],
                                         self.data.y[:, idx],
                                         self.data.inf[idx]), False)

    def string(self, pk) -> str:
        """Canonical hex of every batch element, one per line (the analog
        of Ciphertext.String, ciphertext.go:60-62; needs pk to leave the
        Montgomery domain, like Bytes needs the pairing context)."""
        from .utils import convert
        flat = self.reshape((int(np.prod(self.batch_shape)) or 1,))
        nb = 2 * pk.dev.ctx.L
        if self.level2:
            vals = convert.fp2_to_host(pk.dev.ctx, flat.data)
            return "\n".join(f"[{re:0{2 * nb}x}, {im:0{2 * nb}x}]"
                             for re, im in vals)
        pts = convert.affine_to_host(pk.dev.ctx, flat.data)
        return "\n".join("O" if P is None
                         else f"[{P[0]:0{2 * nb}x}, {P[1]:0{2 * nb}x}]"
                         for P in pts)


# ---------------------------------------------------------------------------
# Keygen
# ---------------------------------------------------------------------------


def keygen(key_bits: int, msg_space: int, poly_base: int = 3,
           fp_scale_base: int = 3, fp_precision: float = 0.0001,
           deterministic: bool = True, rng=None
           ) -> Tuple[BGNPublicKey, BGNSecretKey]:
    """Generate a BGN key pair (NewKeyGen, bgn.go:65-138).

    Host does the number theory (prime search, cofactor, generator); device
    arrays are uploaded once.  Pass a random.Random for reproducible keys
    (the test-vector / fixed-key path SURVEY.md §4 requires)."""
    gk = hm.golden_keygen(key_bits, msg_space, rng)
    params = gk.params
    L = lb.num_limbs_for_bits(key_bits + _L_MARGIN_BITS)
    if params.p.bit_length() > 16 * L:
        raise ValueError("cofactor l unexpectedly large; retry keygen")
    ctx = mg.make_mont_ctx(params.p, L=L)

    e_pp = gk.gt_base()
    e_qq = hm.tate_pairing(gk.Q, gk.Q, params)
    rns = _make_rns(params.p, L)
    n_naf_digits, n_digits_kind = _exp_digits(
        params.n, key_bits, (params.q1, params.q2, params.n))
    p_win, p_rows = _window_table(ctx, gk.P, params.p, key_bits)
    q_win, q_rows = _window_table(ctx, gk.Q, params.p, key_bits)
    dev = PublicDeviceKey(
        ctx=ctx,
        rns=rns,
        P=convert.point_from_host(ctx, gk.P),
        Q=convert.point_from_host(ctx, gk.Q),
        n_bits=jnp.asarray(lb.int_to_bits(params.n, key_bits)),
        n_naf=n_naf_digits,
        l_bits=jnp.asarray(lb.int_to_bits(params.l, 32)),
        pair_qq=convert.fp2_single_from_host(ctx, e_qq),
        gt_gen=convert.fp2_single_from_host(ctx, e_pp),
        p_win=p_win,
        q_win=q_win,
        p_win_rns=_win_rns(ctx, rns, p_win, p_rows),
        q_win_rns=_win_rns(ctx, rns, q_win, q_rows),
    )
    poly_params = PolyEncodingParams(poly_base, fp_scale_base, fp_precision)
    pk = BGNPublicKey(key_bits=key_bits, n=params.n, l=params.l, p=params.p,
                      msg_space=msg_space, deterministic=deterministic,
                      poly_params=poly_params, P_host=gk.P, Q_host=gk.Q,
                      dev=dev)
    pk.n_digits_kind = n_digits_kind
    sk = BGNSecretKey(params, gk.R, poly_base)
    from . import encoding
    encoding.compute_encoding_table(pk)   # mirrors bgn.go:135
    return pk, sk


def validate_public_key_parts(n: int, l: int, p: int,
                              P_host, Q_host) -> None:
    """Structural A1 invariants for loaded key material (VERDICT r3
    item 6): p = l*n - 1 prime with p == 3 (mod 4), l == 0 (mod 4),
    generators on-curve with coordinates < p and annihilated by n.
    The reference's SetBytes path (bgn.go:501-560) cannot check any of
    this; a corrupted/hostile key file here raises instead of silently
    decrypting garbage.  (Membership of Q in the order-q1 subgroup needs
    the secret factorization -- interop.conformance covers it.)"""
    if p != l * n - 1:
        raise ValueError("invalid key: p != l*n - 1")
    if p % 4 != 3:
        raise ValueError("invalid key: p != 3 (mod 4)")
    if l % 4 != 0 or l <= 0:
        raise ValueError("invalid key: cofactor l not a positive "
                         "multiple of 4")
    if not hm.is_probable_prime(p):
        raise ValueError("invalid key: p is not prime")
    for name, pt in (("P", P_host), ("Q", Q_host)):
        if pt is None:
            raise ValueError(f"invalid key: generator {name} is the "
                             "identity")
        x, y = pt
        if not (0 <= x < p and 0 <= y < p):
            raise ValueError(f"invalid key: {name} coordinate >= p")
        if not hm.on_curve((x, y), p):
            raise ValueError(f"invalid key: {name} not on the curve")
        if hm.ec_mul(n, (x, y), p) is not None:
            raise ValueError(f"invalid key: {name} order does not "
                             "divide n")


def public_key_from_parts(key_bits: int, n: int, l: int, p: int,
                          msg_space: int, deterministic: bool,
                          poly_params: PolyEncodingParams,
                          P_host: Tuple[int, int],
                          Q_host: Tuple[int, int],
                          n_digits: str | None = None,
                          validate: bool = True) -> BGNPublicKey:
    """Rebuild a full public key (device context included) from its host
    parts -- the shared path for deserialization (serialize.py) and
    reference import (interop/reference.py).  Mirrors the pairing
    re-binding the reference does in UnmarshalBinary (bgn.go:626-666),
    plus load-time invariant checks the reference lacks (validate=False
    to skip, e.g. for material already validated this process)."""
    from . import encoding
    if validate:
        validate_public_key_parts(n, l, p, P_host, Q_host)
    L = lb.num_limbs_for_bits(max(key_bits + _L_MARGIN_BITS,
                                  p.bit_length()))
    ctx = mg.make_mont_ctx(p, L=L)
    params = hm.A1Params(q1=0, q2=0, n=n, l=l, p=p)  # public view: no factors
    e_pp = hm.tate_pairing(P_host, P_host, params)
    e_qq = hm.tate_pairing(Q_host, Q_host, params)
    rns = _make_rns(p, L)
    n_naf_digits, n_digits_kind = _exp_digits(n, key_bits, (n,),
                                              force=n_digits)
    p_win, p_rows = _window_table(ctx, P_host, p, key_bits)
    q_win, q_rows = _window_table(ctx, Q_host, p, key_bits)
    dev = PublicDeviceKey(
        ctx=ctx,
        rns=rns,
        P=convert.point_from_host(ctx, P_host),
        Q=convert.point_from_host(ctx, Q_host),
        # n_digits replays the encoding keygen chose; without it (legacy
        # files, reference imports) the chain check runs mod n only (the
        # subgroup-order events it cannot see are ~2^-240 per key; keygen
        # checked them when this key was made)
        n_bits=jnp.asarray(lb.int_to_bits(n, key_bits)),
        n_naf=n_naf_digits,
        l_bits=jnp.asarray(lb.int_to_bits(l, 32)),
        pair_qq=convert.fp2_single_from_host(ctx, e_qq),
        gt_gen=convert.fp2_single_from_host(ctx, e_pp),
        p_win=p_win,
        q_win=q_win,
        p_win_rns=_win_rns(ctx, rns, p_win, p_rows),
        q_win_rns=_win_rns(ctx, rns, q_win, q_rows),
    )
    pk = BGNPublicKey(key_bits=key_bits, n=n, l=l, p=p, msg_space=msg_space,
                      deterministic=deterministic, poly_params=poly_params,
                      P_host=tuple(P_host), Q_host=tuple(Q_host), dev=dev)
    pk.n_digits_kind = n_digits_kind
    encoding.compute_encoding_table(pk)
    return pk


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------


def _make_rns(p: int, L: int):
    """RNS context for the RNS field path; None when p exceeds the
    12-bit-channel prime pool (~2260-bit p; such keys run on limbs)."""
    from .fieldcore import rns as rn
    try:
        return rn.make_rns_ctx(p, L=L)
    except ValueError:
        return None


_WINDOW_BITS = 8
_WINDOW_RADIX = 1 << _WINDOW_BITS


def _win_rns(ctx, rns, table, rows=None):
    """RNS-Montgomery residues ([2k, J, R] x, y) of a window table, or
    None without an RNS context.

    Host path (when the `rows` of host points that built the table are
    available): residues of v*A mod p computed with exact host ints +
    one numpy digit matmul -- zero device compiles at key build.  The
    host result has exact bound 1 (vs bound 3 from the device
    to_rns_mont route), strictly inside every static bound the ladder
    assumes.  Device fallback (deserialization of a bare limb table)
    jits rns_pairing.make_rns_window_table."""
    if rns is None:
        return None
    if rows is None:
        from .ops import rns_pairing
        return jax.jit(rns_pairing.make_rns_window_table)(ctx, rns, table)
    # All constants recomputed host-side from p (channel selection is
    # deterministic), so no rns.m / rns.pow2_8 / ctx.p device readback.
    # p_host == 0 means a MontCtx built outside make_mont_ctx (e.g. an
    # old pickle): fall back to the limb readback rather than silently
    # building zero-channel residues (select_channels rejects p <= 1).
    p = ctx.p_host or lb.limbs_to_int(np.asarray(ctx.p))
    from .fieldcore import rns as rn
    A_list, B_list, _ = rn.select_channels(p)
    m = np.array(A_list + B_list, dtype=np.int64)           # [2k]
    A = 1
    for v in A_list:
        A *= v
    d8 = 2 * ctx.L
    pow2 = np.array([[pow(256, d, int(mc)) for d in range(d8)]
                     for mc in m], dtype=np.int64)          # [2k, D8]
    J, R = table.inf.shape

    def residues(vals):
        buf = bytearray(d8 * len(vals))
        for b, v in enumerate(vals):
            buf[b * d8:(b + 1) * d8] = (v * A % p).to_bytes(d8, "little")
        digits = np.frombuffer(bytes(buf), dtype=np.uint8)
        digits = digits.reshape(len(vals), d8).T.astype(np.int64)
        S = pow2 @ digits                                   # [2k, B]
        r = (S % m[:, None]).astype(np.float32)
        return r.reshape(-1, J, R)

    xs = [0 if P is None else P[0] for P in rows]
    ys = [0 if P is None else P[1] for P in rows]
    rx, ry = residues(xs), residues(ys)
    return jnp.asarray(rx), jnp.asarray(ry)


def _window_table(ctx, base, p: int, key_bits: int):
    """Host-side radix-2^w fixed-base table: entry (j, d) = base^(d*R^j),
    R = _WINDOW_RADIX.  Returns (AffinePoint [L, J, R], host rows).

    The reference has no analog (PBC recomputes scalar mults each call);
    this is the batched answer to encryption's Q^r ladder being as
    expensive as a pairing (docs/PERF.md).  Radix 256 halves the ladder's
    mixed additions vs radix 16 at the cost of a larger (still small)
    table; the host build is ~J*R ec_adds (~0.5s at 512-bit keys with the
    gcd-based inverse in hm.ec_add)."""
    R = _WINDOW_RADIX
    J = -(-key_bits // _WINDOW_BITS)
    rows = []
    gen = base
    for _ in range(J):
        acc = None
        row = [None]
        for _ in range(R - 1):
            acc = hm.ec_add(acc, gen, p)
            row.append(acc)
        rows.extend(row)
        for _ in range(_WINDOW_BITS):
            gen = hm.ec_dbl(gen, p)
    tab = convert.affine_from_host(ctx, rows, batch_shape=(J, R))
    return tab, rows


def _signed_digits(values, n: int):
    """Host ints -> (radix-2^w digits [J, B] uint32 of |v| mod n,
    neg mask [B]).  J is bucketed like _bits_width for jit-cache reuse."""
    values = [int(v) for v in np.atleast_1d(np.asarray(values, dtype=object))]
    neg = np.asarray([1 if v < 0 else 0 for v in values], dtype=np.uint32)
    mags = [abs(v) % n for v in values]
    nbits = min(_bits_width(mags), n.bit_length())
    J = -(-nbits // _WINDOW_BITS)
    if _WINDOW_BITS == 8:
        # vectorized: one byte per digit (the J*B python loop costs more
        # than the device ladder at batch 2048)
        buf = b"".join(v.to_bytes(J, "little") for v in mags)
        digits = np.frombuffer(buf, dtype=np.uint8) \
            .reshape(len(mags), J).T.astype(np.uint32)
    else:
        mask = _WINDOW_RADIX - 1
        digits = np.zeros((J, len(mags)), dtype=np.uint32)
        for b, v in enumerate(mags):
            for j in range(J):
                digits[j, b] = (v >> (_WINDOW_BITS * j)) & mask
    return jnp.asarray(digits), neg


def _rand_below(n: int, rng=None) -> int:
    """Uniform random int < n (newCryptoRandom, bgn.go:567-574)."""
    if rng is None:
        return secrets.randbelow(n)
    return rng.randrange(n)


def _flat(shape) -> int:
    return int(np.prod(shape, dtype=int)) if shape else 1


def _to_list(values):
    return [int(v) for v in np.atleast_1d(np.asarray(values, dtype=object))]


def _bucket(b: int) -> int:
    """Next power of two >= b (min 8), to bound distinct compile shapes."""
    n = 8
    while n < b:
        n *= 2
    return n


def _bits_width(values) -> int:
    """Pick a compile-friendly bit width: power-of-two-ish buckets."""
    m = max((int(abs(v)).bit_length() for v in values), default=1)
    m = max(m, 1)
    w = 16
    while w < m:
        w *= 2
    return w


def _chain_degenerate(digits, mods) -> bool:
    """True if the MSB-first signed-digit double-and-add chain hits a
    degenerate mixed addition for a base point whose order divides one of
    `mods`: V == addend anywhere (the incomplete add would return the
    identity instead of 2V), or V == -addend before the final step (the
    identity result then feeds later incomplete steps).  The final-step
    vertical is allowed: the decrypt ladder lands on Z == 0 == identity
    correctly and the Miller loop elides it (denominator elimination).
    See ops/rns_pairing.py:_add_pt."""
    started = False
    c = 0
    nz = [i for i, d in enumerate(digits) if d]
    last = nz[-1] if nz else -1
    for i, d in enumerate(digits):
        d = int(d)
        if not started:
            if d:
                started = True
                c = d
            continue
        c *= 2
        if d:
            for ordc in mods:
                if ordc <= 1:
                    continue
                if (c - d) % ordc == 0:
                    return True
                if (c + d) % ordc == 0 and i != last:
                    return True
            c += d
    return False


def _exp_digits(e: int, width: int, mods, force=None):
    """Signed MSB-first ladder digits for exponent e: NAF (ops do ~1/3
    the additions of plain bits) when the chain is safe for every point
    order in `mods`, else plain bits.  Leading zeros stripped so
    digits[0] == 1 (the ladder-init contract of scalar_mul_rns /
    _miller_f_rns).  Returns (digits, kind) with kind in {"naf","bits"}.

    force="naf"/"bits" replays a choice recorded at keygen (serialized
    with the key parts) instead of re-deciding it: the public view has
    no q1/q2, and a recomputed check mod n alone could pick NAF for a
    key whose keygen fell back to bits, giving the two views of the
    same key different Miller chains (ADVICE r2)."""
    if force is not None:
        if force not in ("naf", "bits"):
            raise ValueError(f"unknown digit encoding {force!r}")
        digits = (lb.int_to_naf(e, width) if force == "naf"
                  else lb.int_to_bits(e, width).astype(np.int32))
        kind = force
    else:
        naf = lb.int_to_naf(e, width)
        if not _chain_degenerate(naf, mods):
            digits, kind = naf, "naf"
        else:  # pragma: no cover -- probability ~2^-240 per key
            digits = lb.int_to_bits(e, width).astype(np.int32)
            kind = "bits"
            if _chain_degenerate(digits, mods):
                raise ValueError("degenerate addition chain; regenerate key")
    nz = np.nonzero(digits)[0]
    return jnp.asarray(digits[nz[0]:] if nz.size else digits[-1:]), kind


def _signed_bits(values, n: int):
    """Host ints -> (bits [nbits, B] MSB-first of |v| mod n, neg mask [B])."""
    values = [int(v) for v in np.atleast_1d(np.asarray(values, dtype=object))]
    neg = np.asarray([1 if v < 0 else 0 for v in values], dtype=np.uint32)
    mags = [abs(v) % n for v in values]
    nbits = min(_bits_width(mags), n.bit_length())
    nbytes = -(-nbits // 8)
    buf = b"".join(v.to_bytes(nbytes, "big") for v in mags)
    arr = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8).reshape(len(mags), nbytes),
        axis=1)
    bits = arr[:, 8 * nbytes - nbits:].T.astype(np.uint32)
    return jnp.asarray(bits), neg


def _const_list(ks, batch_shape):
    arr = np.asarray(ks, dtype=object).reshape(-1)
    B = _flat(batch_shape)
    if arr.size == 1:
        arr = np.repeat(arr, B)
    if arr.size != B:
        raise ValueError("constant batch mismatch")
    return list(arr)


# ---------------------------------------------------------------------------
# Jitted kernels (module-level so the jit cache is shared across keys)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2, 3))
def _device_r_digits(sampler_ctx, key, batch: int, J: int):
    """Device-sampled exponents as radix-2^w window digits [J, batch]."""
    from .utils import rng as rng_mod
    r = rng_mod.device_random_below(sampler_ctx, key, (batch,))  # [L', B]
    per = 16 // _WINDOW_BITS            # digits per 16-bit limb
    nl = -(-J // per)
    limbs = r[:nl]
    mask = jnp.uint32(_WINDOW_RADIX - 1)
    parts = [(limbs >> (_WINDOW_BITS * i)) & mask for i in range(per)]
    digits = jnp.stack(parts, axis=1).reshape(per * nl, batch)
    return digits[:J]


@jax.jit
def _encrypt_kernel(dev: PublicDeviceKey, m_digits, m_neg, r_digits):
    ctx = dev.ctx
    if dev.p_win_rns is not None and pairing_mod.use_rns(dev.rns):
        # RNS end-to-end: both window ladders, the g +- h combine and the
        # batch-inversion exit; limbs only for the two affine outputs
        from .ops import rns_pairing as rp
        X, Y, Z = rp.fixed_base_mul_rns(ctx, dev.rns, dev.p_win_rns,
                                        dev.p_win.inf, m_digits)
        g = (X.v, rp.neg_y_rns(dev.rns, Y.v, Y.bound, m_neg), Z.v)
        h = rp.fixed_base_mul_rns(ctx, dev.rns, dev.q_win_rns,
                                  dev.q_win.inf, r_digits)
        X, Y, Z = rp.add_jac_rns(dev.rns, g, tuple(v.v for v in h))
        return rp.normalize_rns(ctx, dev.rns, X, Y, Z)
    g = cv.fixed_base_mul(ctx, dev.p_win, m_digits)           # P^|m|
    g = cv.JacPoint(g.X, lb.select(m_neg, mg.mod_neg(ctx, g.Y), g.Y), g.Z)
    h = cv.fixed_base_mul(ctx, dev.q_win, r_digits)           # Q^r
    h_aff = cv.normalize(ctx, h, rns=dev.rns)
    c = cv.madd(ctx, g, h_aff)
    return cv.normalize(ctx, c, rns=dev.rns)


@jax.jit
def _encrypt_det_kernel(dev: PublicDeviceKey, m_digits, m_neg):
    ctx = dev.ctx
    if dev.p_win_rns is not None and pairing_mod.use_rns(dev.rns):
        # RNS end-to-end: ladder (raw residues) -> negate -> normalize
        from .ops import rns_pairing
        X, Y, Z = rns_pairing.fixed_base_mul_rns(
            ctx, dev.rns, dev.p_win_rns, dev.p_win.inf, m_digits)
        Yn = rns_pairing.neg_y_rns(dev.rns, Y.v, Y.bound, m_neg)
        return rns_pairing.normalize_rns(ctx, dev.rns, X.v, Yn, Z.v)
    g = cv.fixed_base_mul(ctx, dev.p_win, m_digits)
    g = cv.JacPoint(g.X, lb.select(m_neg, mg.mod_neg(ctx, g.Y), g.Y), g.Z)
    return cv.normalize(ctx, g, rns=dev.rns)


@jax.jit
def _add_l1_kernel(dev, a: cv.AffinePoint, b: cv.AffinePoint):
    # RNS fast path: the group law as matmul work with complete
    # selects, instead of the ~11 sequential O(L^2) CIOS muls of the limb
    # madd
    if pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing
        return rns_pairing.add_complete_rns(dev.ctx, dev.rns, a, b)
    return cv.normalize(dev.ctx, cv.add_affine(dev.ctx, a, b), rns=dev.rns)


@jax.jit
def _sub_l1_kernel(dev, a: cv.AffinePoint, b: cv.AffinePoint):
    nb = cv.neg_affine(dev.ctx, b)
    if pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing
        return rns_pairing.add_complete_rns(dev.ctx, dev.rns, a, nb)
    return cv.normalize(dev.ctx, cv.add_affine(dev.ctx, a, nb), rns=dev.rns)


@jax.jit
def _add_l2_kernel(dev, a, b):
    return fp2.mul(dev.ctx, a, b)


@jax.jit
def _sub_l2_kernel(dev, a, b):
    # GT division; GT is unitary so b^-1 = conj(b)
    return fp2.mul(dev.ctx, a, fp2.conj(dev.ctx, b))


@jax.jit
def _mult_kernel(dev, a: cv.AffinePoint, b: cv.AffinePoint):
    return pairing_mod.pairing(dev.ctx, a, b, dev.n_bits, dev.l_bits,
                               rns=dev.rns, n_naf=dev.n_naf)


@jax.jit
def _make_l2_kernel(dev, a: cv.AffinePoint):
    return pairing_mod.pairing(dev.ctx, a, dev.P, dev.n_bits, dev.l_bits,
                               rns=dev.rns, n_naf=dev.n_naf)


@jax.jit
def _mult_const_l1_kernel(dev, a: cv.AffinePoint, k_bits, k_neg):
    ctx = dev.ctx
    r = cv.scalar_mul(ctx, a, k_bits)
    r = cv.JacPoint(r.X, lb.select(k_neg, mg.mod_neg(ctx, r.Y), r.Y), r.Z)
    return cv.normalize(ctx, r, rns=dev.rns)


@jax.jit
def _mult_const_l2_kernel(dev, a, k_bits, k_neg):
    ctx = dev.ctx
    r = fp2.pow_bits(ctx, a, k_bits)
    return fp2.select(k_neg, fp2.conj(ctx, r), r)


@jax.jit
def _mult_const_l1_rns_kernel(dev, a: cv.AffinePoint, k_bits, k_neg):
    """MultConst fast path: per-element RNS double-and-add (VERDICT r3
    item 3); bit-identical to _mult_const_l1_kernel on its safe domain.
    The ladder, negation, and batch-inversion exit all stay in RNS."""
    from .ops import rns_pairing
    ctx = dev.ctx
    X, Y, Z = rns_pairing.scalar_mul_vec_rns(ctx, dev.rns, a, k_bits,
                                             raw=True)
    Yn = rns_pairing.neg_y_rns(dev.rns, Y.v, Y.bound,
                               k_neg.reshape(-1))
    aff = rns_pairing.normalize_rns(ctx, dev.rns, X.v, Yn, Z.v)
    shape = a.x.shape
    return cv.AffinePoint(aff.x.reshape(shape), aff.y.reshape(shape),
                          aff.inf.reshape(a.inf.shape))


@jax.jit
def _mult_const_l2_rns_kernel(dev, a, k_bits, k_neg):
    from .ops import rns_pairing
    ctx = dev.ctx
    r = rns_pairing.fp2_pow_vec_rns(ctx, dev.rns, a, k_bits)
    return fp2.select(k_neg, fp2.conj(ctx, r), r)


@jax.jit
def _rerand_l1_kernel(dev, pt: cv.AffinePoint, r_digits):
    ctx = dev.ctx
    if dev.q_win_rns is not None and pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing as rp
        h = rp.fixed_base_mul_rns(
            ctx, dev.rns, dev.q_win_rns, dev.q_win.inf,
            r_digits.reshape(r_digits.shape[0], -1))
        X, Y, Z = rp.add_jac_rns(dev.rns, rp.affine_to_rns(ctx, dev.rns, pt),
                                 tuple(v.v for v in h))
        aff = rp.normalize_rns(ctx, dev.rns, X, Y, Z)
        return cv.AffinePoint(aff.x.reshape(pt.x.shape),
                              aff.y.reshape(pt.y.shape),
                              aff.inf.reshape(pt.inf.shape))
    h = cv.normalize(ctx, cv.fixed_base_mul(ctx, dev.q_win, r_digits),
                     rns=dev.rns)
    return cv.normalize(ctx, cv.add_affine(ctx, pt, h), rns=dev.rns)


@jax.jit
def _rerand_l2_kernel(dev, z, r_bits):
    ctx = dev.ctx
    if pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing as rp
        qq = dev.pair_qq.reshape(dev.pair_qq.shape + (1,) * (z.ndim - 2))
        mask = rp.fp2_pow_vec_rns(ctx, dev.rns, jnp.broadcast_to(qq, z.shape),
                                  r_bits)
    else:
        mask = fp2.pow_bits(ctx, dev.pair_qq, r_bits)
    return fp2.mul(ctx, z, mask)


@jax.jit
def _decrypt_l1_kernel(dev, tables, q1_bits, pt: cv.AffinePoint,
                       q1_naf=None):
    ctx = dev.ctx
    if pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing
        digits = q1_bits if q1_naf is None else q1_naf
        # ladder AND giant-step scan stay in the RNS domain; only the
        # final affine candidates convert to limbs for the digest lookup
        Xr, Yr, Zr = rns_pairing.scalar_mul_rns(ctx, dev.rns, pt, digits,
                                                raw=True)
        batch_shape = pt.inf.shape
        found, m = bsgs_mod.bsgs_g1_rns(ctx, dev.rns, tables, Xr, Yr, Zr,
                                        pt.inf.reshape(-1))
        return found.reshape(batch_shape), m.reshape(batch_shape)
    csk = cv.scalar_mul(ctx, pt, q1_bits)            # C^q1 (bgn.go:223)
    return bsgs_mod.bsgs_g1(ctx, tables, csk)


@jax.jit
def _decrypt_l2_kernel(dev, tables, q1_bits, z, q1_naf=None):
    ctx = dev.ctx
    if pairing_mod.use_rns(dev.rns):
        from .ops import rns_pairing
        # L2 ciphertexts are reduced pairing values: unitary (norm 1), so
        # the signed-digit chain may take inverses by conjugation
        digits = q1_bits if q1_naf is None else q1_naf
        zr, zi = rns_pairing.fp2_pow_rns(ctx, dev.rns, z, digits,
                                         unitary=True, raw=True)
        batch_shape = z.shape[2:]
        found, m = bsgs_mod.bsgs_gt_rns(ctx, dev.rns, tables, zr, zi)
        return found.reshape(batch_shape), m.reshape(batch_shape)
    csk = fp2.pow_bits(ctx, z, q1_bits)              # c^q1
    return bsgs_mod.bsgs_gt(ctx, tables, csk)
