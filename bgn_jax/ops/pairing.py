"""Batched Tate pairing on the A1 curve: the EMult hot kernel.

e(A, B) = f_{n,A}(phi(B))^((p^2-1)/n) with distortion map
phi(x, y) = (-x, i*y); this is the batched replacement for PBC's
`element_pairing` (reference Element.Pair at bgn.go:300 -- THE hot op of
the scheme, one per homomorphic ciphertext multiplication).

Design notes (see also bgn_jax/hostmath.py tate_* for the host oracle):
  - The Miller loop is a fixed-length `lax.scan` over the bits of n
    (MSB-first with a `started` flag, so one compiled kernel serves any
    exponent bit-length <= nbits).  Every step fuses the Jacobian doubling
    with its tangent-line evaluation; the conditional addition step runs
    under `lax.cond` (the exponent is shared across the batch, so the
    branch is uniform and XLA executes only the taken side).
  - Denominator elimination: vertical lines evaluate into F_p and die in
    the final exponentiation, so they are skipped.  The final addition step
    of the loop (V = -A) is exactly such a vertical line and is elided: the
    scan runs over bits[:-1] and a tail step handles the last doubling.
  - Final exponentiation: (p^2-1)/n = (p-1)*l and z^(p-1) = conj(z)/z in
    F_p^2, so it costs one batched inversion plus a small power l.
  - Identity inputs (E_det(0) = O, used by makeL2 / encryptZero,
    reference bgn.go:316-321, 562-564) are fixed up with a final select:
    e(O, X) = e(X, O) = 1.

Line-function derivation (all scale factors in F_p^*, killed by the final
exponentiation): with V = (X, Y, Z) Jacobian, M = 3X^2 + Z^4,
Z3 = 2YZ, the tangent at V evaluated at phi(B) = (-xb, i*yb) scaled by
Z3*Z^3 is  re = M*(Z^3*xb + X*Z) - Z3*Y,  im = Z3*Z^3*yb.
For the mixed addition with affine A, R = S2 - Y1, Z3 = Z1*H, the line
through V and A scaled by Z3 is  re = R*(xb + xa) - Z3*ya,
im = Z3*yb.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..fieldcore import limbs as lb
from ..fieldcore import montgomery as mg
from ..fieldcore.montgomery import MontCtx
from . import fp2
from .curve import AffinePoint, JacPoint, to_jac

# RNS field path (ops/rns_pairing.py): modmuls become bf16 matmuls.
# BGN_RNS_MILLER="1" forces it on every backend (tests, CPU dry runs),
# "0" forces the limb path; unset ("auto") -> use_rns below decides.
_RNS_MODE = os.environ.get("BGN_RNS_MILLER", "auto")


def _dbl_with_line(ctx: MontCtx, v: JacPoint, xb, yb):
    """Jacobian doubling fused with tangent-line evaluation at phi(B)."""
    X, Y, Z = v
    XX = mg.mont_mul(ctx, X, X)
    ZZ = mg.mont_mul(ctx, Z, Z)
    ZZZ = mg.mont_mul(ctx, Z, ZZ)
    ZZZZ = mg.mont_mul(ctx, ZZ, ZZ)
    YY = mg.mont_mul(ctx, Y, Y)
    YYYY = mg.mont_mul(ctx, YY, YY)
    M = mg.mod_add(ctx, mg.mod_add(ctx, XX, mg.mod_add(ctx, XX, XX)), ZZZZ)
    T = mg.mont_mul(ctx, X, YY)
    S = mg.mod_add(ctx, T, T)
    S = mg.mod_add(ctx, S, S)                       # 4 X Y^2
    MM = mg.mont_mul(ctx, M, M)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, MM, S), S)
    Y8 = mg.mod_add(ctx, YYYY, YYYY)
    Y8 = mg.mod_add(ctx, Y8, Y8)
    Y8 = mg.mod_add(ctx, Y8, Y8)
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, M, mg.mod_sub(ctx, S, X3)), Y8)
    YZ = mg.mont_mul(ctx, Y, Z)
    Z3 = mg.mod_add(ctx, YZ, YZ)
    # line: re = M*(ZZZ*xb + X*Z) - Z3*Y ; im = Z3*ZZZ*yb
    t1 = mg.mont_mul(ctx, ZZZ, xb)
    t2 = mg.mont_mul(ctx, X, Z)
    l_re = mg.mod_sub(ctx, mg.mont_mul(ctx, M, mg.mod_add(ctx, t1, t2)),
                      mg.mont_mul(ctx, Z3, Y))
    l_im = mg.mont_mul(ctx, mg.mont_mul(ctx, Z3, ZZZ), yb)
    return JacPoint(X3, Y3, Z3), fp2.make(l_re, l_im)


def _madd_with_line(ctx: MontCtx, v: JacPoint, a: AffinePoint, xb, yb):
    """Mixed addition v + a fused with the line through v and a at phi(B).

    No completeness selects: inside the Miller loop for exponent n the only
    degenerate addition is the final one, which is elided by construction
    (see module docstring)."""
    X1, Y1, Z1 = v
    ZZ = mg.mont_mul(ctx, Z1, Z1)
    U2 = mg.mont_mul(ctx, a.x, ZZ)
    ZZZ = mg.mont_mul(ctx, Z1, ZZ)
    S2 = mg.mont_mul(ctx, a.y, ZZZ)
    H = mg.mod_sub(ctx, U2, X1)
    R = mg.mod_sub(ctx, S2, Y1)
    HH = mg.mont_mul(ctx, H, H)
    HHH = mg.mont_mul(ctx, H, HH)
    V = mg.mont_mul(ctx, X1, HH)
    RR = mg.mont_mul(ctx, R, R)
    X3 = mg.mod_sub(ctx, mg.mod_sub(ctx, mg.mod_sub(ctx, RR, HHH), V), V)
    Y3 = mg.mod_sub(ctx, mg.mont_mul(ctx, R, mg.mod_sub(ctx, V, X3)),
                    mg.mont_mul(ctx, Y1, HHH))
    Z3 = mg.mont_mul(ctx, Z1, H)
    l_re = mg.mod_sub(ctx, mg.mont_mul(ctx, R, mg.mod_add(ctx, xb, a.x)),
                      mg.mont_mul(ctx, Z3, a.y))
    l_im = mg.mont_mul(ctx, Z3, yb)
    return JacPoint(X3, Y3, Z3), fp2.make(l_re, l_im)


def miller_loop(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_bits):
    """f_{n,A}(phi(B)) for the whole batch; n_bits [nbits] MSB-first,
    shared across the batch (it is the group order)."""
    batch_shape = jnp.broadcast_shapes(a.x.shape[1:], b.x.shape[1:])
    L = ctx.L

    def bc_pt(p: AffinePoint) -> AffinePoint:
        return AffinePoint(
            lb.expand_to(p.x, (L,) + batch_shape),
            lb.expand_to(p.y, (L,) + batch_shape),
            jnp.broadcast_to(
                p.inf.reshape(p.inf.shape + (1,) * (len(batch_shape)
                                                    - p.inf.ndim)),
                batch_shape))

    a = bc_pt(a)
    b = bc_pt(b)
    xb, yb = b.x, b.y
    f0 = fp2.one(ctx, batch_shape)
    v0 = to_jac(ctx, a)  # placeholder; real init happens at the MSB

    def dbl_step(v, f):
        v2, line = _dbl_with_line(ctx, v, xb, yb)
        return v2, fp2.mul(ctx, fp2.sqr(ctx, f), line)

    def add_step(v, f):
        v2, line = _madd_with_line(ctx, v, a, xb, yb)
        return v2, fp2.mul(ctx, f, line)

    def step(carry, bit):
        v, f, started = carry
        bit_b = bit.astype(bool)

        def not_started(_):
            # at the MSB: V = A, f = 1; before it: no-op
            return (v, f, jnp.where(bit_b, jnp.uint32(1), jnp.uint32(0)))

        def normal(_):
            v1, f1 = dbl_step(v, f)
            v2, f2 = jax.lax.cond(
                bit_b, lambda vf: add_step(*vf), lambda vf: vf, (v1, f1))
            return (v2, f2, started)

        carry2 = jax.lax.cond(started.astype(bool), normal, not_started, None)
        return carry2, None

    started0 = jnp.uint32(0)
    (v, f, started), _ = jax.lax.scan(step, (v0, f0, started0), n_bits[:-1])

    # tail: last doubling; the final addition (V = -A, vertical) is elided.
    def tail_started(_):
        _, f1 = dbl_step(v, f)
        return f1

    f = jax.lax.cond(started.astype(bool), tail_started, lambda _: f, None)
    return f


def final_exponentiation(ctx: MontCtx, f, l_bits):
    """f^((p^2-1)/n) = (conj(f)/f)^l; l_bits [lbits] MSB-first shared."""
    w = fp2.mul(ctx, fp2.conj(ctx, f), fp2.inv(ctx, f))
    return fp2.pow_bits(ctx, w, l_bits)


def use_rns(rns) -> bool:
    """Whether the RNS field path handles this key: the one field-path
    decision every kernel takes at trace time.

    No RNS context (p beyond the ~2260-bit prime pool) -> limbs.  Else
    BGN_RNS_MILLER=1/0 forces RNS/limbs; otherwise RNS on the GPU and
    limbs on the CPU (mg.platform raises on any other backend)."""
    if rns is None:
        return False
    if _RNS_MODE in ("0", "1"):
        return _RNS_MODE == "1"
    return mg.platform() == "gpu"


def pairing(ctx: MontCtx, a: AffinePoint, b: AffinePoint, n_bits, l_bits,
            rns=None, n_naf=None):
    """Full batched symmetric pairing e(A, B) -> GT [2, L, *batch].

    Identity inputs yield 1 (e(O, X) = 1), matching pbc semantics for
    makeL2 on encryptZero (reference bgn.go:316-321).  n_naf: optional
    signed Miller digits for the RNS path (fewer add-steps; the reduced
    pairing value is chain-independent, so results are identical)."""
    if use_rns(rns):
        from . import rns_pairing
        digits = n_bits if n_naf is None else n_naf
        z = rns_pairing.pairing_rns(ctx, rns, a, b, digits, l_bits)
    else:
        f = miller_loop(ctx, a, b, n_bits)
        z = final_exponentiation(ctx, f, l_bits)
    trivial = (a.inf | b.inf).astype(jnp.uint32)
    batch_shape = z.shape[2:]
    return fp2.select(trivial, fp2.one(ctx, batch_shape), z)
