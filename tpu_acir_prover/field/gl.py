"""Goldilocks field arithmetic on 32-bit word pairs, backend-generic.

The Goldilocks prime is p = 2^64 - 2^32 + 1.  Every field element is passed
between ops as a pair of uint32 arrays ``(lo, hi)`` with value
``hi * 2^32 + lo`` kept canonical (< p).  Inside an op, the JAX backend
computes in native uint64 (``uses_u64``); on numpy, and where
``force_u32`` asks for an independent reference, each 32x32 product is
built from 16-bit limbs.  Both paths return bit-identical values.

All functions are written against a numpy-compatible namespace ``xp``
(``numpy`` for the host path, ``jax.numpy`` for the XLA path) so the exact
same algorithms run on the host for witness generation / testing and on
the device inside jitted code.

Reference behavior being matched (not copied): the Rust backend computes
over plonky2's GoldilocksField (see /root/reference/plonky2-backend/src/
lib.rs:11-14 for the field choice).  The reduction algorithm below is the
standard Goldilocks reduction exploiting 2^64 = 2^32 - 1 (mod p) and
2^96 = -1 (mod p).
"""

from __future__ import annotations

import numpy as _np

P = (1 << 64) - (1 << 32) + 1  # Goldilocks prime
EPSILON = (1 << 32) - 1  # 2^64 mod p
P_LO = _np.uint32(P & 0xFFFFFFFF)  # = 1
P_HI = _np.uint32(P >> 32)  # = 0xFFFFFFFF

# Multiplicative group: |F*| = p - 1 = 2^32 * 3 * 5 * 17 * 257 * 65537.
TWO_ADICITY = 32
# 7 generates F* (verified in tests against the factorization above).
MULTIPLICATIVE_GENERATOR = 7
# 7^((p-1)/2^32): a primitive 2^32-nd root of unity (computed in tests).
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)


def uses_u64(xp) -> bool:
    """Does make_gl(xp) compute in native uint64?  On jax whenever x64 is
    enabled, which utils/jaxcfg.setup_jax always does.  Chosen by
    measurement on an H100 80GB HBM3 at 700 W (PERF.md,
    scripts/field_paths.py): the 2^20 x 6 NTT ran in 4.18 ms vs 6.03 ms on
    16-bit limbs and the 2^20 x 17 Merkle sweep in 67.7 ms vs 111.9 ms, at
    a quarter of the compile time; on the CPU the op count per multiply
    drops ~5x.  Values are bit-identical to the limb path (the (lo, hi)
    uint32 interface is preserved at every op boundary)."""
    if "jax" not in getattr(xp, "__name__", ""):
        return False
    import jax
    return bool(jax.config.jax_enable_x64)


def make_gl(xp, force_u32: bool = False):
    """Build the Goldilocks op namespace over backend ``xp`` (numpy or jnp).

    Every function takes/returns uint32 arrays; field elements are (lo, hi)
    tuples of equal-shape arrays.  force_u32 pins the 16-bit-limb
    implementation even where the u64 path is active (an independent
    implementation to check the u64 one against).
    """
    if not force_u32 and uses_u64(xp):
        return _make_gl_u64(xp)
    u32 = xp.uint32

    def const(v, shape=()):
        v = int(v) % P
        lo = xp.full(shape, v & 0xFFFFFFFF, dtype=u32)
        hi = xp.full(shape, v >> 32, dtype=u32)
        return lo, hi

    def _ge_p(lo, hi):
        # value >= p  <=>  hi == 0xFFFFFFFF and lo >= 1  (since p = (2^32-1)<<32 | 1)
        return (hi == u32(0xFFFFFFFF)) & (lo >= u32(1))

    def _sub_p(lo, hi):
        # subtract p assuming value >= p: lo-1 with borrow, hi - 0xFFFFFFFF - borrow
        borrow = (lo < u32(1)).astype(u32)
        nlo = lo - u32(1)
        nhi = hi - u32(0xFFFFFFFF) - borrow
        return nlo, nhi

    def canon(lo, hi):
        """Conditionally subtract p once (input < 2p assumed)."""
        ge = _ge_p(lo, hi)
        slo, shi = _sub_p(lo, hi)
        return xp.where(ge, slo, lo), xp.where(ge, shi, hi)

    def add(a, b):
        alo, ahi = a
        blo, bhi = b
        slo = alo + blo
        c = (slo < alo).astype(u32)
        t = ahi + c
        c1 = (t < ahi).astype(u32)
        shi2 = t + bhi
        c2 = (shi2 < t).astype(u32)
        # overflowed past 2^64: value ≡ s + EPSILON (mod p)
        ovf = (c1 + c2) > u32(0)
        elo = slo + u32(0xFFFFFFFF)
        ec = (elo < slo).astype(u32)
        ehi = shi2 + ec
        lo = xp.where(ovf, elo, slo)
        hi = xp.where(ovf, ehi, shi2)
        return canon(lo, hi)

    def neg(a):
        alo, ahi = a
        is_zero = (alo == u32(0)) & (ahi == u32(0))
        # p - a
        borrow = (P_LO < alo).astype(u32)
        nlo = P_LO - alo
        nhi = P_HI - ahi - borrow
        return xp.where(is_zero, u32(0), nlo), xp.where(is_zero, u32(0), nhi)

    def sub(a, b):
        return add(a, neg(b))

    def mul_32_32(a, b):
        """u32 * u32 -> (lo, hi) u64 product via 16-bit limbs."""
        a0 = a & u32(0xFFFF)
        a1 = a >> u32(16)
        b0 = b & u32(0xFFFF)
        b1 = b >> u32(16)
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = p01 + p10
        mid_c = (mid < p01).astype(u32)  # carry out of mid (bit 32)
        mid_lo = mid << u32(16)
        mid_hi = (mid >> u32(16)) + (mid_c << u32(16))
        lo = p00 + mid_lo
        c = (lo < p00).astype(u32)
        hi = p11 + mid_hi + c
        return lo, hi

    def _add64(alo, ahi, blo, bhi):
        """64-bit add returning (lo, hi, carry_out)."""
        slo = alo + blo
        c = (slo < alo).astype(u32)
        t = ahi + c
        c1 = (t < ahi).astype(u32)
        shi = t + bhi
        c2 = (shi < t).astype(u32)
        return slo, shi, c1 + c2

    def mul_wide(a, b):
        """Full 64x64 -> 128-bit product as four u32 words (x0..x3)."""
        alo, ahi = a
        blo, bhi = b
        ll_lo, ll_hi = mul_32_32(alo, blo)  # 2^0
        lh_lo, lh_hi = mul_32_32(alo, bhi)  # 2^32
        hl_lo, hl_hi = mul_32_32(ahi, blo)  # 2^32
        hh_lo, hh_hi = mul_32_32(ahi, bhi)  # 2^64
        # x1 accumulation: ll_hi + lh_lo + hl_lo
        x1 = ll_hi + lh_lo
        c1 = (x1 < ll_hi).astype(u32)
        x1b = x1 + hl_lo
        c2 = (x1b < x1).astype(u32)
        carry_x1 = c1 + c2  # 0..2
        # x2 accumulation: lh_hi + hl_hi + hh_lo + carry_x1
        x2 = lh_hi + hl_hi
        c3 = (x2 < lh_hi).astype(u32)
        x2b = x2 + hh_lo
        c4 = (x2b < x2).astype(u32)
        x2c = x2b + carry_x1
        c5 = (x2c < x2b).astype(u32)
        carry_x2 = c3 + c4 + c5
        x3 = hh_hi + carry_x2
        return ll_lo, x1b, x2c, x3

    def reduce128(x0, x1, x2, x3):
        """Reduce a 128-bit value (x3:x2:x1:x0 u32 words) mod p.

        Uses 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p):
          x ≡ (x1:x0) - x3 + x2 * (2^32 - 1)
        """
        # t = (x1:x0) - x3, with borrow handled as -2^64 ≡ -EPSILON
        borrow = (x0 < x3).astype(u32)
        t_lo = x0 - x3
        t_hi = x1 - borrow
        und = (x1 < borrow)  # 64-bit underflow happened
        # if underflow: subtract EPSILON from (t mod 2^64); t >= 2^64-2^32 so no chain issue
        b2 = (t_lo < u32(0xFFFFFFFF)).astype(u32)
        u_lo = t_lo - u32(0xFFFFFFFF)
        u_hi = t_hi - b2
        t_lo = xp.where(und, u_lo, t_lo)
        t_hi = xp.where(und, u_hi, t_hi)
        # t2 = x2 * EPSILON = (x2 << 32) - x2 : compute as u64
        e_lo_, e_hi_ = mul_32_32(x2, u32(0xFFFFFFFF))
        # r = t + t2, carry ≡ +EPSILON
        r_lo, r_hi, cry = _add64(t_lo, t_hi, e_lo_, e_hi_)
        has_c = cry > u32(0)
        a_lo = r_lo + u32(0xFFFFFFFF)
        ac = (a_lo < r_lo).astype(u32)
        a_hi = r_hi + ac
        r_lo = xp.where(has_c, a_lo, r_lo)
        r_hi = xp.where(has_c, a_hi, r_hi)
        return canon(r_lo, r_hi)

    def mul(a, b):
        x0, x1, x2, x3 = mul_wide(a, b)
        return reduce128(x0, x1, x2, x3)

    def sqr(a):
        return mul(a, a)

    def mul_const(a, c):
        return mul(a, const(c, xp.shape(a[0])))

    def pow_const(a, e):
        """a ** e for python-int exponent e (square-and-multiply, static)."""
        e = int(e)
        result = const(1, xp.shape(a[0]))
        base = a
        while e > 0:
            if e & 1:
                result = mul(result, base)
            base = mul(base, base)
            e >>= 1
        return result

    if "jax" in getattr(xp, "__name__", ""):
        from jax import lax as _lax

        _INV_BITS = _np.array([(P - 2) >> k & 1 for k in range(64)],
                              dtype=_np.uint32)

        def inv(a):
            """Inverse via Fermat a^(p-2), as a 64-step scan (compact jaxpr
            vs ~96 unrolled muls — keeps XLA compile times sane)."""

            def body(carry, bit):
                result, base = carry
                cand = mul(result, base)
                sel = (xp.where(bit, cand[0], result[0]),
                       xp.where(bit, cand[1], result[1]))
                return (sel, mul(base, base)), None

            one = const(1, xp.shape(a[0]))
            (result, _base), _ = _lax.scan(
                body, (one, a), xp.asarray(_INV_BITS).astype(bool))
            return result
    else:
        def inv(a):
            """Inverse via Fermat: a^(p-2). a must be nonzero."""
            return pow_const(a, P - 2)

    def to_u64(a):
        """(lo, hi) -> numpy uint64 (host only; materializes)."""
        lo = _np.asarray(a[0], dtype=_np.uint64)
        hi = _np.asarray(a[1], dtype=_np.uint64)
        return (hi << _np.uint64(32)) | lo

    def from_u64(v):
        v = _np.asarray(v, dtype=_np.uint64)
        lo = xp.asarray((v & _np.uint64(0xFFFFFFFF)).astype(_np.uint32))
        hi = xp.asarray((v >> _np.uint64(32)).astype(_np.uint32))
        return lo, hi

    def select(cond, a, b):
        return xp.where(cond, a[0], b[0]), xp.where(cond, a[1], b[1])

    def is_zero(a):
        return (a[0] == u32(0)) & (a[1] == u32(0))

    def eq(a, b):
        return (a[0] == b[0]) & (a[1] == b[1])

    ns = dict(
        const=const, canon=canon, add=add, sub=sub, neg=neg, mul=mul, sqr=sqr,
        mul_const=mul_const, pow_const=pow_const, inv=inv, mul_32_32=mul_32_32,
        mul_wide=mul_wide, reduce128=reduce128, to_u64=to_u64, from_u64=from_u64,
        select=select, is_zero=is_zero, eq=eq, xp=xp,
    )
    return type("GL", (), ns)


def _make_gl_u64(xp):
    """Goldilocks ops computed in native uint64 (see uses_u64).
    The public interface is unchanged — (lo, hi) uint32 array pairs in and
    out — and every op returns the same canonical field values as the limb
    path."""
    u32 = xp.uint32
    u64 = xp.uint64
    M32 = u64(0xFFFFFFFF)
    EPS = u64(EPSILON)
    P64 = u64(P)

    def _j(a):
        return a[0].astype(u64) | (a[1].astype(u64) << u64(32))

    def _s(v):
        return (v.astype(u32), (v >> u64(32)).astype(u32))

    def const(v, shape=()):
        v = int(v) % P
        return (xp.full(shape, v & 0xFFFFFFFF, dtype=u32),
                xp.full(shape, v >> 32, dtype=u32))

    def _canon64(v):
        return xp.where(v >= P64, v - P64, v)

    def canon(lo, hi):
        return _s(_canon64(_j((lo, hi))))

    def _add64(x, y):
        s0 = x + y
        s0 = xp.where(s0 < x, s0 + EPS, s0)
        return _canon64(s0)

    def _sub64(x, y):
        d = x - y
        d = xp.where(x < y, d - EPS, d)
        return _canon64(d)

    def _neg64(x):
        return xp.where(x == u64(0), u64(0), P64 - x)

    def _reduce128_64(lo64, hi64):
        """(hi64:lo64) 128-bit value -> canonical field element, using
        2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
        x3 = hi64 >> u64(32)
        x2 = hi64 & M32
        t = lo64 - x3
        t = xp.where(lo64 < x3, t - EPS, t)
        t2 = x2 * EPS
        r = t + t2
        r = xp.where(r < t, r + EPS, r)
        return _canon64(r)

    def _mul64(x, y):
        xl = x & M32
        xh = x >> u64(32)
        yl = y & M32
        yh = y >> u64(32)
        ll = xl * yl
        hh = xh * yh
        lh = xl * yh
        hl = xh * yl
        mid = lh + hl
        mid_c = xp.where(mid < lh, u64(1) << u64(32), u64(0))
        lo = ll + (mid << u64(32))
        c1 = xp.where(lo < ll, u64(1), u64(0))
        hi = hh + (mid >> u64(32)) + mid_c + c1
        return _reduce128_64(lo, hi)

    def add(a, b):
        return _s(_add64(_j(a), _j(b)))

    def sub(a, b):
        return _s(_sub64(_j(a), _j(b)))

    def neg(a):
        return _s(_neg64(_j(a)))

    def mul(a, b):
        return _s(_mul64(_j(a), _j(b)))

    def sqr(a):
        return mul(a, a)

    def mul_const(a, c):
        c64 = u64(int(c) % P)
        return _s(_mul64(_j(a), c64))

    def pow_const(a, e):
        e = int(e)
        x = _j(a)
        r = xp.ones_like(x)
        while e > 0:
            if e & 1:
                r = _mul64(r, x)
            x = _mul64(x, x)
            e >>= 1
        return _s(r)

    from jax import lax as _lax
    _INV_BITS = _np.array([(P - 2) >> k & 1 for k in range(64)],
                          dtype=bool)

    def inv(a):
        def body(carry, bit):
            result, base = carry
            cand = _mul64(result, base)
            return (xp.where(bit, cand, result), _mul64(base, base)), None

        x = _j(a)
        (r, _), _ = _lax.scan(body, (xp.ones_like(x), x),
                              xp.asarray(_INV_BITS))
        return _s(r)

    # u32-word interfaces (used by the Poseidon limb recombination)
    def mul_32_32(a, b):
        p = a.astype(u64) * b.astype(u64)
        return (p.astype(u32), (p >> u64(32)).astype(u32))

    def mul_wide(a, b):
        x = _j(a)
        y = _j(b)
        xl = x & M32
        xh = x >> u64(32)
        yl = y & M32
        yh = y >> u64(32)
        ll = xl * yl
        hh = xh * yh
        lh = xl * yh
        hl = xh * yl
        mid = lh + hl
        mid_c = xp.where(mid < lh, u64(1) << u64(32), u64(0))
        lo = ll + (mid << u64(32))
        c1 = xp.where(lo < ll, u64(1), u64(0))
        hi = hh + (mid >> u64(32)) + mid_c + c1
        return (*_s(lo), *_s(hi))

    def reduce128(x0, x1, x2, x3):
        lo = x0.astype(u64) | (x1.astype(u64) << u64(32))
        hi = x2.astype(u64) | (x3.astype(u64) << u64(32))
        return _s(_reduce128_64(lo, hi))

    def to_u64(a):
        lo = _np.asarray(a[0], dtype=_np.uint64)
        hi = _np.asarray(a[1], dtype=_np.uint64)
        return (hi << _np.uint64(32)) | lo

    def from_u64(v):
        v = _np.asarray(v, dtype=_np.uint64)
        lo = xp.asarray((v & _np.uint64(0xFFFFFFFF)).astype(_np.uint32))
        hi = xp.asarray((v >> _np.uint64(32)).astype(_np.uint32))
        return lo, hi

    def select(cond, a, b):
        return xp.where(cond, a[0], b[0]), xp.where(cond, a[1], b[1])

    def is_zero(a):
        return (a[0] == u32(0)) & (a[1] == u32(0))

    def eq(a, b):
        return (a[0] == b[0]) & (a[1] == b[1])

    ns = dict(
        const=const, canon=canon, add=add, sub=sub, neg=neg, mul=mul,
        sqr=sqr, mul_const=mul_const, pow_const=pow_const, inv=inv,
        mul_32_32=mul_32_32, mul_wide=mul_wide, reduce128=reduce128,
        to_u64=to_u64, from_u64=from_u64, select=select, is_zero=is_zero,
        eq=eq, xp=xp,
    )
    return type("GL64", (), ns)


# ---------------------------------------------------------------------------
# Host scalar ops on python ints (for the Fiat-Shamir challenger, twiddle
# precomputation and small host-side math).


def s_add(a: int, b: int) -> int:
    return (a + b) % P


def s_sub(a: int, b: int) -> int:
    return (a - b) % P


def s_mul(a: int, b: int) -> int:
    return (a * b) % P


def s_inv(a: int) -> int:
    return pow(a, P - 2, P)


def s_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity."""
    assert 0 <= log_n <= TWO_ADICITY
    g = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        g = (g * g) % P
    return g
