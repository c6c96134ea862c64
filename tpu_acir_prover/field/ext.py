"""Quadratic extension GF(p^2) = F[u]/(u^2 - 7) over Goldilocks.

7 is a quadratic non-residue mod p (verified in tests).  Elements are pairs
(a0, a1) of base-field elements (each a (lo, hi) uint32 pair), representing
a0 + a1*u.  This mirrors the reference's extension degree D=2
(/root/reference/plonky2-backend/src/lib.rs:11-13) used for soundness of
the opening/FRI challenges; the arithmetic here is our own (lo, hi)-limb design.
"""

from __future__ import annotations

from . import gl as _gl

W = 7  # u^2 = 7
# DTH root for Frobenius if ever needed: u^p = W^((p-1)/2) * u.


def make_ext(G):
    """Extension ops over a base-field namespace ``G = make_gl(xp)``."""

    def const(v0, v1=0, shape=()):
        return (G.const(v0, shape), G.const(v1, shape))

    def from_base(a):
        z = (G.xp.zeros_like(a[0]), G.xp.zeros_like(a[1]))
        return (a, z)

    def add(x, y):
        return (G.add(x[0], y[0]), G.add(x[1], y[1]))

    def sub(x, y):
        return (G.sub(x[0], y[0]), G.sub(x[1], y[1]))

    def neg(x):
        return (G.neg(x[0]), G.neg(x[1]))

    def mul(x, y):
        # (a0 + a1 u)(b0 + b1 u) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) u
        a0b0 = G.mul(x[0], y[0])
        a1b1 = G.mul(x[1], y[1])
        a0b1 = G.mul(x[0], y[1])
        a1b0 = G.mul(x[1], y[0])
        c0 = G.add(a0b0, G.mul_const(a1b1, W))
        c1 = G.add(a0b1, a1b0)
        return (c0, c1)

    def mul_base(x, b):
        return (G.mul(x[0], b), G.mul(x[1], b))

    def sqr(x):
        return mul(x, x)

    def inv(x):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - 7 a1^2)
        d = G.sub(G.sqr(x[0]), G.mul_const(G.sqr(x[1]), W))
        di = G.inv(d)
        return (G.mul(x[0], di), G.neg(G.mul(x[1], di)))

    def pow_const(x, e):
        e = int(e)
        r = const(1, 0, G.xp.shape(x[0][0]))
        b = x
        while e > 0:
            if e & 1:
                r = mul(r, b)
            b = mul(b, b)
            e >>= 1
        return r

    def select(cond, x, y):
        return (G.select(cond, x[0], y[0]), G.select(cond, x[1], y[1]))

    def eq(x, y):
        return G.eq(x[0], y[0]) & G.eq(x[1], y[1])

    def is_zero(x):
        return G.is_zero(x[0]) & G.is_zero(x[1])

    def to_u64(x):
        return (G.to_u64(x[0]), G.to_u64(x[1]))

    def from_u64(v0, v1):
        return (G.from_u64(v0), G.from_u64(v1))

    ns = dict(
        const=const, from_base=from_base, add=add, sub=sub, neg=neg, mul=mul,
        mul_base=mul_base, sqr=sqr, inv=inv, pow_const=pow_const, select=select,
        eq=eq, is_zero=is_zero, to_u64=to_u64, from_u64=from_u64, G=G,
    )
    return type("EXT", (), ns)


# Host scalar extension ops on python-int pairs (for the challenger/verifier).

def e_add(x, y):
    return ((x[0] + y[0]) % _gl.P, (x[1] + y[1]) % _gl.P)


def e_sub(x, y):
    return ((x[0] - y[0]) % _gl.P, (x[1] - y[1]) % _gl.P)


def e_mul(x, y):
    p = _gl.P
    return ((x[0] * y[0] + W * x[1] * y[1]) % p, (x[0] * y[1] + x[1] * y[0]) % p)


def e_inv(x):
    p = _gl.P
    d = (x[0] * x[0] - W * x[1] * x[1]) % p
    di = pow(d, p - 2, p)
    return ((x[0] * di) % p, (-x[1] * di) % p)


def e_pow(x, e):
    r = (1, 0)
    b = x
    while e > 0:
        if e & 1:
            r = e_mul(r, b)
        b = e_mul(b, b)
        e >>= 1
    return r
