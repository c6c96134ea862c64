"""Radix-2 NTT / inverse NTT / coset LDE over Goldilocks, batched over columns.

Values live as (lo, hi) uint32 arrays of shape (n, C) — rows are the
evaluation domain, columns are polynomials (wires, sigmas, quotient
chunks, ...).  Every butterfly stage is a vectorized field op over static
shapes, so XLA sees a fixed dataflow graph; the same code runs inside
shard_map for the multi-device domain sharding (see parallel/).

This subsumes the role of the reference's external plonky2 fork FFT
(SURVEY.md §2.3: LDE + polynomial ops parallelized with rayon) — here the
parallelism is vectorization + mesh sharding instead of CPU threads.
"""

from __future__ import annotations

import functools

import numpy as np

from ..field import gl as _gl


@functools.lru_cache(maxsize=None)
def _twiddle_tables(log_n: int, inverse: bool):
    """Per-stage twiddle factors, stage s has 2^s twiddles (numpy uint64)."""
    tables = []
    for s in range(log_n):
        h = 1 << s
        w = _gl.root_of_unity(s + 1)
        if inverse:
            w = _gl.s_inv(w)
        tw = np.empty(h, dtype=np.uint64)
        cur = 1
        for j in range(h):
            tw[j] = cur
            cur = _gl.s_mul(cur, w)
        tables.append(tw)
    return tables


@functools.lru_cache(maxsize=None)
def bit_reverse_indices(log_n: int):
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _as_2d(a):
    return a if a.ndim == 2 else a.reshape(a.shape[0], 1)


def _is_jax(xp):
    return "jax" in getattr(xp, "__name__", "")


def device_powers(G, base: int, n: int):
    """[base^0 .. base^(n-1)] as a device (lo, hi) pair, built by
    log-doubling (log2 n concats of O(k) muls).

    Used instead of numpy-table constants inside jitted programs: an
    embedded n-element uint64 literal costs 8n bytes of HLO per program
    (64 MB at n = 2^23), which dominated compile time and the on-disk
    compilation cache; the in-graph computation is O(n) multiplies —
    noise next to the O(n log n) NTT it feeds."""
    xp = G.xp
    lo = xp.ones((1,), xp.uint32)
    hi = xp.zeros((1,), xp.uint32)
    cur = base % _gl.P
    k = 1
    while k < n:
        c = G.const(cur)
        step = G.mul((lo, hi), (c[0].reshape(1), c[1].reshape(1)))
        lo = xp.concatenate([lo, step[0]])
        hi = xp.concatenate([hi, step[1]])
        cur = _gl.s_mul(cur, cur)
        k *= 2
    return lo[:n], hi[:n]


def device_powers_rolled(G, base: int, n: int):
    """[base^0 .. base^(n-1)] as a device (lo, hi) pair via a ROLLED
    bit-scan fori_loop (one ~200-eqn body vs log2(n) unrolled doubling
    steps): acc_i = prod over set bits b of i of base^(2^b).  Values are
    exact field products — bit-identical to device_powers."""
    import jax.numpy as jnp
    from jax import lax
    xp = G.xp
    if n <= 2:
        return device_powers(G, base, n)
    log_n = (n - 1).bit_length()
    # base^(2^b) for b in [0, log_n) — tiny host table of scalars
    sq = np.empty(log_n, dtype=np.uint64)
    cur = base % _gl.P
    for b in range(log_n):
        sq[b] = cur
        cur = _gl.s_mul(cur, cur)
    sq_lo = xp.asarray((sq & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    sq_hi = xp.asarray((sq >> np.uint64(32)).astype(np.uint32))
    idx = jnp.arange(n, dtype=jnp.int32)

    def body(b, acc):
        bit = ((idx >> b) & 1) == 1
        stepped = G.mul(acc, (sq_lo[b].reshape(1), sq_hi[b].reshape(1)))
        return (xp.where(bit, stepped[0], acc[0]),
                xp.where(bit, stepped[1], acc[1]))

    one = (xp.ones(n, xp.uint32), xp.zeros(n, xp.uint32))
    return lax.fori_loop(0, log_n, body, one)


def ntt(G, values, inverse=False):
    """NTT along axis 0 of (lo, hi) arrays shaped (n,) or (n, C).

    Natural-order input and output (bit-reversal applied internally).

    jax path: the stage loop is ONE fori_loop body using XOR-partner
    gathers, ~1.5k jaxpr eqns per NTT.  On an H100 80GB HBM3 at 700 W
    (PERF.md) it ran a 2^20 x 6 NTT in 4.18 ms after a 0.73 s compile; an
    unrolled radix-4 static-reshape pipeline ran it in 1.97 ms but compiled
    in 11.0 s, and a prove compiles one NTT per call site
    (scripts/field_paths.py counts them), so the rolled form is the only
    one kept.  numpy path: static radix-2 stages with host twiddle tables.
    Both compute the identical butterflies, so outputs are bit-identical.
    """
    xp = G.xp
    lo, hi = values
    squeeze = lo.ndim == 1
    lo, hi = _as_2d(lo), _as_2d(hi)
    n, c = lo.shape
    log_n = int(n).bit_length() - 1
    assert (1 << log_n) == n, "NTT size must be a power of two"

    if _is_jax(xp):
        lo, hi = _ntt_rolled(G, lo, hi, log_n, inverse)
    else:
        lo, hi = _ntt_static(G, lo, hi, log_n, inverse)
    if inverse:
        n_inv = G.from_u64(np.uint64(_gl.s_inv(n)))
        lo, hi = G.mul((lo, hi), (n_inv[0].reshape(1, 1), n_inv[1].reshape(1, 1)))
    if squeeze:
        lo, hi = lo.reshape(-1), hi.reshape(-1)
    return lo, hi


def _ntt_rolled(G, lo, hi, log_n: int, inverse: bool):
    """Bit-reversal plus all butterfly stages as two fori_loops."""
    import jax.numpy as jnp
    from jax import lax
    xp = G.xp
    n = 1 << log_n
    w_last = _gl.root_of_unity(log_n)
    if inverse:
        w_last = _gl.s_inv(w_last)
    idx = jnp.arange(n, dtype=jnp.int32)

    def revbody(b, rev):
        return rev | (((idx >> b) & 1) << (log_n - 1 - b))

    rev = lax.fori_loop(0, log_n, revbody, jnp.zeros(n, jnp.int32))
    lo = jnp.take(lo, rev, axis=0)
    hi = jnp.take(hi, rev, axis=0)
    ptab = device_powers_rolled(G, w_last, max(n // 2, 1))
    half = n // 2

    def stage(s, st):
        slo, shi = st
        h = jnp.int32(1) << s
        partner = idx ^ h
        stride = jnp.int32(half) >> s
        tw_idx = (idx & (h - 1)) * stride
        twl = jnp.take(ptab[0], tw_idx)
        twh = jnp.take(ptab[1], tw_idx)
        wb = G.mul((slo, shi), (twl[:, None], twh[:, None]))
        plo = jnp.take(slo, partner, axis=0)
        phi = jnp.take(shi, partner, axis=0)
        pwlo = jnp.take(wb[0], partner, axis=0)
        pwhi = jnp.take(wb[1], partner, axis=0)
        up = ((idx & h) != 0)[:, None]
        addv = G.add((slo, shi), (pwlo, pwhi))
        subv = G.sub((plo, phi), (wb[0], wb[1]))
        return (xp.where(up, subv[0], addv[0]),
                xp.where(up, subv[1], addv[1]))

    return lax.fori_loop(0, log_n, stage, (lo, hi))


def _ntt_static(G, lo, hi, log_n: int, inverse: bool):
    """Bit-reversal plus radix-2 stages over static reshapes (host)."""
    xp = G.xp
    n, c = lo.shape
    rev = xp.asarray(bit_reverse_indices(log_n).astype(np.int32))
    lo = xp.take(lo, rev, axis=0)
    hi = xp.take(hi, rev, axis=0)
    tables = _twiddle_tables(log_n, inverse)
    for s in range(log_n):
        h = 1 << s
        tw = G.from_u64(tables[s])  # shape (h,)
        tw = (tw[0].reshape(1, h, 1), tw[1].reshape(1, h, 1))
        a = (lo.reshape(-1, 2, h, c)[:, 0], hi.reshape(-1, 2, h, c)[:, 0])
        b = (lo.reshape(-1, 2, h, c)[:, 1], hi.reshape(-1, 2, h, c)[:, 1])
        t = G.mul(b, tw)
        s0 = G.add(a, t)
        s1 = G.sub(a, t)
        lo = xp.stack([s0[0], s1[0]], axis=1).reshape(n, c)
        hi = xp.stack([s0[1], s1[1]], axis=1).reshape(n, c)
    return lo, hi


def intt(G, values):
    return ntt(G, values, inverse=True)


@functools.lru_cache(maxsize=None)
def _shift_powers(log_n: int, shift: int, inverse: bool):
    n = 1 << log_n
    s = _gl.s_inv(shift) if inverse else (shift % _gl.P)
    out = np.empty(n, dtype=np.uint64)
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = _gl.s_mul(cur, s)
    return out


def coset_lde(G, coeffs, rate_bits: int, shift: int = _gl.MULTIPLICATIVE_GENERATOR):
    """Evaluate polynomials (coeff form, shape (n, C)) on the coset
    shift * H_{n * 2^rate_bits}, returning (n * 2^rate_bits, C) evals."""
    xp = G.xp
    lo, hi = _as_2d(coeffs[0]), _as_2d(coeffs[1])
    n, c = lo.shape
    log_n = int(n).bit_length() - 1
    m = n << rate_bits
    if _is_jax(xp):
        sp = device_powers(G, shift % _gl.P, n)
    else:
        sp = G.from_u64(_shift_powers(log_n, shift, False))
    lo, hi = G.mul((lo, hi), (sp[0].reshape(n, 1), sp[1].reshape(n, 1)))
    pad = ((0, m - n), (0, 0))
    lo = xp.pad(lo, pad)
    hi = xp.pad(hi, pad)
    return ntt(G, (lo, hi))


def coset_intt(G, values, shift: int = _gl.MULTIPLICATIVE_GENERATOR):
    """Interpolate values on coset shift * H_m back to coefficients."""
    lo, hi = _as_2d(values[0]), _as_2d(values[1])
    m = lo.shape[0]
    log_m = int(m).bit_length() - 1
    lo, hi = intt(G, (lo, hi))
    if _is_jax(G.xp):
        sp = device_powers(G, _gl.s_inv(shift), m)
    else:
        sp = G.from_u64(_shift_powers(log_m, shift, True))
    return G.mul((lo, hi), (sp[0].reshape(m, 1), sp[1].reshape(m, 1)))
