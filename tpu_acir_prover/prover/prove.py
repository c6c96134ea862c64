"""End-to-end prover: compiled circuit + witness -> FRI proof.

Owns the pipeline the reference hands to its external fork at
circuit_data.prove (actions/prove_action.rs:91-97): witness fill ->
wire/Z/quotient polynomial construction -> coset LDE -> Poseidon Merkle
commitments -> openings at zeta in GF(p^2) -> batch FRI.  The host only
drives the Fiat-Shamir transcript between phases; every phase is ONE jitted
XLA program (cached on the ProvingKey), with challenges passed as traced
scalars so recompilation never happens across proofs.

Proof relation (PLONK over Goldilocks, W routed wires, one wide universal
gate + LogUp lookups; see circuit/builder.py for the row semantics):

  gate:   sum_j qM_j*w_{2j}*w_{2j+1} + sum_i qi*wi + qC + PI(x) = 0   on H
  perm:   L_1(x)*(Z(x)-1) = 0, and with the W factor terms split into
          groups of <= PERM_GROUP (keeping each constraint at degree <= 7,
          the rate-8 LDE budget; plonky2 calls these partial products):
            Z*N_1 - B_1*D_1 = 0
            B_{j-1}*N_j - B_j*D_j = 0
            B_{K-1}*N_K - Z(gx)*D_K = 0
          where N_g = prod_{i in g} (w_i + B*k_i*x + G),
                D_g = prod_{i in g} (w_i + B*sigma_i + G).
  lookup (LogUp, only when the circuit carries lookup rows):
          for each helper group hg (<= LOOKUP_GROUP wires):
            h_g * prod_{i in hg} (lam - w_i)
              = qLK * sum_{i in hg} prod_{k != i} (lam - w_k)
          h_T * (lam - T) = 1
          S(gx) - S(x) - sum_g h_g + mult * h_T = 0
          L_1(x) * S(x) = 0
          (the cyclic wrap of the S recurrence forces
           sum_rows sum_slots 1/(lam - w) = sum_rows mult/(lam - T),
           i.e. every looked-up value appears in the table)
  t(x) = sum_j alpha^j c_j(x) / (x^n - 1), committed in NUM_CHUNKS chunks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..circuit.builder import (NUM_PAIRS, NUM_SELECTORS, NUM_WIRES, SEL_QLK,
                               lookup_groups, perm_groups)
from ..circuit.compile import CompiledCircuit, powers_u64
from ..field import gl as _gl
from ..field.ext import make_ext, e_add, e_mul, e_pow
from ..field.gl import P, make_gl
from ..field.poseidon import make_poseidon
from .challenger import Challenger
from .config import ProofConfig, STANDARD_CONFIG
from .fri import grind, _to_dev, _mul_u64, _HALF
from .merkle import MerkleTree
from .ntt import coset_intt, coset_lde, intt
from .proof import (Openings, OracleOpening, Proof, QueryRound, FriStep,
                    VerifyingKey)

NUM_CHUNKS = 6  # quotient degree < 6n for constraint degree <= 7 at rate 8


def _default_xp():
    from ..utils.jaxcfg import setup_jax
    setup_jax()
    import jax.numpy as jnp
    return jnp


def _from_dev_u64(G, pair) -> np.ndarray:
    return np.asarray(G.to_u64(pair))


def _mat_to_dev(G, m_u64: np.ndarray):
    m_u64 = np.ascontiguousarray(m_u64, dtype=np.uint64)
    return (G.xp.asarray((m_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            G.xp.asarray((m_u64 >> np.uint64(32)).astype(np.uint32)))


def sum_rows(G, m):
    """Tree-sum a (n, C) field matrix over axis 0 -> (C,)."""
    lo, hi = m
    while lo.shape[0] > 1:
        half = lo.shape[0] // 2
        lo, hi = G.add((lo[:half], hi[:half]), (lo[half:], hi[half:]))
    return lo[0], hi[0]


def ext_powers_u64(z: Tuple[int, int], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """[z^0 .. z^(n-1)] in GF(p^2) as (re, im) uint64 arrays (host limbs)."""
    G = make_gl(np)
    re = (np.array([1], np.uint32), np.array([0], np.uint32))
    im = (np.array([0], np.uint32), np.array([0], np.uint32))
    cur = z
    k = 1
    while k < n:
        c0 = G.const(cur[0], (1,))
        c1 = G.const(cur[1], (1,))
        nre = G.add(G.mul(re, c0), G.mul_const(G.mul(im, c1), 7))
        nim = G.add(G.mul(re, c1), G.mul(im, c0))
        re = (np.concatenate([re[0], nre[0]]), np.concatenate([re[1], nre[1]]))
        im = (np.concatenate([im[0], nim[0]]), np.concatenate([im[1], nim[1]]))
        cur = e_mul(cur, cur)
        k *= 2
    return (G.to_u64((re[0][:n], re[1][:n])), G.to_u64((im[0][:n], im[1][:n])))


def _scal(G, x):
    """Scalar uint32 array -> (1,) broadcastable."""
    return x.reshape(1)


def _ext_arg(v: Tuple[int, int]):
    """Ext scalar -> 4 uint32 numpy scalars (lo/hi of re/im)."""
    return (np.uint32(v[0] & 0xFFFFFFFF), np.uint32(v[0] >> 32),
            np.uint32(v[1] & 0xFFFFFFFF), np.uint32(v[1] >> 32))


def _ext_scal(G, a0, a1, a2, a3):
    """4 traced u32 scalars -> broadcastable ext value."""
    return ((_scal(G, a0), _scal(G, a1)), (_scal(G, a2), _scal(G, a3)))


@dataclass
class Oracle:
    """A committed polynomial batch: coeffs + LDE values + Merkle tree."""
    coeffs: tuple      # (n, C) dev pair
    lde: tuple         # (m, C) dev pair
    tree: MerkleTree


def _ext_zeros(xp, n):
    z = xp.zeros((n,), xp.uint32)
    return ((z, z), (z, z))


def _ext_ones(xp, n):
    return ((xp.ones((n,), xp.uint32), xp.zeros((n,), xp.uint32)),
            (xp.zeros((n,), xp.uint32), xp.zeros((n,), xp.uint32)))


def batch_inv_ext(E, vals):
    """Batch inversion of a list of (n,)-shaped ext vectors: one Fermat
    inversion + ~3*len multiplications, arranged as a BINARY TREE (product
    tree up, inverse push-down) instead of the sequential Montgomery chain
    — the chain's O(len) dependent-multiply depth hits the XLA fusion
    duplication blowup (see tree_fold); the tree is depth O(log len).
    Inverses are unique field values, so outputs are unchanged."""
    if len(vals) == 1:
        return [E.inv(vals[0])]
    levels = [list(vals)]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([E.mul(cur[i], cur[i + 1]) if i + 1 < len(cur)
                       else cur[i] for i in range(0, len(cur), 2)])
    inv = [E.inv(levels[-1][0])]
    for lev in range(len(levels) - 2, -1, -1):
        cur = levels[lev]
        ninv = []
        for i in range(0, len(cur), 2):
            p = inv[i // 2]
            if i + 1 < len(cur):
                ninv.append(E.mul(p, cur[i + 1]))
                ninv.append(E.mul(p, cur[i]))
            else:
                ninv.append(p)
        inv = ninv
    return inv


def tree_fold(fn, items):
    """Balanced binary fold of [x0, x1, ...] with an associative op.

    Field ops are exact mod p, so reassociation never changes values; what
    it changes is DEPTH.  XLA's fusion emitters duplicate
    multi-user subexpressions inside a fusion, so a depth-d dependent chain
    of limb multiplies costs O(c^d) generated work — a 32-deep chain took
    minutes to run on XLA:CPU while the balanced tree is milliseconds.
    Every product/sum over wires or constraint terms must fold as a tree."""
    items = list(items)
    assert items
    while len(items) > 1:
        nxt = [fn(items[i], items[i + 1]) if i + 1 < len(items) else items[i]
               for i in range(0, len(items), 2)]
        items = nxt
    return items[0]


def _group_gather(G, groups, W: int):
    """Host-precomputed (K, gp) column-index and mask arrays for gathering
    per-group wire columns into an (n, K, gp) tensor (gp = group size
    padded to a power of two; masked lanes get the op's neutral)."""
    K = len(groups)
    gmax = max(e - s for s, e in groups)
    gp = 1
    while gp < gmax:
        gp *= 2
    idx = np.zeros((K, gp), np.int32)
    mask = np.zeros((K, gp), bool)
    for t, (s, e) in enumerate(groups):
        idx[t, :e - s] = np.arange(s, e, dtype=np.int32)
        mask[t, :e - s] = True
    return G.xp.asarray(idx), G.xp.asarray(mask), gp


def _group_tensor(G, fmat, idxd, maskd, neutral):
    """Gather an (n, W) ext matrix into a masked (n, K, gp) ext tensor."""
    xp = G.xp

    def take(c):
        return xp.take(c, idxd, axis=1)

    (nr_lo, nr_hi), (ni_lo, ni_hi) = neutral
    re = (xp.where(maskd, take(fmat[0][0]), xp.uint32(nr_lo)),
          xp.where(maskd, take(fmat[0][1]), xp.uint32(nr_hi)))
    im = (xp.where(maskd, take(fmat[1][0]), xp.uint32(ni_lo)),
          xp.where(maskd, take(fmat[1][1]), xp.uint32(ni_hi)))
    return re, im


_EXT_ONE_NEUTRAL = ((1, 0), (0, 0))
_EXT_ZERO_NEUTRAL = ((0, 0), (0, 0))


def _fold_last_axis(op, tens):
    """Log-halving reduction over the last axis of an ext tensor."""
    w = tens[0][0].shape[-1]
    while w > 1:
        h = w // 2
        a = tuple(tuple(c[..., :h] for c in comp) for comp in tens)
        b = tuple(tuple(c[..., h:] for c in comp) for comp in tens)
        tens = op(a, b)
        w = h
    return tuple(tuple(c[..., 0] for c in comp) for comp in tens)


def _axis_excl_products(E, tens, reverse=False):
    """Exclusive prefix (suffix with reverse=True) products along the last
    axis of an ext tensor, via log-depth Hillis-Steele with STATIC shifts."""
    xp = E.G.xp

    def flip(t):
        return tuple(tuple(xp.flip(c, axis=-1) for c in comp) for comp in t)

    if reverse:
        tens = flip(tens)
    gp = tens[0][0].shape[-1]

    def shift(t, d):
        def sh(c, fill):
            pad_shape = c.shape[:-1] + (d,)
            fill_arr = xp.full(pad_shape, fill, xp.uint32)
            return xp.concatenate([fill_arr, c[..., :-d]], axis=-1)

        return ((sh(t[0][0], 1), sh(t[0][1], 0)),
                (sh(t[1][0], 0), sh(t[1][1], 0)))

    acc = shift(tens, 1)  # exclusive: drop self, shift in the neutral 1
    d = 1
    while d < gp:
        acc = E.mul(acc, shift(acc, d))
        d *= 2
    if reverse:
        acc = flip(acc)
    return acc


def grouped_fold(G, E, fmat, groups, op, neutral):
    """Per-group log-halving fold of an (n, W) ext matrix's columns.

    Returns a STACKED (n, K) ext tensor of per-group values.  One gather +
    log2(gp) matrix ops for ALL groups — the graph stays O(log) regardless
    of wire count, which keeps the XLA:CPU compile of the round2/quotient
    bodies seconds instead of minutes (the per-column tree_fold unrolling
    was the dominant compile cost at W = 16)."""
    idxd, maskd, gp = _group_gather(G, groups, fmat[0][0].shape[1])
    tens = _group_tensor(G, fmat, idxd, maskd, neutral)
    return _fold_last_axis(op, tens)


def _col_ext(tens, t):
    """Ext column t of a stacked (n, K) ext tensor."""
    return ((tens[0][0][:, t], tens[0][1][:, t]),
            (tens[1][0][:, t], tens[1][1][:, t]))


def _bcast_cols(v):
    """(n,) ext value -> (n, 1) broadcastable over stacked columns."""
    return tuple(tuple(c[:, None] for c in comp) for comp in v)


def _slice_cols(tens, sl):
    """Column slice of a stacked ext tensor."""
    return tuple(tuple(c[:, sl] for c in comp) for comp in tens)


def _pad_cols(xp, tens, neutral):
    """Pad a stacked (n, K) ext tensor's columns to a power of two with the
    op's neutral so log-halving folds apply (x op neutral is exact mod p, so
    values are unchanged)."""
    k = tens[0][0].shape[-1]
    m = 1 << max(0, (k - 1).bit_length())
    if m == k:
        return tens
    (nr_lo, nr_hi), (ni_lo, ni_hi) = neutral
    out = []
    for comp, f2 in zip(tens, ((nr_lo, nr_hi), (ni_lo, ni_hi))):
        padded = []
        for c, f in zip(comp, f2):
            pad = xp.full(c.shape[:-1] + (m - k,), f, xp.uint32)
            padded.append(xp.concatenate([c, pad], axis=-1))
        out.append(tuple(padded))
    return tuple(out)


def _fold_cols(xp, op, tens, neutral):
    """Fold a stacked (n, K) ext tensor over columns (any K) -> (n,) ext.
    Pads with the neutral to a power of two; the resulting pairing order
    equals tree_fold's (exact field ops, so values are order-independent
    anyway)."""
    return _fold_last_axis(op, _pad_cols(xp, tens, neutral))


def _axis_incl_scan(E, tens, op, neutral):
    """Inclusive Hillis-Steele scan along the last axis of a stacked ext
    tensor (log K steps of full-width ops)."""
    xp = E.G.xp
    k = tens[0][0].shape[-1]
    (nr_lo, nr_hi), (ni_lo, ni_hi) = neutral
    fills = ((nr_lo, nr_hi), (ni_lo, ni_hi))
    acc = tens
    d = 1
    while d < k:
        shifted = tuple(
            tuple(xp.concatenate(
                [xp.full(c.shape[:-1] + (d,), f, xp.uint32), c[..., :-d]],
                axis=-1) for c, f in zip(comp, f2))
            for comp, f2 in zip(acc, fills))
        acc = op(acc, shifted)
        d *= 2
    return acc


def perm_group_products(G, E, wires, sigmas, xpair, k_dev, beta_d, gamma_d,
                        groups):
    """Per-group (N_g, D_g) products of the permutation factors
    (w_i + B k_i x + G) / (w_i + B sigma_i + G).

    wires/sigmas: (n, W) pairs; k_dev: (W,) pair; returns two STACKED
    (n, K) ext tensors, one column per group.  Fully matrix-form: the
    factors for all W wires are a handful of (n, W) ops."""
    kx = G.mul((xpair[0][:, None], xpair[1][:, None]),
               (k_dev[0][None, :], k_dev[1][None, :]))  # (n, W)

    def factor_mat(second):
        return (G.add(G.add(wires, G.mul(beta_d[0], second)), gamma_d[0]),
                G.add(G.mul(beta_d[1], second), gamma_d[1]))

    f_num = factor_mat(kx)
    f_den = factor_mat(sigmas)
    nums = grouped_fold(G, E, f_num, groups, E.mul, _EXT_ONE_NEUTRAL)
    dens = grouped_fold(G, E, f_den, groups, E.mul, _EXT_ONE_NEUTRAL)
    return nums, dens


def batch_inv_ext_cols(E, mat):
    """Columnwise batch inversion of an (n, W) ext matrix (W a power of
    two): product tree up by column halving, ONE Fermat inversion of the
    (n, 1) root, interleaved push-down.  O(log W) matrix ops."""
    xp = E.G.xp
    levels = [mat]
    w = mat[0][0].shape[1]
    while w > 1:
        cur = levels[-1]
        a = tuple(tuple(c[:, 0::2] for c in comp) for comp in cur)
        b = tuple(tuple(c[:, 1::2] for c in comp) for comp in cur)
        levels.append(E.mul(a, b))
        w //= 2
    inv = E.inv(levels[-1])
    for lev in levels[-2::-1]:
        a = tuple(tuple(c[:, 0::2] for c in comp) for comp in lev)
        b = tuple(tuple(c[:, 1::2] for c in comp) for comp in lev)
        left = E.mul(inv, b)    # 1/a
        right = E.mul(inv, a)   # 1/b

        def ilv(x, y):
            n, k = x.shape
            return xp.stack([x, y], axis=2).reshape(n, 2 * k)

        inv = tuple(tuple(ilv(ca, cb) for ca, cb in zip(compa, compb))
                    for compa, compb in zip(left, right))
    return inv


def lookup_fac_matrix(G, E, wires, lam_d):
    """(lam - w_i) for all wires as one (n, W) ext matrix."""
    xp = G.xp
    wlo, whi = wires
    z = xp.zeros_like(wlo)
    return (G.sub(lam_d[0], (wlo, whi)),
            G.sub(lam_d[1], (z, z)))


def lookup_helper_terms(G, E, wires, lam_d, qlk, groups, is_jax=False):
    """Per-helper-group values h_g = qLK * sum_{i in g} 1/(lam - w_i).
    wires: (n, W) pair, qlk: (n,) base pair, returns a STACKED (n, nh)
    ext tensor.

    On the jax backend the columnwise inverse is one direct E.inv on the
    whole (n, W) matrix (a single rolled Fermat scan — ~1k jaxpr eqns)
    instead of the interleaved product tree (~9k eqns of unrolled levels,
    the single largest term in the round2 body's compile time); inverses
    are unique field values, so the results are bit-identical."""
    fmat = lookup_fac_matrix(G, E, wires, lam_d)
    invs = E.inv(fmat) if is_jax else batch_inv_ext_cols(E, fmat)
    sums = grouped_fold(G, E, invs, groups, E.add, _EXT_ZERO_NEUTRAL)
    qb = (qlk[0][:, None], qlk[1][:, None])
    return (G.mul(sums[0], qb), G.mul(sums[1], qb))


def prefix_product_ext(G, E, is_jax, ratio, log_n: int):
    """Inclusive prefix product of an ext vector (Hillis-Steele)."""
    xp = G.xp
    n = ratio[0][0].shape[0]
    if not is_jax:
        acc = ratio
        d = 1
        while d < n:
            zl = xp.zeros((d,), dtype=xp.uint32)
            ol = xp.ones((d,), dtype=xp.uint32)

            def sh(comp, fill_lo):
                return (xp.concatenate([fill_lo, comp[0][:-d]]),
                        xp.concatenate([zl, comp[1][:-d]]))

            acc = E.mul(acc, (sh(acc[0], ol), sh(acc[1], zl)))
            d *= 2
        return acc

    import jax.numpy as jnp
    from jax import lax
    iota = lax.iota(jnp.int32, n)

    def body(s, acc):
        d = jnp.int32(1) << s

        def sh(comp, fill_one):
            rl = jnp.roll(comp[0], d)
            rh = jnp.roll(comp[1], d)
            mask = iota < d
            fl = jnp.where(mask, jnp.uint32(1 if fill_one else 0), rl)
            fh = jnp.where(mask, jnp.uint32(0), rh)
            return fl, fh

        return E.mul(acc, (sh(acc[0], True), sh(acc[1], False)))

    return lax.fori_loop(0, log_n, body, ratio)


def prefix_sum_ext(G, E, is_jax, vals, log_n: int):
    """Inclusive prefix sum of an ext vector (Hillis-Steele adds)."""
    xp = G.xp
    n = vals[0][0].shape[0]
    if not is_jax:
        acc = vals
        d = 1
        while d < n:
            zl = xp.zeros((d,), dtype=xp.uint32)

            def sh(comp):
                return (xp.concatenate([zl, comp[0][:-d]]),
                        xp.concatenate([zl, comp[1][:-d]]))

            acc = E.add(acc, (sh(acc[0]), sh(acc[1])))
            d *= 2
        return acc

    import jax.numpy as jnp
    from jax import lax
    iota = lax.iota(jnp.int32, n)

    def body(s, acc):
        d = jnp.int32(1) << s

        def sh(comp):
            rl = jnp.roll(comp[0], d)
            rh = jnp.roll(comp[1], d)
            mask = iota < d
            return (jnp.where(mask, jnp.uint32(0), rl),
                    jnp.where(mask, jnp.uint32(0), rh))

        return E.add(acc, (sh(acc[0]), sh(acc[1])))

    return lax.fori_loop(0, log_n, body, vals)


def _shift_one(xp, comp, fill_one=False):
    """Prepend [1 or 0] and drop the last element of a (n,) base pair."""
    o1 = xp.ones((1,), dtype=xp.uint32) if fill_one else \
        xp.zeros((1,), dtype=xp.uint32)
    z1 = xp.zeros((1,), dtype=xp.uint32)
    return (xp.concatenate([o1, comp[0][:-1]]),
            xp.concatenate([z1, comp[1][:-1]]))


def gate_eval(G, q_cols, w_cols):
    """sum_j qM_j*w_{2j}*w_{2j+1} + sum_i q_i*w_i + qC on (n, C) matrices.
    q_cols: (n, NUM_SELECTORS) pair; w_cols: (n, W) pair.  Matrix-form:
    three (n, *) muls + a log-halving column sum (compile-friendly)."""
    xp = G.xp
    qlo, qhi = q_cols
    wlo, whi = w_cols
    n, W = wlo.shape
    npair = W // 2

    pair = G.mul((wlo[:, 0::2], whi[:, 0::2]), (wlo[:, 1::2], whi[:, 1::2]))
    t1 = G.mul((qlo[:, :npair], qhi[:, :npair]), pair)          # (n, P)
    t2 = G.mul((qlo[:, npair:npair + W], qhi[:, npair:npair + W]),
               (wlo, whi))                                      # (n, W)
    cat_lo = xp.concatenate(
        [t1[0], t2[0], qlo[:, npair + W:npair + W + 1]], axis=1)
    cat_hi = xp.concatenate(
        [t1[1], t2[1], qhi[:, npair + W:npair + W + 1]], axis=1)
    C = cat_lo.shape[1]
    pw = 1
    while pw < C:
        pw *= 2
    if pw != C:
        z = xp.zeros((n, pw - C), xp.uint32)
        cat_lo = xp.concatenate([cat_lo, z], axis=1)
        cat_hi = xp.concatenate([cat_hi, z], axis=1)
    cur = (cat_lo, cat_hi)
    while pw > 1:
        h = pw // 2
        cur = G.add((cur[0][:, :h], cur[1][:, :h]),
                    (cur[0][:, h:], cur[1][:, h:]))
        pw = h
    return cur[0][:, 0], cur[1][:, 0]


def ext_combo_columns(G, E, is_jax, mat, alphas_dev):
    """sum_j alpha_j * col_j for base columns and ext scalars alphas
    (alphas_dev: 4 arrays (C,): lo/hi of re/im)."""
    lo, hi = mat
    n, C = lo.shape
    alr, ahr, ali, ahi_ = alphas_dev
    if not is_jax:
        acc = None
        for j in range(C):
            colv = (lo[:, j], hi[:, j])
            t = (G.mul(colv, (alr[j:j + 1], ahr[j:j + 1])),
                 G.mul(colv, (ali[j:j + 1], ahi_[j:j + 1])))
            acc = t if acc is None else E.add(acc, t)
        return acc
    from jax import lax

    def body(acc, xs):
        l, h, a0, a1, a2, a3 = xs
        colv = (l, h)
        t = (G.mul(colv, (a0.reshape(1), a1.reshape(1))),
             G.mul(colv, (a2.reshape(1), a3.reshape(1))))
        return E.add(acc, t), None

    z = G.xp.zeros((n,), G.xp.uint32)
    acc, _ = lax.scan(body, ((z, z), (z, z)), (lo.T, hi.T, alr, ahr, ali, ahi_))
    return acc


def _ecol(mlo, mhi, t):
    """Ext column t of an interleaved (n, 2*Cext) base matrix."""
    return ((mlo[:, 2 * t], mhi[:, 2 * t]),
            (mlo[:, 2 * t + 1], mhi[:, 2 * t + 1]))


# ---------------------------------------------------------------------------
# Phase bodies: pure traceable functions over device tensors.  Shared between
# the per-phase jits below and the fully fused single-program prover
# (prover/fused.py) so both paths stay bit-identical by construction.


def round2_body(pk, wires_full, sig, xh, kdev, tbl, qlk,
                beta_d, gamma_d, lam_d):
    """Round-2 committed columns from the wires matrix.

    wires_full: (n, W [+1]) pair (multiplicity column last with lookups);
    sig: (n, W) sigma pair; xh: (n,) domain pair; kdev: (W,) coset shifts;
    tbl/qlk: (n,) pairs (zeros when no lookups); challenges as broadcastable
    ext scalars.  Returns the (n, 2*num_z_ext) interleaved base pair."""
    G, E = pk.G, pk.E
    xp = G.xp
    W = pk.W
    groups = pk.perm_groups
    lk_groups = pk.lk_groups
    has_lk = pk.has_lookups
    log_n = pk.compiled.log_n
    is_jax = pk.is_jax
    wlo, whi = wires_full
    wires = (wlo[:, :W], whi[:, :W])
    K = len(groups)
    nums, dens = perm_group_products(
        G, E, wires, sig, xh, kdev, beta_d, gamma_d, groups)  # (n, K) each
    num = _fold_cols(xp, E.mul, nums, _EXT_ONE_NEUTRAL)
    den = _fold_cols(xp, E.mul, dens, _EXT_ONE_NEUTRAL)
    ratio = E.mul(num, E.inv(den))
    z = pk.exclusive_prefix_product(ratio)
    ecols = [z]
    if K > 1:
        # partial products B_t = z * (prod_{i<=t} N_i) / (prod_{i<=t} D_i)
        # for t < K-1, all columns at once (inclusive scans + one stacked
        # inverse; inverses are unique so values match any method)
        cum_n = _axis_incl_scan(E, nums, E.mul, _EXT_ONE_NEUTRAL)
        cum_d = _axis_incl_scan(E, dens, E.mul, _EXT_ONE_NEUTRAL)
        cn = _slice_cols(cum_n, slice(0, K - 1))
        cd = _slice_cols(cum_d, slice(0, K - 1))
        b = E.mul(_bcast_cols(z), E.mul(cn, E.inv(cd)))
        ecols.extend(_col_ext(b, t) for t in range(K - 1))
    if has_lk:
        tlo, thi = tbl
        hs = lookup_helper_terms(G, E, wires, lam_d, qlk, lk_groups,
                                 is_jax=pk.is_jax)  # (n, nh) stacked
        tz = xp.zeros_like(tlo)
        h_t = E.inv(E.sub(lam_d, ((tlo, thi), (tz, tz))))
        mcol = (wlo[:, W], whi[:, W])
        mh = (G.mul(h_t[0], mcol), G.mul(h_t[1], mcol))
        delta = _fold_cols(xp, E.add, hs, _EXT_ZERO_NEUTRAL)
        delta = E.sub(delta, mh)
        s_col = pk.exclusive_prefix_sum(delta)
        ecols.extend(_col_ext(hs, t) for t in range(len(lk_groups)))
        ecols.append(h_t)
        ecols.append(s_col)
    lo = xp.stack([c for e in ecols for c in (e[0][0], e[1][0])], axis=1)
    hi = xp.stack([c for e in ecols for c in (e[0][1], e[1][1])], axis=1)
    return lo, hi


def quotient_rows_body(pk, const_c, wires_full_c, z_c, zg_c, pi_c, x_c,
                       kdev, zh_inv_c, zh_c, beta_d, gamma_d, lam_d,
                       alphas4):
    """alpha-combined constraints * Z_H^{-1} on a contiguous slice of LDE
    rows -> the t(x) value slice (ext pair).

    Purely elementwise over rows: the only cross-row dependence (the g*x
    shift of Z and of the LogUp running sum S) enters via zg_c, the z
    matrix pre-gathered at rows (row + rate) mod m.  This is what makes
    the quotient row-CHUNKABLE, so quotient_body can bound its live
    temporaries by running this body over row chunks."""
    G, E = pk.G, pk.E
    xp = G.xp
    n = pk.n
    W = pk.W
    groups = pk.perm_groups
    lk_groups = pk.lk_groups
    has_lk = pk.has_lookups
    clo, chi = const_c
    wlo, whi = wires_full_c
    zlo, zhi = z_c
    zglo, zghi = zg_c
    rows = clo.shape[0]
    alr, ahr, ali, ahi_ = alphas4

    def col(mlo, mhi, j):
        return (mlo[:, j], mhi[:, j])

    def base_to_ext(bval):
        zz = xp.zeros_like(bval[0])
        return (bval, (zz, zz))

    def a_mul(i, cval):
        ai = ((alr[i].reshape(1), ahr[i].reshape(1)),
              (ali[i].reshape(1), ahi_[i].reshape(1)))
        return E.mul(ai, cval)

    wires = (wlo[:, :W], whi[:, :W])
    gate = gate_eval(G, (clo[:, :NUM_SELECTORS], chi[:, :NUM_SELECTORS]),
                     wires)
    gate = G.add(gate, (pi_c[0][:, 0], pi_c[1][:, 0]))
    # accumulate alpha^i * c_i as a list and tree-sum at the end (shallow
    # fusion depth — see tree_fold)
    terms = [base_to_ext(gate)]

    z_ext = _ecol(zlo, zhi, 0)
    zg_ext = _ecol(zglo, zghi, 0)

    x_minus_1 = G.sub(x_c, G.const(1, (rows,)))
    l1 = G.mul(zh_c, G.inv(G.mul_const(x_minus_1, n)))
    one_c = G.const(1, (1,))
    zm1 = (G.sub(z_ext[0], one_c), z_ext[1])
    terms.append(a_mul(1, (G.mul(l1, zm1[0]), G.mul(l1, zm1[1]))))

    sig = (clo[:, NUM_SELECTORS:NUM_SELECTORS + W],
           chi[:, NUM_SELECTORS:NUM_SELECTORS + W])
    nums, dens = perm_group_products(
        G, E, wires, sig, x_c, kdev, beta_d, gamma_d, groups)  # (rows, K)
    K = len(groups)

    def zcols_ext(mlo, mhi, lo_c, hi_c):
        """Stacked ext columns [lo_c, hi_c) of an interleaved base matrix."""
        return ((mlo[:, 2 * lo_c:2 * hi_c:2], mhi[:, 2 * lo_c:2 * hi_c:2]),
                (mlo[:, 2 * lo_c + 1:2 * hi_c:2],
                 mhi[:, 2 * lo_c + 1:2 * hi_c:2]))

    def a_mul_st(lo_i, hi_i, tens):
        """alpha^[lo_i, hi_i) * stacked columns, summed -> one (rows,) ext
        term (exact field ops: any summation order is bit-identical)."""
        a = ((alr[None, lo_i:hi_i], ahr[None, lo_i:hi_i]),
             (ali[None, lo_i:hi_i], ahi_[None, lo_i:hi_i]))
        return _fold_cols(xp, E.add, E.mul(a, tens), _EXT_ZERO_NEUTRAL)

    def cat_cols(t1, t2):
        return tuple(tuple(xp.concatenate([c1, c2], axis=1)
                           for c1, c2 in zip(comp1, comp2))
                     for comp1, comp2 in zip(t1, t2))

    # permutation chain constraints, all K at once:
    #   c_t = chain[t] * N_t - chain[t+1] * D_t,
    #   chain = [Z, B_1..B_{K-1}, Z(gx)]
    zb = zcols_ext(zlo, zhi, 0, K)                      # [Z, B_1..B_{K-1}]
    zgb = ((zglo[:, 0:1], zghi[:, 0:1]), (zglo[:, 1:2], zghi[:, 1:2]))
    chain_hi = cat_cols(_slice_cols(zb, slice(1, K)), zgb)  # chain[1..K]
    c_perm = E.sub(E.mul(zb, nums), E.mul(chain_hi, dens))  # (rows, K)
    terms.append(a_mul_st(2, 2 + K, c_perm))

    if has_lk:
        qlk = col(clo, chi, SEL_QLK)
        tcol = col(clo, chi, NUM_SELECTORS + W)
        mcol = col(wlo, whi, W)
        nh = len(lk_groups)
        base_i = 2 + K
        # matrix-form LogUp constraint: per-group full products and
        # all-but-one sums via exclusive prefix x suffix products —
        # O(log) matrix ops for all groups at once
        fmat = lookup_fac_matrix(G, E, wires, lam_d)
        idxd, maskd, gp = _group_gather(G, lk_groups, W)
        tens = _group_tensor(G, fmat, idxd, maskd, _EXT_ONE_NEUTRAL)
        prods = _fold_last_axis(E.mul, tens)           # (rows, nh)
        pre = _axis_excl_products(E, tens)
        suf = _axis_excl_products(E, tens, reverse=True)
        allbut = E.mul(pre, suf)                       # (rows, nh, gp)
        ab0 = tuple(tuple(xp.where(maskd, c, xp.uint32(0)) for c in comp)
                    for comp in allbut)
        rhs_all = _fold_last_axis(E.add, ab0)          # (rows, nh)
        # c_h = h_g * prod_g - qLK * allbut_sum_g, all nh at once
        h_st = zcols_ext(zlo, zhi, K, K + nh)
        qb = (qlk[0][:, None], qlk[1][:, None])
        rhs_s = (G.mul(rhs_all[0], qb), G.mul(rhs_all[1], qb))
        c_h = E.sub(E.mul(h_st, prods), rhs_s)
        terms.append(a_mul_st(base_i, base_i + nh, c_h))
        h_t = _ecol(zlo, zhi, K + nh)
        c_ht = E.sub(E.mul(h_t, E.sub(lam_d, base_to_ext(tcol))),
                     _ext_ones(xp, rows))
        terms.append(a_mul(base_i + nh, c_ht))
        s_ext = _ecol(zlo, zhi, K + nh + 1)
        sg_ext = _ecol(zglo, zghi, K + nh + 1)
        hsum = _fold_cols(xp, E.add, h_st, _EXT_ZERO_NEUTRAL)
        mh = (G.mul(h_t[0], mcol), G.mul(h_t[1], mcol))
        c_s = E.add(E.sub(E.sub(sg_ext, s_ext), hsum), mh)
        terms.append(a_mul(base_i + nh + 1, c_s))
        c_l1s = (G.mul(l1, s_ext[0]), G.mul(l1, s_ext[1]))
        terms.append(a_mul(base_i + nh + 2, c_l1s))

    c_all = tree_fold(E.add, terms)
    return (G.mul(c_all[0], zh_inv_c), G.mul(c_all[1], zh_inv_c))


def quotient_finish_body(pk, t_lde):
    """Full-domain t(x) values -> quotient coefficient columns (coset INTT
    + NUM_CHUNKS column split)."""
    G = pk.G
    xp = G.xp
    n = pk.n
    nch = pk.num_chunks
    t_re = coset_intt(G, t_lde[0])
    t_im = coset_intt(G, t_lde[1])
    q_lo = xp.stack(
        [t_re[0][k * n:(k + 1) * n, 0] for k in range(nch)] +
        [t_im[0][k * n:(k + 1) * n, 0] for k in range(nch)], axis=1)
    q_hi = xp.stack(
        [t_re[1][k * n:(k + 1) * n, 0] for k in range(nch)] +
        [t_im[1][k * n:(k + 1) * n, 0] for k in range(nch)], axis=1)
    return q_lo, q_hi


def quotient_pi_lde_body(pk, pi_pair):
    """(n,) -PI values on H -> (m, 1) coset LDE pair."""
    G = pk.G
    n = pk.n
    return coset_lde(G, intt(G, (pi_pair[0].reshape(n, 1),
                                 pi_pair[1].reshape(n, 1))),
                     pk.config.rate_bits)


def quotient_chunk_rows(pk) -> int:
    """Row-chunk size for the quotient evaluation (env-overridable).
    Rounded down to a power of two so it always divides the (power-of-two)
    LDE domain / local shard block.  With 2^21-row chunks the per-phase
    prove of a 2^20-row trace (2^23-row LDE, 4 chunks) peaked at 13.1 GB on
    an H100 80GB (700 W; PERF.md)."""
    chunk = int(os.environ.get("TPU_ACIR_QUOTIENT_CHUNK", str(1 << 21)))
    assert chunk > 0, "TPU_ACIR_QUOTIENT_CHUNK must be positive"
    return 1 << (chunk.bit_length() - 1)


def quotient_body(pk, const_lde, wires_lde_full, z_lde, pi_pair,
                  x_lde, kdev, zh_inv, zh,
                  beta_d, gamma_d, lam_d, alphas4):
    """Quotient evaluation over the full LDE domain (one traced program —
    used by both the per-phase and the fused prover).  pi_pair: (n,) base
    pair of -PI values on H; alphas4: 4 arrays (ncons,) of the
    constraint-combination ext powers.

    When the domain is larger than one chunk (quotient_chunk_rows) the
    row evaluation runs as an IN-GRAPH lax.map over contiguous row chunks,
    which bounds the live temporaries at O(chunk * live-vectors) and
    computes bit-identical values (every constraint is row-elementwise;
    the g*x shift of Z/S enters via a pre-gathered chunk of Z at rows
    (row + rate) mod m)."""
    xp = pk.G.xp
    m = pk.m
    rate = pk.config.rate
    pi_lde = quotient_pi_lde_body(pk, pi_pair)
    chunk = quotient_chunk_rows(pk)
    if not pk.is_jax or m <= chunk:
        zg = (xp.roll(z_lde[0], -rate, axis=0),
              xp.roll(z_lde[1], -rate, axis=0))
        t_lde = quotient_rows_body(pk, const_lde, wires_lde_full, z_lde, zg,
                                   pi_lde, x_lde, kdev, zh_inv, zh,
                                   beta_d, gamma_d, lam_d, alphas4)
        return quotient_finish_body(pk, t_lde)

    from jax import lax
    assert m % chunk == 0, \
        f"quotient chunk {chunk} must divide the LDE size {m}"
    # z wrapped by `rate` rows so every chunk's g*x shift is one contiguous
    # dynamic slice (zpad[i] == z[i mod m] for i < m + rate)
    zpad = (xp.concatenate([z_lde[0], z_lde[0][:rate]]),
            xp.concatenate([z_lde[1], z_lde[1][:rate]]))

    def chunk_fn(start):
        def sl(a):
            return lax.dynamic_slice_in_dim(a, start, chunk, 0)

        def slz(a):
            return lax.dynamic_slice_in_dim(a, start + rate, chunk, 0)

        return quotient_rows_body(
            pk, (sl(const_lde[0]), sl(const_lde[1])),
            (sl(wires_lde_full[0]), sl(wires_lde_full[1])),
            (sl(z_lde[0]), sl(z_lde[1])), (slz(zpad[0]), slz(zpad[1])),
            (sl(pi_lde[0]), sl(pi_lde[1])), (sl(x_lde[0]), sl(x_lde[1])),
            kdev, (sl(zh_inv[0]), sl(zh_inv[1])), (sl(zh[0]), sl(zh[1])),
            beta_d, gamma_d, lam_d, alphas4)

    starts = xp.arange(0, m, chunk, dtype=xp.int32)
    parts = lax.map(chunk_fn, starts)  # ((nch,chunk) lo, hi) re/im pairs
    t_lde = ((parts[0][0].reshape(m), parts[0][1].reshape(m)),
             (parts[1][0].reshape(m), parts[1][1].reshape(m)))
    return quotient_finish_body(pk, t_lde)


def open_body(pk, coeffs, pow_re, pow_im):
    """Evaluate all columns of a coeff matrix at an ext point given its
    (n,) power-table pairs.  Returns ((C,) re pair, (C,) im pair)."""
    G = pk.G
    re = G.mul(coeffs, (pow_re[0].reshape(-1, 1), pow_re[1].reshape(-1, 1)))
    im = G.mul(coeffs, (pow_im[0].reshape(-1, 1), pow_im[1].reshape(-1, 1)))
    return sum_rows(G, re), sum_rows(G, im)


def fri_combine_body(pk, lde_list, z_lde, x_lde, alphas4,
                     y1_d, y2_d, zeta_d, gzeta_d):
    """F(x) = sum_i a_i (p_i(x) - y_i)/(x - zeta) + the g*zeta group.

    lde_list: per-oracle (m, C) pairs; alphas4: 4 arrays (ncols + zcols,);
    challenges/openings as broadcastable ext scalars."""
    G, E = pk.G, pk.E
    m = int(x_lde[0].shape[0])  # local row count (global m single-chip)
    is_jax = pk.is_jax
    ncols = sum(p[0].shape[1] for p in lde_list)

    alr, ahr, ali, ahi_ = alphas4

    def combo(mlo, mhi, base):
        c = mlo.shape[1]
        sl = slice(base, base + c)
        return ext_combo_columns(G, E, is_jax, (mlo, mhi),
                                 (alr[sl], ahr[sl], ali[sl], ahi_[sl]))

    acc1 = None
    base = 0
    for (mlo, mhi) in lde_list:
        t = combo(mlo, mhi, base)
        acc1 = t if acc1 is None else E.add(acc1, t)
        base += mlo.shape[1]
    acc1 = E.sub(acc1, y1_d)
    xmz = (G.sub(x_lde, zeta_d[0]),
           G.neg((G.xp.broadcast_to(zeta_d[1][0], (m,)),
                  G.xp.broadcast_to(zeta_d[1][1], (m,)))))
    F1 = E.mul(acc1, E.inv(xmz))
    acc2 = combo(z_lde[0], z_lde[1], ncols)
    acc2 = E.sub(acc2, y2_d)
    xmgz = (G.sub(x_lde, gzeta_d[0]),
            G.neg((G.xp.broadcast_to(gzeta_d[1][0], (m,)),
                   G.xp.broadcast_to(gzeta_d[1][1], (m,)))))
    F2 = E.mul(acc2, E.inv(xmgz))
    return E.add(F1, F2)


def fri_fold_body(pk, values_ext, inv2x, beta_d):
    """One FRI fold: (size,) ext values -> (size/2,) ext values."""
    G, E = pk.G, pk.E
    h = int(values_ext[0][0].shape[0]) // 2
    v0 = ((values_ext[0][0][:h], values_ext[0][1][:h]),
          (values_ext[1][0][:h], values_ext[1][1][:h]))
    v1 = ((values_ext[0][0][h:], values_ext[0][1][h:]),
          (values_ext[1][0][h:], values_ext[1][1][h:]))
    s = E.add(v0, v1)
    d = E.sub(v0, v1)
    half = G.const(_HALF, (1,))
    return E.add(E.mul_base(s, half),
                 E.mul(beta_d, E.mul_base(d, inv2x)))


class ProvingKey:
    """Device-resident preprocessed data + jitted phase programs for one
    compiled circuit — the analog of plonky2 ProverCircuitData, built ONCE
    and reused across prove calls (the reference re-translates per command,
    prove_action.rs:18-19)."""

    def __init__(self, compiled: CompiledCircuit, config: ProofConfig = STANDARD_CONFIG,
                 xp=None):
        self.compiled = compiled
        self.config = config
        if xp is None:
            xp = _default_xp()
        elif "jax" in getattr(xp, "__name__", ""):
            # explicit-xp construction (e.g. ShardedProvingKey) must still
            # get the persistent compile cache (sharded phase programs cost
            # minutes to partition cold) and the CPU u64 field path
            from ..utils.jaxcfg import setup_jax
            setup_jax()
        self.G = make_gl(xp)
        self.E = make_ext(self.G)
        self.H = make_poseidon(self.G)
        self.is_jax = "jax" in getattr(xp, "__name__", "")
        self._jits = {}
        n = compiled.n
        self.n = n
        self.m = n << config.rate_bits
        self.num_chunks = NUM_CHUNKS
        W = len(compiled.k_shifts)
        self.W = W
        self.has_lookups = compiled.lookup_bits > 0
        self.perm_groups = perm_groups(W)
        self.lk_groups = lookup_groups(W) if self.has_lookups else []
        self.K = len(self.perm_groups)
        self.nh = len(self.lk_groups)
        # z-oracle ext columns: [Z, B_1..B_{K-1}, (h_1..h_nh, h_T, S)]
        self.num_z_ext = self.K + ((self.nh + 2) if self.has_lookups else 0)

        G = self.G
        # preprocessed oracle: [selectors, sigma_0..sigma_{W-1}, table?]
        cols = [compiled.selectors, compiled.sigma]
        if self.has_lookups:
            cols.append(compiled.table.reshape(1, n))
        pre = np.concatenate(cols, axis=0).T
        pre_dev = self.place(_mat_to_dev(G, pre))
        self.constants_oracle = self.commit(pre_dev)

        # domain tables
        self.omega = _gl.root_of_unity(compiled.log_n)
        log_m = self.m.bit_length() - 1
        omega_m = _gl.root_of_unity(log_m)
        g = _gl.MULTIPLICATIVE_GENERATOR
        self.x_lde = self.place(_to_dev(G, _mul_u64(powers_u64(omega_m, self.m), g)))
        self.x_h = self.place(_to_dev(G, powers_u64(self.omega, n)))
        rate = config.rate
        gn = pow(g, n, P)
        wn = pow(omega_m, n, P)
        zh = [(gn * pow(wn, i, P) - 1) % P for i in range(rate)]
        zh_inv = np.tile(np.array([_gl.s_inv(v) for v in zh], dtype=np.uint64),
                         self.m // rate)
        self.zh_inv_lde = self.place(_to_dev(G, zh_inv))
        self.zh_lde = self.place(_to_dev(G, np.tile(np.array(zh, dtype=np.uint64),
                                                    self.m // rate)))
        self.sigma_dev = self.place(_mat_to_dev(G, compiled.sigma.T))
        self.k_dev = _to_dev(G, np.array(compiled.k_shifts, dtype=np.uint64))
        # (W, n) wire routing table, device-resident: lets the fused prover
        # gather the wires matrix on device from the ~n-value solved vector
        # (17x smaller host->device transfer than the full wires matrix)
        self.wire_idx_dev = G.xp.asarray(
            compiled.wire_vars.astype(np.int32))
        if self.has_lookups:
            self.table_dev = self.place(_to_dev(G, compiled.table))
            self.qlk_dev = self.place(_to_dev(G, compiled.selectors[SEL_QLK]))
        self.num_constraints = 2 + self.K + \
            ((self.nh + 3) if self.has_lookups else 0)

        self.vk = VerifyingKey(
            log_n=compiled.log_n, num_wires=W,
            num_public_inputs=compiled.num_public_inputs,
            k_shifts=compiled.k_shifts, num_quotient_chunks=self.num_chunks,
            rate_bits=config.rate_bits, cap_height=config.cap_height,
            num_queries=config.num_queries, pow_bits=config.pow_bits,
            # tiny traces: never fold below the LDE itself
            final_poly_domain=min(config.final_poly_domain, self.m),
            lookup_bits=compiled.lookup_bits,
            constants_cap=[tuple(int(x) for x in d)
                           for d in self.constants_oracle.tree.cap_u64()],
        )

    # ---- prefix-scan hooks --------------------------------------------------
    # round2_body routes its two cross-row scans (the exclusive prefix
    # product defining Z and the LogUp running-sum S) through these so the
    # sharded ProvingKey can substitute a shard_map implementation (local
    # scan + one all_gather of per-shard totals): the Hillis-Steele
    # fori_loop's dynamic-shift rolls are fine single-chip but take GSPMD's
    # partitioner minutes to compile (measured 4+ min at n=16 on 8 shards).

    def exclusive_prefix_product(self, ratio):
        xp = self.G.xp
        acc = prefix_product_ext(self.G, self.E, self.is_jax, ratio,
                                 self.compiled.log_n)
        return (_shift_one(xp, acc[0], fill_one=True), _shift_one(xp, acc[1]))

    def exclusive_prefix_sum(self, vals):
        xp = self.G.xp
        acc = prefix_sum_ext(self.G, self.E, self.is_jax, vals,
                             self.compiled.log_n)
        return (_shift_one(xp, acc[0]), _shift_one(xp, acc[1]))

    # ---- device placement hook ---------------------------------------------

    def place(self, pair):
        """Placement hook for domain-axis tensors ((n,)/(m,)/(n, C) (lo, hi)
        pairs).  Identity here; parallel.prove.ShardedProvingKey overrides it
        to shard axis 0 over a device mesh, so every phase jit compiles as an
        SPMD program over the mesh (computation follows data)."""
        return pair

    # ---- jit cache --------------------------------------------------------

    def jit(self, key, fn):
        """Memoize a jitted phase program (identity fn on numpy backend)."""
        if not self.is_jax:
            return fn
        if key not in self._jits:
            import jax
            self._jits[key] = jax.jit(fn)
        return self._jits[key]

    # ---- phase programs -----------------------------------------------------

    def build_wires(self, vals: np.ndarray, mcol=None):
        """Solved variable vector -> (n, W[+1]) device wires pair.

        jax path: ship the ~n-element value vector and gather the wires
        matrix ON DEVICE through the resident (W, n) routing table — a 17x
        smaller host->device transfer than the full wires matrix."""
        G = self.G
        n = self.n
        if not self.is_jax:
            wires_mat = self.compiled.wire_values(vals)
            if mcol is not None:
                w = np.concatenate([wires_mat, mcol.reshape(1, n)],
                                   axis=0).T
            else:
                w = wires_mat.T
            return self.place(_mat_to_dev(G, w))

        def run(vlo, vhi, widx, *m):
            xp = G.xp
            wlo = xp.take(vlo, widx, axis=0).T
            whi = xp.take(vhi, widx, axis=0).T
            if m:
                wlo = xp.concatenate([wlo, m[0][:, None]], axis=1)
                whi = xp.concatenate([whi, m[1][:, None]], axis=1)
            return wlo, whi

        args = _mat_to_dev(G, np.ascontiguousarray(vals))
        if mcol is not None:
            args = (*args, self.wire_idx_dev, *_mat_to_dev(G, mcol))
        else:
            args = (*args, self.wire_idx_dev)
        out = self.jit(("build_wires", mcol is not None, vals.shape[0]),
                       run)(*args)
        return self.place(tuple(out))

    def commit(self, values_dev, from_coeffs: bool = False) -> Oracle:
        """INTT + coset LDE + leaf hash + EVERY Merkle level as ONE jitted
        program, instead of ~20 device launches (one per level) per
        tree."""
        G, H = self.G, self.H
        rate_bits, cap_height = self.config.rate_bits, self.config.cap_height

        def run(lo, hi):
            coeffs = (lo, hi) if from_coeffs else intt(G, (lo, hi))
            lde = coset_lde(G, coeffs, rate_bits)
            levels = self.merkle_levels_graph(lde)
            flat = [c for lev in levels for c in lev]
            return (*coeffs, *lde, *flat)

        shape = tuple(values_dev[0].shape)
        out = self.jit(("commit", from_coeffs, shape), run)(*values_dev)
        coeffs = (out[0], out[1])
        lde = (out[2], out[3])
        levels = [(out[4 + 2 * i], out[5 + 2 * i])
                  for i in range((len(out) - 4) // 2)]
        tree = MerkleTree(G, lde[0], lde[1], levels,
                          min(cap_height, int(lde[0].shape[0]).bit_length() - 1))
        return Oracle(coeffs, lde, tree)

    def merkle_levels_graph(self, matrix):
        """All Merkle levels of an (M, C) matrix pair, in-graph (traced).
        Rolled heap-loop build (merkle.merkle_levels): two traced
        two_to_one bodies per tree instead of log2(M)."""
        from .merkle import leaf_digests, merkle_levels
        H = self.H
        cap_height = self.config.cap_height
        m, c = matrix[0].shape
        ch = min(cap_height, int(m).bit_length() - 1)
        leaf = leaf_digests(H, matrix)
        return merkle_levels(H, leaf, 1 << ch)

    def round2_phase(self, wires_dev, beta, gamma, lam):
        """Round-2 committed columns: permutation grand product Z, partial
        products B_j, and (with lookups) LogUp helpers h_g, h_T and the
        running sum S.  Returns an (n, 2*num_z_ext) base matrix pair.

        wires_dev: (n, W [+1]) pair — the wires oracle values (m column
        last when lookups are on)."""
        G, E = self.G, self.E
        n = self.n
        W = self.W
        xp = G.xp
        is_jax = self.is_jax
        groups = self.perm_groups
        lk_groups = self.lk_groups
        has_lk = self.has_lookups
        log_n = self.compiled.log_n

        def run(wlo, whi, slo, shi, xlo, xhi, klo, khi,
                tlo, thi, qlklo, qlkhi,
                b0, b1, b2, b3, g0, g1, g2, g3, l0, l1, l2, l3):
            beta_d = _ext_scal(G, b0, b1, b2, b3)
            gamma_d = _ext_scal(G, g0, g1, g2, g3)
            lam_d = _ext_scal(G, l0, l1, l2, l3)
            return round2_body(self, (wlo, whi), (slo, shi), (xlo, xhi),
                               (klo, khi), (tlo, thi), (qlklo, qlkhi),
                               beta_d, gamma_d, lam_d)

        if has_lk:
            tdev, qdev = self.table_dev, self.qlk_dev
        else:
            z = self.G.xp.zeros((n,), self.G.xp.uint32)
            tdev, qdev = (z, z), (z, z)
        lam = lam or (0, 0)
        args = (*wires_dev, *self.sigma_dev, *self.x_h, *self.k_dev,
                *tdev, *qdev,
                *_ext_arg(beta), *_ext_arg(gamma), *_ext_arg(lam))
        return self.jit(("round2",), run)(*args)

    def quotient_phase(self, wires_lde, z_lde, pi_vals, beta, gamma, lam,
                       alpha):
        """alpha-combined constraints / Z_H -> quotient coeff columns."""
        G, E = self.G, self.E
        cc = self.compiled
        n, m = self.n, self.m
        W = self.W
        nch = self.num_chunks
        rate = self.config.rate
        xp = G.xp
        rate_bits = self.config.rate_bits
        const_lde = self.constants_oracle.lde
        groups = self.perm_groups
        lk_groups = self.lk_groups
        has_lk = self.has_lookups
        is_jax = self.is_jax
        ncons = self.num_constraints
        alphas = [e_pow(alpha, i) for i in range(ncons)]
        al = np.array([a[0] & 0xFFFFFFFF for a in alphas], np.uint32)
        ah = np.array([a[0] >> 32 for a in alphas], np.uint32)
        il = np.array([a[1] & 0xFFFFFFFF for a in alphas], np.uint32)
        ih = np.array([a[1] >> 32 for a in alphas], np.uint32)

        lam = lam or (0, 0)
        pi_dev = _mat_to_dev(G, pi_vals.reshape(n, 1))
        al4 = (G.xp.asarray(al), G.xp.asarray(ah),
               G.xp.asarray(il), G.xp.asarray(ih))

        def run(clo, chi, wlo, whi, zlo, zhi, pilo, pihi, xlo, xhi,
                klo, khi, zhilo, zhihi, zhlo, zhhi,
                b0, b1, b2, b3, g0, g1, g2, g3, la0, la1, la2, la3,
                alr, ahr, ali, ahi_):
            beta_d = _ext_scal(G, b0, b1, b2, b3)
            gamma_d = _ext_scal(G, g0, g1, g2, g3)
            lam_d = _ext_scal(G, la0, la1, la2, la3)
            return quotient_body(self, (clo, chi), (wlo, whi),
                                 (zlo, zhi),
                                 (pilo, pihi), (xlo, xhi), (klo, khi),
                                 (zhilo, zhihi), (zhlo, zhhi),
                                 beta_d, gamma_d, lam_d,
                                 (alr, ahr, ali, ahi_))

        args = (*const_lde, *wires_lde, *z_lde,
                pi_dev[0].reshape(n), pi_dev[1].reshape(n),
                *self.x_lde, *self.k_dev, *self.zh_inv_lde, *self.zh_lde,
                *_ext_arg(beta), *_ext_arg(gamma), *_ext_arg(lam),
                *al4)
        return self.jit(("quotient", quotient_chunk_rows(self)), run)(*args)

    def ext_power_table(self, z, n):
        """[z^0 .. z^(n-1)] for an ext scalar z as device (re, im) pairs,
        computed IN-GRAPH by log-doubling on the jax backend, instead of a
        host-side table build and its ~32 MB upload per opening point at
        2^20 rows."""
        G = self.G
        if not self.is_jax:
            pw = ext_powers_u64(z, n)
            return (self.place(_to_dev(G, pw[0])),
                    self.place(_to_dev(G, pw[1])))
        from .fused import ext_powers_table

        def run(a0, a1, a2, a3):
            return ext_powers_table(G, self.E, ((a0, a1), (a2, a3)), n)

        re, im = self.jit(("ext_powers", n), run)(*_ext_arg(z))
        return (self.place(re), self.place(im))

    def open_at(self, oracle: Oracle, pows):
        """Evaluate all columns of an oracle at an ext point given its power
        table (re, im) device pairs."""
        G = self.G

        def run(lo, hi, prl, prh, pil, pih):
            return open_body(self, (lo, hi), (prl, prh), (pil, pih))

        shape = tuple(oracle.coeffs[0].shape)
        (re, im) = self.jit(("open", shape), run)(*oracle.coeffs, *pows[0],
                                                  *pows[1])
        re64 = _from_dev_u64(G, re)
        im64 = _from_dev_u64(G, im)
        return [(int(a), int(b)) for a, b in zip(re64, im64)]

    def fri_combine(self, lde_list, alphas, y1, y2, zeta, gzeta, z_lde):
        """F(x) = sum_i a_i (p_i - y_i)/(x - zeta) + gz terms, on the LDE.

        lde_list: per-oracle (lo, hi) matrix pairs — accumulated one oracle
        at a time so no concatenated copy of every LDE is materialized
        (at 2^20 rows that copy alone would be several GB of device memory)."""
        G, E = self.G, self.E
        m = self.m
        widths = [p[0].shape[1] for p in lde_list]
        ncols = sum(widths)
        a_lo_re = np.array([a[0] & 0xFFFFFFFF for a in alphas], np.uint32)
        a_hi_re = np.array([a[0] >> 32 for a in alphas], np.uint32)
        a_lo_im = np.array([a[1] & 0xFFFFFFFF for a in alphas], np.uint32)
        a_hi_im = np.array([a[1] >> 32 for a in alphas], np.uint32)

        is_jax = self.is_jax
        n_oracles = len(lde_list)

        def run(*args):
            mats = [(args[2 * i], args[2 * i + 1]) for i in range(n_oracles)]
            (zlo, zhi, xlo, xhi, alr, ahr, ali, ahi_,
             y1r0, y1r1, y1i0, y1i1, y2r0, y2r1, y2i0, y2i1,
             ze0, ze1, ze2, ze3, gz0, gz1, gz2, gz3) = args[2 * n_oracles:]
            y1d = ((_scal(G, y1r0), _scal(G, y1r1)), (_scal(G, y1i0), _scal(G, y1i1)))
            y2d = ((_scal(G, y2r0), _scal(G, y2r1)), (_scal(G, y2i0), _scal(G, y2i1)))
            zeta_d = ((_scal(G, ze0), _scal(G, ze1)), (_scal(G, ze2), _scal(G, ze3)))
            gz_d = ((_scal(G, gz0), _scal(G, gz1)), (_scal(G, gz2), _scal(G, gz3)))
            return fri_combine_body(self, mats, (zlo, zhi), (xlo, xhi),
                                    (alr, ahr, ali, ahi_),
                                    y1d, y2d, zeta_d, gz_d)

        xp = G.xp

        def u32(v):
            return np.uint32(v)

        y1a = (u32(y1[0] & 0xFFFFFFFF), u32(y1[0] >> 32),
               u32(y1[1] & 0xFFFFFFFF), u32(y1[1] >> 32))
        y2a = (u32(y2[0] & 0xFFFFFFFF), u32(y2[0] >> 32),
               u32(y2[1] & 0xFFFFFFFF), u32(y2[1] >> 32))
        flat = []
        for p in lde_list:
            flat.extend(p)
        return self.jit(("fri_combine", tuple(widths)), run)(
            *flat, *z_lde, *self.x_lde,
            xp.asarray(a_lo_re), xp.asarray(a_hi_re),
            xp.asarray(a_lo_im), xp.asarray(a_hi_im),
            *y1a, *y2a, *_ext_arg(zeta), *_ext_arg(gzeta))

    def fri_fold(self, values_ext, beta, shift: int):
        """One FRI fold layer.  inv2x[j] = 1/(2*shift*w^j) is computed
        IN-GRAPH by log-doubling (ntt.device_powers), instead of a
        host-side table build and its ~32 MB upload per layer at 2^20
        rows."""
        G, E = self.G, self.E
        size = int(values_ext[0][0].shape[0])
        h = size // 2
        from .ntt import device_powers
        w_inv = _gl.s_inv(_gl.root_of_unity(size.bit_length() - 1))
        base = _gl.s_inv((2 * shift) % P)

        def run(rl, rh, il, ih, b0, b1, b2, b3):
            beta_d = ((_scal(G, b0), _scal(G, b1)), (_scal(G, b2), _scal(G, b3)))
            if self.is_jax:
                pw = device_powers(G, w_inv, h)
                bc = G.const(base)
                inv2x = G.mul(pw, (bc[0].reshape(1), bc[1].reshape(1)))
            else:
                inv2x = G.from_u64(_mul_u64(powers_u64(w_inv, h), base))
            return fri_fold_body(self, ((rl, rh), (il, ih)), inv2x, beta_d)

        return self.jit(("fri_fold", h, shift), run)(
            *values_ext[0], *values_ext[1], *_ext_arg(beta))

    def grind(self, challenger, pow_bits: int, batch: int = 1 << 17) -> int:
        """Proof-of-work grinding as ONE batched device Poseidon sweep
        (the host-numpy fallback in fri.grind takes tens of seconds)."""
        if not self.is_jax:
            return grind(challenger, pow_bits)
        from ..field.poseidon import RATE, WIDTH
        G, H = self.G, self.H
        xp = G.xp
        # prepare the duplexed state with the pending input buffer applied;
        # only the nonce lane (index k-1) varies per candidate
        state = list(challenger.state)
        for i, v in enumerate(challenger.input_buf):
            state[i] = v
        k = len(challenger.input_buf) + 1
        assert k <= RATE
        bound_hi = np.uint32(1 << (32 - pow_bits)) if pow_bits <= 32 else None
        assert bound_hi is not None, "pow_bits > 32 unsupported"

        def run(slo, shi, start):
            nonces = start + xp.arange(batch, dtype=xp.uint32)
            st_lo = xp.broadcast_to(slo.reshape(WIDTH, 1), (WIDTH, batch))
            st_hi = xp.broadcast_to(shi.reshape(WIDTH, 1), (WIDTH, batch))
            st_lo = st_lo.at[k - 1].set(nonces)
            st_hi = st_hi.at[k - 1].set(xp.zeros(batch, xp.uint32))
            out = H.permute((st_lo, st_hi))
            ok = out[1][RATE - 1] < bound_hi
            idx = xp.argmax(ok)
            return ok[idx], nonces[idx]

        s64 = np.array(state, dtype=np.uint64)
        slo = xp.asarray((s64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        shi = xp.asarray((s64 >> np.uint64(32)).astype(np.uint32))
        jrun = self.jit(("grind", batch, k, pow_bits), run)
        start = 0
        while True:
            found, nonce = jrun(slo, shi, np.uint32(start))
            if bool(found):
                return int(nonce)
            start += batch
            assert start < (1 << 32), "grinding exhausted 32-bit nonces"

    def fri_commit_layer(self, values_ext):
        """FRI layer leaf matrix + leaf hash + all Merkle levels as ONE
        jitted program (launch-count: see commit)."""
        G = self.G
        cap_height = self.config.cap_height
        m = int(values_ext[0][0].shape[0])
        h = m // 2
        xp = G.xp

        def run(rl, rh, il, ih):
            lo = xp.stack([rl[:h], il[:h], rl[h:], il[h:]], axis=1)
            hi = xp.stack([rh[:h], ih[:h], rh[h:], ih[h:]], axis=1)
            levels = self.merkle_levels_graph((lo, hi))
            flat = [c for lev in levels for c in lev]
            return (lo, hi, *flat)

        out = self.jit(("fri_layer", m), run)(*values_ext[0], *values_ext[1])
        leaf = (out[0], out[1])
        levels = [(out[2 + 2 * i], out[3 + 2 * i])
                  for i in range((len(out) - 2) // 2)]
        tree = MerkleTree(G, leaf[0], leaf[1], levels,
                          min(cap_height, h.bit_length() - 1))
        return tree


def prove(pk: ProvingKey, external_values: np.ndarray,
          check_constraints: bool = False, timer=None) -> Proof:
    from ..utils.timing import PhaseTimer
    timer = timer or PhaseTimer(enabled=False)
    G, E, H = pk.G, pk.E, pk.H
    cc = pk.compiled
    cfg = pk.config
    n, m = pk.n, pk.m
    W = pk.W

    # ---- phase 0: witness fill (host, batched limbs) -----------------------
    with timer.phase("witness_fill"):
        vals = cc.generate_witness(external_values)
    if check_constraints:
        bad = cc.check_constraints(vals)
        assert bad is None, f"constraint violated at row {bad}"
    pub_values = cc.public_values(vals)
    if pk.has_lookups:
        mcol = cc.multiplicities(cc.wire_values(vals))   # (n,)
    else:
        mcol = None

    challenger = Challenger()
    for d in pk.vk.constants_cap:
        challenger.observe_many(d)
    challenger.observe_many(pub_values)

    # ---- phase 1: wire (+ multiplicity) commitment --------------------------
    # challenger cap observations sit INSIDE the phases: the cap-to-host
    # transfer is the sync point of each phase's async device work, so
    # leaving it outside would charge a phase's device time to no phase
    with timer.phase("wire_commit"):
        wires_dev = pk.build_wires(vals, mcol)
        wires_oracle = pk.commit(wires_dev)
        challenger.observe_cap(wires_oracle.tree.cap_u64())
    beta = challenger.get_ext_challenge()
    gamma = challenger.get_ext_challenge()
    lam = challenger.get_ext_challenge() if pk.has_lookups else None

    # ---- phase 2: Z, partial products, lookup helpers ------------------------
    with timer.phase("permutation_z"):
        z_mat = pk.round2_phase(wires_dev, beta, gamma, lam)
        z_oracle = pk.commit(z_mat)
        challenger.observe_cap(z_oracle.tree.cap_u64())
    alpha = challenger.get_ext_challenge()

    # ---- phase 3: quotient ---------------------------------------------------
    pi_vals = np.zeros(n, dtype=np.uint64)
    for j, pv in enumerate(pub_values):
        pi_vals[j] = (P - pv) % P
    with timer.phase("quotient"):
        q_cols = pk.quotient_phase(wires_oracle.lde, z_oracle.lde, pi_vals,
                                   beta, gamma, lam, alpha)
        quotient_oracle = pk.commit(q_cols, from_coeffs=True)
        challenger.observe_cap(quotient_oracle.tree.cap_u64())
    zeta = challenger.get_ext_challenge()

    # ---- phase 4: openings at zeta (and g*zeta for the round-2 oracle) -------
    timer_openings = timer.phase("openings")
    timer_openings.__enter__()
    zpows = pk.ext_power_table(zeta, n)
    gzeta = e_mul((pk.omega, 0), zeta)
    gzpows = pk.ext_power_table(gzeta, n)

    open_const = pk.open_at(pk.constants_oracle, zpows)
    open_wires = pk.open_at(wires_oracle, zpows)
    open_z = pk.open_at(z_oracle, zpows)
    open_z_next = pk.open_at(z_oracle, gzpows)
    open_quot = pk.open_at(quotient_oracle, zpows)
    openings = Openings(open_const, open_wires, open_z, open_z_next, open_quot)
    for (a, b) in openings.ordered():
        challenger.observe(a)
        challenger.observe(b)
    fri_alpha = challenger.get_ext_challenge()
    timer_openings.__exit__(None, None, None)

    # ---- phase 5: FRI ---------------------------------------------------------
    timer_fri = timer.phase("fri")
    timer_fri.__enter__()
    oracles = [pk.constants_oracle, wires_oracle, z_oracle, quotient_oracle]
    lde_list = [o.lde for o in oracles]
    ncols = sum(p[0].shape[1] for p in lde_list)
    zcols = 2 * pk.num_z_ext
    ys = openings.constants_sigmas + openings.wires + openings.z + openings.quotient
    alphas = [e_pow(fri_alpha, i) for i in range(ncols + zcols)]
    y1 = (0, 0)
    for yv, a in zip(ys, alphas[:ncols]):
        y1 = e_add(y1, e_mul(yv, a))
    y2 = (0, 0)
    for yv, a in zip(openings.z_next, alphas[ncols:]):
        y2 = e_add(y2, e_mul(yv, a))
    F = pk.fri_combine(lde_list, alphas, y1, y2, zeta, gzeta, z_oracle.lde)

    fri_trees = []
    cur = F
    cur_shift = _gl.MULTIPLICATIVE_GENERATOR
    size = m
    while size > pk.vk.final_poly_domain:
        h = size // 2
        tree = pk.fri_commit_layer(cur)
        challenger.observe_cap(tree.cap_u64())
        fbeta = challenger.get_ext_challenge()
        cur = pk.fri_fold(cur, fbeta, cur_shift)
        fri_trees.append(tree)
        cur_shift = (cur_shift * cur_shift) % P
        size = h
    re = coset_intt(G, cur[0], shift=cur_shift)
    im = coset_intt(G, cur[1], shift=cur_shift)
    re64 = np.asarray(G.to_u64((re[0].reshape(-1), re[1].reshape(-1))))
    im64 = np.asarray(G.to_u64((im[0].reshape(-1), im[1].reshape(-1))))
    final_coeffs = [(int(a), int(b)) for a, b in zip(re64, im64)]
    for c0, c1 in final_coeffs:
        challenger.observe(c0)
        challenger.observe(c1)

    timer_fri.__exit__(None, None, None)
    with timer.phase("pow_grind"):
        pow_witness = pk.grind(challenger, cfg.pow_bits)
    challenger.observe(pow_witness)
    pow_challenge = challenger.get_challenge()
    assert pow_challenge < (1 << (64 - cfg.pow_bits))
    indices = challenger.get_indices(cfg.num_queries, m)

    # ---- phase 6: query rounds (batched gathers: O(oracles + layers)
    # device->host transfers, not O(queries * levels)) --------------------------
    timer_q = timer.phase("queries")
    timer_q.__enter__()
    oracle_rows = [o.tree.rows_u64(indices) for o in oracles]
    oracle_paths = [o.tree.paths_for(indices) for o in oracles]
    layer_indices = []
    cur_idx = list(indices)
    for tree in fri_trees:
        h = tree.num_leaves
        cur_idx = [i % h for i in cur_idx]
        layer_indices.append(list(cur_idx))
    layer_rows = [t.rows_u64(ix) for t, ix in zip(fri_trees, layer_indices)]
    layer_paths = [t.paths_for(ix) for t, ix in zip(fri_trees, layer_indices)]
    queries = []
    for qi in range(len(indices)):
        initial = [OracleOpening(
            row=[int(v) for v in oracle_rows[oi][qi]],
            path=[tuple(int(x) for x in d) for d in oracle_paths[oi][qi]])
            for oi in range(len(oracles))]
        steps = []
        for li in range(len(fri_trees)):
            row = layer_rows[li][qi]
            pair = ((int(row[0]), int(row[1])), (int(row[2]), int(row[3])))
            steps.append(FriStep(
                pair=pair,
                path=[tuple(int(x) for x in d) for d in layer_paths[li][qi]]))
        queries.append(QueryRound(initial=initial, steps=steps))

    timer_q.__exit__(None, None, None)

    def cap_list(tree):
        return [tuple(int(x) for x in d) for d in tree.cap_u64()]

    return Proof(
        public_inputs=pub_values,
        wires_cap=cap_list(wires_oracle.tree),
        z_cap=cap_list(z_oracle.tree),
        quotient_cap=cap_list(quotient_oracle.tree),
        openings=openings,
        fri_caps=[cap_list(t) for t in fri_trees],
        fri_final_coeffs=final_coeffs,
        fri_pow_witness=pow_witness,
        fri_queries=queries,
    )
