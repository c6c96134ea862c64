"""Fully fused single-program prover: the whole proof in ONE jitted XLA
computation.

The per-phase prover in prove.py drives the Fiat-Shamir transcript on the
host between ~15 separately jitted programs, costing a device round trip
(and a separate XLA compile + cache entry) per phase.  Here the *entire*
pipeline — wire commit, round-2 columns, quotient, openings, FRI
commit/fold, proof-of-work grinding, query sampling and Merkle path
extraction — is traced into one program, with the duplex-Poseidon
challenger running in-graph on (12,) lanes.  One host->device transfer
(the witness matrix), one device->host transfer (the proof pytree).

Bit-identical to the per-phase path by construction: both call the same
phase bodies (prove.round2_body / quotient_body / open_body /
fri_combine_body / fri_fold_body) and the transcript rules mirror
challenger.Challenger exactly (tested in tests/test_fused.py).

Reference analog: plonky2's prove() in the external Rust fork
(SURVEY.md §2.3, actions/prove_action.rs:91-97) — a single native call; we
match that shape with a single compiled program instead of a driver loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl as _gl
from ..field.gl import P
from ..field.poseidon import RATE, WIDTH
from .ntt import coset_intt, coset_lde, intt
from .proof import (FriStep, Openings, OracleOpening, Proof, QueryRound)
from .prove import (_mat_to_dev, fri_combine_body, fri_fold_body, open_body,
                    quotient_body, quotient_chunk_rows, round2_body)


# ---------------------------------------------------------------------------
# In-graph challenger


class GraphChallenger:
    """Duplex Poseidon sponge over traced (or concrete) scalars.

    Mirrors challenger.Challenger exactly: same buffering, same duplex
    points, same pop-from-the-end squeeze order.  Values are () uint32
    (lo, hi) pairs."""

    def __init__(self, H):
        self.H = H
        xp = H.G.xp
        self.xp = xp
        self.lo = xp.zeros(WIDTH, xp.uint32)
        self.hi = xp.zeros(WIDTH, xp.uint32)
        self.input_buf = []   # list of ((), ()) u32 scalar pairs
        self.output_buf = []

    def observe(self, lo, hi):
        self.input_buf.append((lo, hi))
        if len(self.input_buf) == RATE:
            self._duplex()

    def observe_vec(self, lo, hi):
        """Observe every element of a 1-D (lo, hi) pair, in order.

        Every duplex this triggers has a full RATE-element input buffer, so
        they run as ONE lax.scan over RATE-sized chunks: one traced
        permutation per call instead of one per duplex.  A transcript
        absorbs hundreds of chunks (caps, openings, the final polynomial),
        and inline permutations made the program's compile time grow with
        it."""
        from jax import lax
        xp = self.xp
        k = len(self.input_buf)
        n = lo.shape[0]
        full = (k + n) // RATE
        if full == 0:
            for i in range(n):
                self.observe(lo[i], hi[i])
            return
        take = full * RATE - k
        clo, chi = lo[:take], hi[:take]
        if k:
            clo = xp.concatenate([xp.stack([b[0] for b in self.input_buf]),
                                  clo])
            chi = xp.concatenate([xp.stack([b[1] for b in self.input_buf]),
                                  chi])

        def body(st, chunk):
            st = (xp.concatenate([chunk[0], st[0][RATE:]]),
                  xp.concatenate([chunk[1], st[1][RATE:]]))
            return self.H.permute(st), None

        (self.lo, self.hi), _ = lax.scan(
            body, (self.lo, self.hi),
            (clo.reshape(full, RATE), chi.reshape(full, RATE)))
        self.output_buf = [(self.lo[i], self.hi[i]) for i in range(RATE)]
        self.input_buf = [(lo[i], hi[i]) for i in range(take, n)]

    def observe_cap(self, cap):
        """cap: (DIGEST, size) pair — observed digest-major like
        Challenger.observe_cap over the (size, DIGEST) host layout."""
        lo, hi = cap
        self.observe_vec(lo.T.reshape(-1), hi.T.reshape(-1))

    def observe_ext(self, pairs):
        """Observe ext vectors ((re_lo, re_hi), (im_lo, im_hi)) in order,
        each element as re then im (the host transcript's order)."""
        xp = self.xp
        lo = xp.concatenate([xp.stack([re[0], im[0]], axis=1).reshape(-1)
                             for re, im in pairs])
        hi = xp.concatenate([xp.stack([re[1], im[1]], axis=1).reshape(-1)
                             for re, im in pairs])
        self.observe_vec(lo, hi)

    def _duplex(self):
        xp = self.xp
        lo, hi = self.lo, self.hi
        if self.input_buf:
            k = len(self.input_buf)
            blo = xp.stack([b[0] for b in self.input_buf])
            bhi = xp.stack([b[1] for b in self.input_buf])
            lo = xp.concatenate([blo, lo[k:]])
            hi = xp.concatenate([bhi, hi[k:]])
        lo, hi = self.H.permute((lo, hi))
        self.lo, self.hi = lo, hi
        self.output_buf = [(lo[i], hi[i]) for i in range(RATE)]
        self.input_buf = []

    def get_challenge(self):
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_ext_challenge(self):
        re = self.get_challenge()
        im = self.get_challenge()
        return (re, im)


def _ext_scal_c(ch):
    """Challenge ((lo,hi),(lo,hi)) () scalars -> broadcastable ext value."""
    (rl, rh), (il, ih) = ch
    return ((rl.reshape(1), rh.reshape(1)), (il.reshape(1), ih.reshape(1)))


# ---------------------------------------------------------------------------
# In-graph helpers


def ext_powers_table(G, E, z_scal, n: int):
    """[z^0 .. z^(n-1)] as ((n,) re pair, (n,) im pair), by log-doubling."""
    xp = G.xp
    re = (xp.ones((1,), xp.uint32), xp.zeros((1,), xp.uint32))
    im = (xp.zeros((1,), xp.uint32), xp.zeros((1,), xp.uint32))
    cur = _ext_scal_c(z_scal)
    k = 1
    while k < n:
        nre, nim = E.mul((re, im), cur)
        re = (xp.concatenate([re[0], nre[0]]), xp.concatenate([re[1], nre[1]]))
        im = (xp.concatenate([im[0], nim[0]]), xp.concatenate([im[1], nim[1]]))
        cur = E.mul(cur, cur)
        k *= 2
    return (re[0][:n], re[1][:n]), (im[0][:n], im[1][:n])


def ext_powers4(G, E, z_scal, count: int):
    """[z^0 .. z^(count-1)] as a stacked 4-tuple of (count,) u32 arrays
    (re_lo, re_hi, im_lo, im_hi) — the al4/fa4 layout.  Array-shaped
    log-doubling: O(log count) vector E.muls instead of O(count) scalar
    ones (each scalar ext mul alone is ~700 jaxpr eqns of limb math; the
    earlier per-scalar list made the fused graph 300k+ eqns)."""
    re, im = ext_powers_table(G, E, z_scal, count)
    return (re[0], re[1], im[0], im[1])


def ext_dot4(G, E, ys4, alphas4):
    """sum_i alphas[i] * ys[i] over stacked (C,) ext arrays -> () scalar
    ext pair.  One vectorized E.mul then a log-depth halving reduction
    (zero-padded to a power of two; zero is additive identity)."""
    xp = G.xp
    y = ((ys4[0], ys4[1]), (ys4[2], ys4[3]))
    a = ((alphas4[0], alphas4[1]), (alphas4[2], alphas4[3]))
    (rl, rh), (il, ih) = E.mul(y, a)
    k = rl.shape[0]
    m = 1 << (k - 1).bit_length()
    if m != k:
        pad = (0, m - k)
        rl, rh, il, ih = (xp.pad(v, pad) for v in (rl, rh, il, ih))
    while rl.shape[0] > 1:
        h = rl.shape[0] // 2
        lo = ((rl[:h], rh[:h]), (il[:h], ih[:h]))
        hi = ((rl[h:], rh[h:]), (il[h:], ih[h:]))
        (rl, rh), (il, ih) = E.add(lo, hi)
    return ((rl[0], rh[0]), (il[0], ih[0]))


def merkle_levels_graph(pk, matrix):
    """All Merkle levels of an (M, C) matrix pair, in-graph (rolled
    heap-loop build, see merkle.merkle_levels).
    levels[0] = (DIGEST, M) leaf digests, levels[-1] = cap."""
    from .merkle import leaf_digests, merkle_levels
    H = pk.H
    cap_height = pk.config.cap_height
    lo, hi = matrix
    m = lo.shape[0]
    ch = min(cap_height, int(m).bit_length() - 1)
    leaf = leaf_digests(H, matrix)
    return merkle_levels(H, leaf, 1 << ch)


@dataclass
class GraphOracle:
    coeffs: tuple
    lde: tuple
    levels: list

    @property
    def cap(self):
        return self.levels[-1]


def commit_graph(pk, values, from_coeffs: bool = False) -> GraphOracle:
    G = pk.G
    coeffs = values if from_coeffs else intt(G, values)
    lde = coset_lde(G, coeffs, pk.config.rate_bits)
    return GraphOracle(coeffs, lde, merkle_levels_graph(pk, lde))


def grind_graph(pk, challenger: GraphChallenger, pow_bits: int,
                batch: int = 1 << 17):
    """In-graph proof-of-work search (lax.while_loop over nonce batches).
    Returns the nonce as a () uint32 (nonces < 2^32 by construction, as in
    ProvingKey.grind)."""
    import jax
    import jax.numpy as jnp
    H, G = pk.H, pk.G
    xp = G.xp
    state_lo, state_hi = challenger.lo, challenger.hi
    buf = challenger.input_buf
    k = len(buf) + 1
    assert k <= RATE
    assert pow_bits <= 32
    if buf:
        blo = xp.stack([b[0] for b in buf])
        bhi = xp.stack([b[1] for b in buf])
        state_lo = xp.concatenate([blo, state_lo[len(buf):]])
        state_hi = xp.concatenate([bhi, state_hi[len(buf):]])
    bound_hi = jnp.uint32(1 << (32 - pow_bits))

    def cond(c):
        found, _, _ = c
        return jnp.logical_not(found)

    def body(c):
        _, nonce, start = c
        nonces = start + jnp.arange(batch, dtype=jnp.uint32)
        st_lo = jnp.broadcast_to(state_lo.reshape(WIDTH, 1), (WIDTH, batch))
        st_hi = jnp.broadcast_to(state_hi.reshape(WIDTH, 1), (WIDTH, batch))
        st_lo = st_lo.at[k - 1].set(nonces)
        st_hi = st_hi.at[k - 1].set(jnp.zeros(batch, jnp.uint32))
        out = H.permute((st_lo, st_hi))
        ok = out[1][RATE - 1] < bound_hi
        idx = jnp.argmax(ok)
        return (ok[idx], nonces[idx], start + jnp.uint32(batch))

    found0 = jnp.bool_(False)
    _, nonce, _ = jax.lax.while_loop(
        cond, body, (found0, jnp.uint32(0), jnp.uint32(0)))
    return nonce


def _gather_paths(xp, levels, idx):
    """Merkle sibling paths for an index vector: list over levels of
    (DIGEST, Q) pairs, plus nothing for the cap level."""
    out = []
    cur = idx
    for (lo, hi) in levels[:-1]:
        sib = cur ^ 1
        out.append((xp.take(lo, sib, axis=1), xp.take(hi, sib, axis=1)))
        cur = cur >> 1
    return out


# ---------------------------------------------------------------------------
# The fused program


def _fused_graph(pk, args):
    """The complete prover as one traceable function.

    args: dict of device arrays (wires matrix, public inputs, preprocessed
    oracle tensors, domain tables).  Returns the proof as a pytree."""
    import jax.numpy as jnp
    G, E, H = pk.G, pk.E, pk.H
    xp = G.xp
    cc = pk.compiled
    cfg = pk.config
    n, m = pk.n, pk.m
    W = pk.W

    if "vals" in args:
        # wires gathered ON DEVICE from the solved variable vector by the
        # pk-resident (W, n) routing table: ships ~n values host->device
        # instead of the full (n, W+1) wires matrix — a 17x transfer cut
        vlo, vhi = args["vals"]
        widx = args["wire_idx"]            # (W, n) int32
        wlo = jnp.take(vlo, widx, axis=0).T
        whi = jnp.take(vhi, widx, axis=0).T
        if "mcol" in args:
            wlo = jnp.concatenate([wlo, args["mcol"][0][:, None]], axis=1)
            whi = jnp.concatenate([whi, args["mcol"][1][:, None]], axis=1)
        wires_dev = (wlo, whi)
    else:
        wires_dev = args["wires"]
    pub = args["pub"]                      # (npub,) pair
    const_oracle = GraphOracle(args["const_coeffs"], args["const_lde"],
                               list(args["const_levels"]))
    x_h = args["x_h"]
    x_lde = args["x_lde"]
    k_dev = args["k"]
    sigma = args["sigma"]
    zh_inv = args["zh_inv"]
    zh = args["zh"]
    tbl = args["table"]
    qlk = args["qlk"]

    ch = GraphChallenger(H)
    ch.observe_vec(*_mat_to_dev(G, np.array(
        [int(el) for d in pk.vk.constants_cap for el in d], dtype=np.uint64)))
    ch.observe_vec(pub[0], pub[1])

    # ---- wires commitment ------------------------------------------------
    wires_oracle = commit_graph(pk, wires_dev)
    ch.observe_cap(wires_oracle.cap)
    beta = ch.get_ext_challenge()
    gamma = ch.get_ext_challenge()
    lam = ch.get_ext_challenge() if pk.has_lookups else \
        ((xp.uint32(0), xp.uint32(0)), (xp.uint32(0), xp.uint32(0)))

    # ---- round 2 ---------------------------------------------------------
    z_mat = round2_body(pk, wires_dev, sigma, x_h, k_dev, tbl, qlk,
                        _ext_scal_c(beta), _ext_scal_c(gamma),
                        _ext_scal_c(lam))
    z_oracle = commit_graph(pk, z_mat)
    ch.observe_cap(z_oracle.cap)
    alpha = ch.get_ext_challenge()

    # ---- quotient --------------------------------------------------------
    npub = cc.num_public_inputs
    if npub:
        neg_pub = G.neg(pub)
        pi_pair = (xp.concatenate([neg_pub[0],
                                   xp.zeros(n - npub, xp.uint32)]),
                   xp.concatenate([neg_pub[1],
                                   xp.zeros(n - npub, xp.uint32)]))
    else:
        z0 = xp.zeros(n, xp.uint32)
        pi_pair = (z0, z0)
    al4 = ext_powers4(G, E, alpha, pk.num_constraints)
    q_cols = quotient_body(pk, const_oracle.lde, wires_oracle.lde,
                           z_oracle.lde, pi_pair, x_lde, k_dev,
                           zh_inv, zh, _ext_scal_c(beta),
                           _ext_scal_c(gamma), _ext_scal_c(lam), al4)
    quotient_oracle = commit_graph(pk, q_cols, from_coeffs=True)
    ch.observe_cap(quotient_oracle.cap)
    zeta = ch.get_ext_challenge()

    # ---- openings --------------------------------------------------------
    zpows = ext_powers_table(G, E, zeta, n)
    omega_scal = ((xp.uint32(pk.omega & 0xFFFFFFFF),
                   xp.uint32(pk.omega >> 32)),
                  (xp.uint32(0), xp.uint32(0)))
    gzeta = E.mul(omega_scal, zeta)
    gzpows = ext_powers_table(G, E, gzeta, n)

    open_const = open_body(pk, const_oracle.coeffs, zpows[0], zpows[1])
    open_wires = open_body(pk, wires_oracle.coeffs, zpows[0], zpows[1])
    open_z = open_body(pk, z_oracle.coeffs, zpows[0], zpows[1])
    open_z_next = open_body(pk, z_oracle.coeffs, gzpows[0], gzpows[1])
    open_quot = open_body(pk, quotient_oracle.coeffs, zpows[0], zpows[1])
    all_opens = [open_const, open_wires, open_z, open_z_next, open_quot]
    ch.observe_ext(all_opens)
    fri_alpha = ch.get_ext_challenge()

    # ---- FRI combine -----------------------------------------------------
    oracles = [const_oracle, wires_oracle, z_oracle, quotient_oracle]
    lde_list = [o.lde for o in oracles]
    ncols = sum(p[0].shape[1] for p in lde_list)
    zcols = 2 * pk.num_z_ext
    fa4 = ext_powers4(G, E, fri_alpha, ncols + zcols)

    # y1 = sum_i alpha^i y_i over [const, wires, z, quotient] openings,
    # y2 the same over the z_next openings — both as vectorized ext dots
    y_opens = [open_const, open_wires, open_z, open_quot]
    ys4 = (xp.concatenate([o[0][0] for o in y_opens]),
           xp.concatenate([o[0][1] for o in y_opens]),
           xp.concatenate([o[1][0] for o in y_opens]),
           xp.concatenate([o[1][1] for o in y_opens]))
    y1 = ext_dot4(G, E, ys4, tuple(v[:ncols] for v in fa4))
    zn4 = (open_z_next[0][0], open_z_next[0][1],
           open_z_next[1][0], open_z_next[1][1])
    y2 = ext_dot4(G, E, zn4, tuple(v[ncols:ncols + zcols] for v in fa4))

    F = fri_combine_body(pk, lde_list, z_oracle.lde, x_lde, fa4,
                         _ext_scal_c(y1), _ext_scal_c(y2),
                         _ext_scal_c(zeta), _ext_scal_c(gzeta))

    # ---- FRI fold layers -------------------------------------------------
    from .ntt import device_powers
    fri_layers = []   # (leafmat pair, levels)
    cur = F
    cur_shift = _gl.MULTIPLICATIVE_GENERATOR
    size = m
    while size > pk.vk.final_poly_domain:
        h = size // 2
        llo = xp.stack([cur[0][0][:h], cur[1][0][:h],
                        cur[0][0][h:], cur[1][0][h:]], axis=1)
        lhi = xp.stack([cur[0][1][:h], cur[1][1][:h],
                        cur[0][1][h:], cur[1][1][h:]], axis=1)
        levels = merkle_levels_graph(pk, (llo, lhi))
        fri_layers.append(((llo, lhi), levels))
        ch.observe_cap(levels[-1])
        fbeta = ch.get_ext_challenge()
        w_inv = _gl.s_inv(_gl.root_of_unity(size.bit_length() - 1))
        base = _gl.s_mul(1, _gl.s_inv((2 * cur_shift) % P))
        # inv2x[i] = w_inv^i / (2*shift): powers table scaled by base
        pw = device_powers(G, w_inv, h)
        basec = G.const(base)
        inv2x = G.mul(pw, (basec[0].reshape(1), basec[1].reshape(1)))
        cur = fri_fold_body(pk, cur, inv2x, _ext_scal_c(fbeta))
        cur_shift = (cur_shift * cur_shift) % P
        size = h
    f_re = coset_intt(G, cur[0], shift=cur_shift)
    f_im = coset_intt(G, cur[1], shift=cur_shift)
    f_re = (f_re[0].reshape(-1), f_re[1].reshape(-1))
    f_im = (f_im[0].reshape(-1), f_im[1].reshape(-1))
    ch.observe_ext([(f_re, f_im)])

    # ---- PoW + queries ---------------------------------------------------
    pow_witness = grind_graph(pk, ch, cfg.pow_bits)
    ch.observe(pow_witness, xp.uint32(0))
    _pow_challenge = ch.get_challenge()
    mask = jnp.uint32(m - 1)
    idx_list = []
    for _ in range(cfg.num_queries):
        c = ch.get_challenge()
        idx_list.append(c[0] & mask)
    indices = xp.stack(idx_list).astype(jnp.int32)

    # Query ROWS of the four committed oracles are NOT gathered here: doing
    # so would keep every oracle's full LDE alive until the end of the
    # program (the query indices only exist after the PoW grind), doubling
    # the program's peak device memory.  Instead the coefficient matrices
    # (8x smaller) are returned and a second tiny program per oracle re-runs
    # the coset LDE and gathers just the query rows (prove_fused below);
    # polynomial evaluation is exact, so the recomputed rows are
    # bit-identical.  Here each LDE dies at its last in-graph use
    # (fri_combine) and XLA frees it.
    oracle_paths = [_gather_paths(xp, o.levels, indices) for o in oracles]
    fri_rows = []
    fri_paths = []
    cur_idx = indices
    for (leafmat, levels) in fri_layers:
        h = leafmat[0].shape[0]
        cur_idx = cur_idx & jnp.int32(h - 1)
        fri_rows.append((xp.take(leafmat[0], cur_idx, axis=0),
                         xp.take(leafmat[1], cur_idx, axis=0)))
        fri_paths.append(_gather_paths(xp, levels, cur_idx))

    return {
        "wires_cap": wires_oracle.cap,
        "z_cap": z_oracle.cap,
        "quotient_cap": quotient_oracle.cap,
        "opens": all_opens,
        "fri_caps": [layers[-1] for (_, layers) in fri_layers],
        "final_re": f_re,
        "final_im": f_im,
        "pow": pow_witness,
        "indices": indices,
        "coeffs": {
            "wires": wires_oracle.coeffs,
            "z": z_oracle.coeffs,
            "quotient": quotient_oracle.coeffs,
        },
        "oracle_paths": oracle_paths,
        "fri_rows": fri_rows,
        "fri_paths": fri_paths,
    }


# ---------------------------------------------------------------------------
# Host wrapper


def _u64(lo, hi):
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


def _cap_list(cap_pair):
    cap = _u64(*cap_pair)  # (DIGEST, size)
    return [tuple(int(x) for x in cap[:, d]) for d in range(cap.shape[1])]


def prove_fused(pk, external_values: np.ndarray, timer=None) -> Proof:
    """Single-program prove: bit-identical output to prove.prove()."""
    from ..utils.timing import PhaseTimer
    import jax
    timer = timer or PhaseTimer(enabled=False)
    G = pk.G
    cc = pk.compiled
    n = pk.n

    with timer.phase("witness_fill"):
        vals = cc.generate_witness(external_values)
    pub_values = cc.public_values(vals)

    with timer.phase("fused_device"):
        args = dict(
            vals=_mat_to_dev(G, vals),
            wire_idx=pk.wire_idx_dev,
            pub=_mat_to_dev(G, np.array(pub_values, dtype=np.uint64)),
            const_coeffs=pk.constants_oracle.coeffs,
            const_lde=pk.constants_oracle.lde,
            const_levels=tuple(tuple(l) for l in
                               pk.constants_oracle.tree.levels),
            x_h=pk.x_h, x_lde=pk.x_lde, k=pk.k_dev,
            sigma=pk.sigma_dev, zh_inv=pk.zh_inv_lde, zh=pk.zh_lde,
            table=getattr(pk, "table_dev",
                          (G.xp.zeros(n, G.xp.uint32),) * 2),
            qlk=getattr(pk, "qlk_dev",
                        (G.xp.zeros(n, G.xp.uint32),) * 2),
        )
        if pk.has_lookups:
            mcol = cc.multiplicities(cc.wire_values(vals))
            args["mcol"] = _mat_to_dev(G, mcol)
        key = ("fused", quotient_chunk_rows(pk))
        if key not in pk._jits:
            pk._jits[key] = jax.jit(lambda a: _fused_graph(pk, a))
        out = pk._jits[key](args)
        # second stage: per-oracle query-row extraction (LDE recompute +
        # gather; see the liveness note in _fused_graph).  The constants
        # oracle's LDE is ProvingKey-resident, so it is gathered directly.
        idx = out["indices"]
        rows = [_query_rows_lde(pk, pk.constants_oracle.lde, idx)]
        for name in ("wires", "z", "quotient"):
            rows.append(_query_rows_coeffs(pk, out["coeffs"][name], idx))
        out["oracle_rows"] = rows
        del out["coeffs"]
        out = jax.device_get(out)

    with timer.phase("assemble"):
        return _assemble_proof(pk, pub_values, out)


def _query_rows_lde(pk, lde, indices):
    """Gather query rows from a resident LDE matrix."""
    def run(lo, hi, idx):
        return pk.G.xp.take(lo, idx, axis=0), pk.G.xp.take(hi, idx, axis=0)

    return pk.jit(("qrows_lde", tuple(lde[0].shape)), run)(*lde, indices)


def _query_rows_coeffs(pk, coeffs, indices):
    """Recompute an oracle's coset LDE from its coefficients and gather the
    query rows (bit-identical to the committed LDE's rows — exact field
    evaluation)."""
    def run(lo, hi, idx):
        lde = coset_lde(pk.G, (lo, hi), pk.config.rate_bits)
        return pk.G.xp.take(lde[0], idx, axis=0), \
            pk.G.xp.take(lde[1], idx, axis=0)

    return pk.jit(("qrows_coeffs", tuple(coeffs[0].shape)), run)(
        *coeffs, indices)


def _assemble_proof(pk, pub_values, out) -> Proof:
    num_q = pk.config.num_queries

    def ext_list(re_pair, im_pair):
        re = _u64(*re_pair)
        im = _u64(*im_pair)
        return [(int(a), int(b)) for a, b in zip(re, im)]

    opens = out["opens"]
    openings = Openings(
        constants_sigmas=ext_list(*opens[0]),
        wires=ext_list(*opens[1]),
        z=ext_list(*opens[2]),
        z_next=ext_list(*opens[3]),
        quotient=ext_list(*opens[4]),
    )

    indices = [int(i) for i in out["indices"]]
    oracle_rows = [_u64(lo, hi) for (lo, hi) in out["oracle_rows"]]
    # paths: list over oracles of list over levels of (DIGEST, Q)
    oracle_paths = [[_u64(lo, hi) for (lo, hi) in paths]
                    for paths in out["oracle_paths"]]
    fri_rows = [_u64(lo, hi) for (lo, hi) in out["fri_rows"]]
    fri_paths = [[_u64(lo, hi) for (lo, hi) in paths]
                 for paths in out["fri_paths"]]

    queries = []
    for qi in range(num_q):
        initial = []
        for oi in range(len(oracle_rows)):
            row = [int(v) for v in oracle_rows[oi][qi]]
            path = [tuple(int(x) for x in lvl[:, qi])
                    for lvl in oracle_paths[oi]]
            initial.append(OracleOpening(row=row, path=path))
        steps = []
        for li in range(len(fri_rows)):
            row = fri_rows[li][qi]
            pair = ((int(row[0]), int(row[1])), (int(row[2]), int(row[3])))
            path = [tuple(int(x) for x in lvl[:, qi])
                    for lvl in fri_paths[li]]
            steps.append(FriStep(pair=pair, path=path))
        queries.append(QueryRound(initial=initial, steps=steps))

    final_coeffs = [(int(a), int(b)) for a, b in
                    zip(_u64(*out["final_re"]), _u64(*out["final_im"]))]

    return Proof(
        public_inputs=pub_values,
        wires_cap=_cap_list(out["wires_cap"]),
        z_cap=_cap_list(out["z_cap"]),
        quotient_cap=_cap_list(out["quotient_cap"]),
        openings=openings,
        fri_caps=[_cap_list(c) for c in out["fri_caps"]],
        fri_final_coeffs=final_coeffs,
        fri_pow_witness=int(out["pow"]),
        fri_queries=queries,
    )
