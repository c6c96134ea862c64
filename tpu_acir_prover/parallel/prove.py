"""Integrated multi-chip prover: every heavy prove() phase as an explicit
shard_map SPMD program over a jax Mesh.

The reference's scaling story is rayon threads across FFT/Merkle/quotient
inside its Rust fork (SURVEY.md §2.4); the SPMD equivalent shards the
trace-row / evaluation-domain axis ("sp" — the prover's true scaling axis,
SURVEY.md §5 "trace-length scaling") as contiguous row blocks across chips
and runs each phase under shard_map with explicitly placed collectives:

  - NTT/LDE: four-step (Bailey) decomposition — three all_to_alls move the
    butterfly exchanges between devices, local radix-2 NTTs do the FLOPs, and a
    final all_to_all restores NATURAL-ORDER row blocks so Merkle leaves (and
    therefore caps, paths, and the whole proof) are byte-identical to the
    single-chip prover.  Tiny domains that don't satisfy the grid
    divisibility fall back to gather + replicated NTT + local slice (same
    values, no scaling — they're tiny).
  - Merkle commit: leaf hash + subtree levels are local per shard; the top
    log2(S) levels above the shard roots are one all_gather + replicated
    compression (a few digests).
  - round2 (Z / partial products / LogUp): row-elementwise locally; the two
    cross-row scans (Z's exclusive prefix product, LogUp's running sum) are
    a local Hillis-Steele scan + one all_gather of the S per-shard totals.
  - quotient: row-elementwise locally; the g*x shift of the Z oracle is one
    boundary ppermute of `rate` rows; the final coset-INTT of t(x) is the
    sharded four-step again.
  - openings: local column-dot partials + one all_gather reduction.
  - FRI combine: purely row-elementwise, fully local.
  - FRI layer trees / folds / PoW / final poly: replicated (values are
    gathered once after fri_combine — layer k costs m/2^k, the whole chain
    is < 2 LDE columns of traffic).  The hand-scheduled bit-exact sharded
    fold/commit kernels live in parallel/fri.py.

Why shard_map and not GSPMD placement (the previous design): letting XLA
partition the unmodified phase bodies compiled pathologically (a 16-row
round2 program took >8 min of GSPMD+LLVM on the virtual mesh; dynamic-shift
rolls in scans are the worst case) and the partitioned quotient program
DEADLOCKED at runtime on XLA:CPU subgroup collectives.  shard_map bodies
compile as ordinary single-device programs with explicit collectives —
fast to build, and the collective schedule is exactly what we choose.

Field arithmetic is exact mod p, so every reassociation (local scans +
offsets, partial-sum reductions, four-step vs radix-2 NTT) produces
bit-identical values; tests/test_sharded_prove.py asserts the serialized
proof equals the single-chip proof byte-for-byte.
"""

from __future__ import annotations

import numpy as np

from ..circuit.compile import CompiledCircuit, powers_u64
from ..field import gl as _gl
from ..prover.config import ProofConfig, STANDARD_CONFIG
from ..prover.merkle import MerkleTree
from ..prover.ntt import ntt
from ..prover.prove import (Oracle, ProvingKey, _ext_arg, _ext_scal,
                            _from_dev_u64, _mat_to_dev, open_body,
                            fri_combine_body, prefix_product_ext,
                            prefix_sum_ext, prove, quotient_chunk_rows,
                            quotient_rows_body, sum_rows, tree_fold)
from .mesh import _twiddle_matrix
from .pipeline import grid_dims


def _split_u64(u64):
    u64 = np.ascontiguousarray(u64, dtype=np.uint64)
    return ((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u64 >> np.uint64(32)).astype(np.uint32))


def _fourstep_ok(size: int, S: int) -> bool:
    A, B = grid_dims(size)
    return A % S == 0 and B % S == 0


class ShardedProvingKey(ProvingKey):
    """ProvingKey whose phase programs are shard_map SPMD programs over a
    1-D mesh axis; domain-axis tensors are laid out as contiguous row
    blocks (NamedSharding over `axis`), everything else is replicated."""

    def __init__(self, compiled: CompiledCircuit,
                 config: ProofConfig = STANDARD_CONFIG, mesh=None,
                 axis: str = "sp"):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("sp",))
            axis = "sp"
        self.mesh = mesh
        self.axis = axis
        S = mesh.shape[axis]
        self._nshards = S
        # several sharded kernels (top-level Merkle pairing, sum_rows over
        # gathered (S, C) partials, four-step grid splits) assume a
        # power-of-two shard count; a 6-device mesh would compute wrong
        # openings via broadcasting rather than fail fast
        assert S & (S - 1) == 0, f"shard count {S} must be a power of two"
        assert compiled.n % S == 0, \
            f"trace rows {compiled.n} must divide over {S} shards"
        self._row_sharding = NamedSharding(mesh, PartitionSpec(axis))
        self._col_sharding = NamedSharding(mesh, PartitionSpec(None, axis))
        self._replicated = NamedSharding(mesh, PartitionSpec())
        self._ntt_consts = {}
        self._manual_scan = False
        super().__init__(compiled, config, xp=jnp)

    # ---- placement ----------------------------------------------------------

    def place(self, pair):
        import jax
        d = self._nshards

        def put(a):
            if a.ndim >= 1 and a.shape[0] % d == 0 and a.shape[0] >= d:
                return jax.device_put(a, self._row_sharding)
            return jax.device_put(a, self._replicated)

        return tuple(put(a) for a in pair)

    def _place_cols(self, pair):
        """(A, B) constant pair sharded along axis 1 (grid columns)."""
        import jax
        return tuple(jax.device_put(a, self._col_sharding) for a in pair)

    # ---- per-size NTT constants (twiddles, coset powers) ---------------------

    def _ntt_const(self, kind: str, size: int):
        key = (kind, size)
        if key in self._ntt_consts:
            return self._ntt_consts[key]
        if kind in ("tw_f", "tw_i"):
            A, B = grid_dims(size)
            tw = _twiddle_matrix(A, B, inverse=(kind == "tw_i"))
            dev = self._place_cols(_split_u64(tw))
        elif kind == "shift":
            dev = self.place(_split_u64(
                powers_u64(_gl.MULTIPLICATIVE_GENERATOR, size)))
        elif kind == "shift_inv":
            dev = self.place(_split_u64(
                powers_u64(_gl.s_inv(_gl.MULTIPLICATIVE_GENERATOR), size)))
        else:  # pragma: no cover
            raise KeyError(kind)
        self._ntt_consts[key] = dev
        return dev

    # ---- shard_map-internal kernels (called while tracing a body) -----------

    def _my_block(self, full_pair, size: int):
        """Slice this shard's natural row block out of a replicated array."""
        import jax
        blk = size // self._nshards
        idx = jax.lax.axis_index(self.axis)

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, idx * blk, blk, 0)

        return tuple(sl(a) for a in full_pair)

    def _gather_rows(self, pair):
        import jax
        return tuple(jax.lax.all_gather(a, self.axis, axis=0, tiled=True)
                     for a in pair)

    def _ntt3(self, vals, inverse: bool):
        """NTT along axis 0 of (rows, X, C) local arrays."""
        lo, hi = vals
        s = lo.shape
        r = ntt(self.G, (lo.reshape(s[0], -1), hi.reshape(s[0], -1)),
                inverse=inverse)
        return r[0].reshape(s), r[1].reshape(s)

    def _fourstep_tail(self, grid_loc, size: int, inverse: bool, tw_loc):
        """(A, B/S, C) column-sharded grid -> (size/S, C) natural row block:
        column NTT + twiddle + all_to_all + row NTT + all_to_all.
        tw_loc: this shard's (A, B/S) column slice of the twiddle matrix
        (threaded in as a shard_map operand with spec P(None, axis))."""
        import jax
        import jax.numpy as jnp
        g = self._ntt3(grid_loc, inverse)
        g = self.G.mul(g, (tw_loc[0][:, :, None], tw_loc[1][:, :, None]))

        def a2a10(x):
            return jax.lax.all_to_all(x, self.axis, split_axis=0,
                                      concat_axis=1, tiled=True)

        g = (a2a10(g[0]), a2a10(g[1]))               # (A/S, B, C)
        g = (jnp.swapaxes(g[0], 0, 1), jnp.swapaxes(g[1], 0, 1))
        x = self._ntt3(g, inverse)                   # (B, A/S, C) rows k2
        x = (a2a10(x[0]), a2a10(x[1]))               # (B/S, A, C)
        C = x[0].shape[-1]
        return (x[0].reshape(-1, C), x[1].reshape(-1, C))

    def _intt_blocks(self, vals_loc, tw_loc):
        """Natural-order INTT of a globally (n, C) row-blocked matrix:
        (n/S, C) local in, (n/S, C) local coeffs out.  tw_loc is the local
        twiddle slice (four-step path) or None (gather fallback)."""
        import jax
        n = self.n
        S = self._nshards
        if tw_loc is None:
            full = self._gather_rows(vals_loc)
            coeffs = ntt(self.G, full, inverse=True)
            return self._my_block(coeffs, n)
        A, B = grid_dims(n)
        C = vals_loc[0].shape[1]

        def a2a01(x):
            return jax.lax.all_to_all(x.reshape(A // S, B, C), self.axis,
                                      split_axis=1, concat_axis=0, tiled=True)

        grid = (a2a01(vals_loc[0]), a2a01(vals_loc[1]))  # (A, B/S, C)
        return self._fourstep_tail(grid, n, inverse=True, tw_loc=tw_loc)

    def _coset_lde_blocks(self, coeffs_loc, size: int, rate_bits: int,
                          sp_loc, twf_loc):
        """Coset LDE of row-blocked coefficients: (size/S, C) local coeffs
        in, (m/S, C) local evaluations out (m = size << rate_bits).
        sp_loc: local block of the coset shift powers; twf_loc: local
        forward twiddle slice or None (gather fallback)."""
        import jax
        import jax.numpy as jnp
        G = self.G
        S = self._nshards
        m = size << rate_bits
        scaled = G.mul(coeffs_loc, (sp_loc[0][:, None], sp_loc[1][:, None]))
        full = self._gather_rows(scaled)     # (size, C) replicated
        C = full[0].shape[1]
        pad = ((0, m - size), (0, 0))
        flo = jnp.pad(full[0], pad)
        fhi = jnp.pad(full[1], pad)
        if twf_loc is None:
            evals = ntt(G, (flo, fhi))
            return self._my_block(evals, m)
        Am, Bm = grid_dims(m)
        idx = jax.lax.axis_index(self.axis)
        col0 = idx * (Bm // S)

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(
                a.reshape(Am, Bm, C), col0, Bm // S, 1)

        return self._fourstep_tail((sl(flo), sl(fhi)), m, inverse=False,
                                   tw_loc=twf_loc)

    def _coset_intt_blocks(self, vals_loc, size: int, spi_loc, twi_loc):
        """Coset INTT of a row-blocked (size,) x C matrix -> blocked coeffs.
        spi_loc: local block of the inverse coset shift powers; twi_loc:
        local inverse twiddle slice or None (gather fallback)."""
        import jax
        G = self.G
        S = self._nshards
        if twi_loc is None:
            full = self._gather_rows(vals_loc)
            coeffs = ntt(G, full, inverse=True)
            loc = self._my_block(coeffs, size)
        else:
            A, B = grid_dims(size)
            C = vals_loc[0].shape[1]

            def a2a01(x):
                return jax.lax.all_to_all(
                    x.reshape(A // S, B, C), self.axis,
                    split_axis=1, concat_axis=0, tiled=True)

            grid = (a2a01(vals_loc[0]), a2a01(vals_loc[1]))
            loc = self._fourstep_tail(grid, size, inverse=True,
                                      tw_loc=twi_loc)
        return G.mul(loc, (spi_loc[0][:, None], spi_loc[1][:, None]))

    def _merkle_levels_sharded(self, leaf_loc, m: int):
        """Local leaf hash + local subtree levels + replicated top levels.
        Returns (local_levels, top_levels); each level is a (4, size) pair
        (size local for local levels, global for top)."""
        import jax
        from ..prover.merkle import leaf_digests, merkle_levels
        H = self.H
        S = self._nshards
        ch = min(self.config.cap_height, m.bit_length() - 1)
        cap_size = 1 << ch
        d = leaf_digests(H, leaf_loc)  # (4, m/S)
        # local subtree: stop at max(cap_size, S) GLOBAL nodes = that /S
        # local nodes per shard (rolled heap-loop build, 2 traced bodies)
        stop_g = max(cap_size, S)
        local = merkle_levels(H, d, max(1, stop_g // S))
        d = local[-1]
        size_g = stop_g if m > stop_g else m
        top = []
        if size_g > cap_size:
            # one digest per shard: gather to (4, S) and finish replicated
            g = (jax.lax.all_gather(d[0][:, 0], self.axis, axis=1),
                 jax.lax.all_gather(d[1][:, 0], self.axis, axis=1))
            while size_g > cap_size:
                g = H.two_to_one((g[0][:, 0::2], g[1][:, 0::2]),
                                 (g[0][:, 1::2], g[1][:, 1::2]))
                top.append(g)
                size_g //= 2
        return local, top

    # ---- shard_map wrapper ---------------------------------------------------

    def _smjit(self, key, body, in_specs, out_specs):
        if key not in self._jits:
            import jax
            self._jits[key] = jax.jit(jax.shard_map(
                body, mesh=self.mesh, in_specs=in_specs,
                out_specs=out_specs, check_vma=False))
        return self._jits[key]

    # ---- phase overrides ------------------------------------------------------

    def commit(self, values_dev, from_coeffs: bool = False) -> Oracle:
        from jax.sharding import PartitionSpec as PS
        G = self.G
        n = self.n
        rate_bits = self.config.rate_bits
        m = n << rate_bits
        S = self._nshards
        has_twi = (not from_coeffs) and _fourstep_ok(n, S)
        has_twf = _fourstep_ok(m, S)

        def body(lo, hi, *consts):
            consts = list(consts)
            twi = (consts.pop(0), consts.pop(0)) if has_twi else None
            sp_loc = (consts.pop(0), consts.pop(0))
            twf = (consts.pop(0), consts.pop(0)) if has_twf else None
            loc = (lo, hi)
            coeffs = loc if from_coeffs else self._intt_blocks(loc, twi)
            lde = self._coset_lde_blocks(coeffs, n, rate_bits, sp_loc, twf)
            local, top = self._merkle_levels_sharded(lde, m)
            flat = [c for lev in local + top for c in lev]
            return (*coeffs, *lde, *flat)

        shape = tuple(values_dev[0].shape)
        key = ("scommit", from_coeffs, shape)
        if key not in self._jits:
            # level structure is static per shape: probe the counts
            ch = min(self.config.cap_height, m.bit_length() - 1)
            n_local = 0
            size_g = m
            while size_g > (1 << ch) and size_g > S:
                n_local += 1
                size_g //= 2
            n_top = 0
            while size_g > (1 << ch):
                n_top += 1
                size_g //= 2
            ops = []
            if has_twi:
                tw = self._ntt_const("tw_i", n)
                ops += [(tw[0], PS(None, self.axis)),
                        (tw[1], PS(None, self.axis))]
            sp = self._ntt_const("shift", n)
            ops += [(sp[0], PS(self.axis)), (sp[1], PS(self.axis))]
            if has_twf:
                twf = self._ntt_const("tw_f", m)
                ops += [(twf[0], PS(None, self.axis)),
                        (twf[1], PS(None, self.axis))]
            out_specs = ((PS(self.axis, None),) * 4 +
                         (PS(None, self.axis),) * (2 * (n_local + 1)) +
                         (PS(None, None),) * (2 * n_top))
            in_specs = (PS(self.axis, None),) * 2 + tuple(s for _, s in ops)
            self._jits[key] = (self._smjit(key + ("fn",), body, in_specs,
                                           out_specs),
                               tuple(c for c, _ in ops), n_local + 1, n_top)
        fn, consts, n_loc_levels, n_top_levels = self._jits[key]
        out = fn(*values_dev, *consts)
        coeffs = (out[0], out[1])
        lde = (out[2], out[3])
        flat = out[4:]
        levels = [(flat[2 * i], flat[2 * i + 1])
                  for i in range(n_loc_levels + n_top_levels)]
        ch = min(self.config.cap_height, m.bit_length() - 1)
        tree = MerkleTree(G, lde[0], lde[1], levels, ch)
        return Oracle(coeffs, lde, tree)

    def round2_phase(self, wires_dev, beta, gamma, lam):
        from ..prover.prove import round2_body
        from jax.sharding import PartitionSpec as PS
        G = self.G
        n = self.n

        def body(wlo, whi, slo, shi, xlo, xhi, klo, khi,
                 tlo, thi, qlklo, qlkhi,
                 b0, b1, b2, b3, g0, g1, g2, g3, l0, l1, l2, l3):
            beta_d = _ext_scal(G, b0, b1, b2, b3)
            gamma_d = _ext_scal(G, g0, g1, g2, g3)
            lam_d = _ext_scal(G, l0, l1, l2, l3)
            return round2_body(self, (wlo, whi), (slo, shi), (xlo, xhi),
                               (klo, khi), (tlo, thi), (qlklo, qlkhi),
                               beta_d, gamma_d, lam_d)

        if self.has_lookups:
            tdev, qdev = self.table_dev, self.qlk_dev
        else:
            z = G.xp.zeros((n,), G.xp.uint32)
            zz = self.place((z, z))
            tdev, qdev = zz, zz
        lam = lam or (0, 0)
        args = (*wires_dev, *self.sigma_dev, *self.x_h, *self.k_dev,
                *tdev, *qdev,
                *_ext_arg(beta), *_ext_arg(gamma), *_ext_arg(lam))
        in_specs = ((PS(self.axis, None),) * 4 + (PS(self.axis),) * 2 +
                    (PS(),) * 2 + (PS(self.axis),) * 4 + (PS(),) * 12)
        fn = self._smjit(("sround2",), body, in_specs,
                         (PS(self.axis, None),) * 2)
        self._manual_scan = True
        try:
            return fn(*args)
        finally:
            self._manual_scan = False

    # the cross-row scans inside round2_body: local scan + one all_gather of
    # per-shard totals (manual mode, set while tracing the shard_map body)

    def _manual_excl_scan(self, vals, is_product: bool):
        import jax
        import jax.numpy as jnp
        G, E = self.G, self.E
        S = self._nshards
        base = prefix_product_ext if is_product else prefix_sum_ext
        n_loc = vals[0][0].shape[0]
        incl = base(G, E, True, vals, int(n_loc).bit_length() - 1)
        tot = tuple(tuple(c[-1:] for c in comp) for comp in incl)
        gat = tuple(tuple(jax.lax.all_gather(c, self.axis) for c in comp)
                    for comp in tot)  # leaves (S, 1)
        idx = jax.lax.axis_index(self.axis)
        fold = E.mul if is_product else E.add
        neutral = ((jnp.full((1,), 1 if is_product else 0, jnp.uint32),
                    jnp.zeros((1,), jnp.uint32)),
                   (jnp.zeros((1,), jnp.uint32), jnp.zeros((1,), jnp.uint32)))
        terms = []
        for j in range(S):
            tj = tuple(tuple(c[j] for c in comp) for comp in gat)
            terms.append(E.select(idx > j, tj, neutral))
        off = tree_fold(fold, terms)      # exclusive cross-shard offset (1,)
        y = fold(incl, off)               # inclusive scan with global offset

        def shift(comp, fill):
            return (jnp.concatenate([fill[0], comp[0][:-1]]),
                    jnp.concatenate([fill[1], comp[1][:-1]]))

        return (shift(y[0], off[0]), shift(y[1], off[1]))

    def exclusive_prefix_product(self, ratio):
        if self._manual_scan:
            return self._manual_excl_scan(ratio, True)
        return super().exclusive_prefix_product(ratio)

    def exclusive_prefix_sum(self, vals):
        if self._manual_scan:
            return self._manual_excl_scan(vals, False)
        return super().exclusive_prefix_sum(vals)

    def quotient_phase(self, wires_lde, z_lde, pi_vals, beta, gamma, lam,
                       alpha):
        import jax
        import jax.numpy as jnp
        from jax import lax
        from jax.sharding import PartitionSpec as PS
        from ..field.ext import e_pow
        from ..prover.ntt import coset_lde, intt

        G = self.G
        n, m = self.n, self.m
        S = self._nshards
        rate = self.config.rate
        rate_bits = self.config.rate_bits
        nch = self.num_chunks
        const_lde = self.constants_oracle.lde
        ncons = self.num_constraints
        alphas = [e_pow(alpha, i) for i in range(ncons)]
        al = np.array([a[0] & 0xFFFFFFFF for a in alphas], np.uint32)
        ah = np.array([a[0] >> 32 for a in alphas], np.uint32)
        il = np.array([a[1] & 0xFFFFFFFF for a in alphas], np.uint32)
        ih = np.array([a[1] >> 32 for a in alphas], np.uint32)
        lam = lam or (0, 0)
        pi_dev = self.place(_mat_to_dev(G, pi_vals.reshape(n, 1)))
        al4 = (G.xp.asarray(al), G.xp.asarray(ah),
               G.xp.asarray(il), G.xp.asarray(ih))
        blk = m // S
        # round the (env-overridable) chunk down to a power of two <= blk so
        # it always divides the local block — a non-divisor chunk would make
        # lax.dynamic_slice clamp the last chunk and break the reshape
        chunk = min(quotient_chunk_rows(self), blk)
        chunk = 1 << (chunk.bit_length() - 1)
        perm = [(s, (s - 1) % S) for s in range(S)]

        has_twi = _fourstep_ok(m, S)

        def body(clo, chi, wlo, whi, zlo, zhi, pilo, pihi, xlo, xhi,
                 klo, khi, zhilo, zhihi, zhlo, zhhi,
                 b0, b1, b2, b3, g0, g1, g2, g3, la0, la1, la2, la3,
                 alr, ahr, ali, ahi_, *ntt_consts):
            ntt_consts = list(ntt_consts)
            twi = (ntt_consts.pop(0), ntt_consts.pop(0)) if has_twi else None
            spi_loc = (ntt_consts.pop(0), ntt_consts.pop(0))
            beta_d = _ext_scal(G, b0, b1, b2, b3)
            gamma_d = _ext_scal(G, g0, g1, g2, g3)
            lam_d = _ext_scal(G, la0, la1, la2, la3)
            alphas4 = (alr, ahr, ali, ahi_)
            # ---- PI coset LDE: gather the (n, 1) column, replicate the tiny
            # INTT+LDE, keep this shard's row block ----
            pi_full = self._gather_rows((pilo, pihi))
            pi_lde_full = coset_lde(G, intt(G, pi_full), rate_bits)
            pi_loc = self._my_block(pi_lde_full, m)
            # ---- zg: boundary exchange, one ppermute of `rate` rows ----
            send = (zlo[:rate], zhi[:rate])
            recv = (lax.ppermute(send[0], self.axis, perm),
                    lax.ppermute(send[1], self.axis, perm))
            zg = (jnp.concatenate([zlo[rate:], recv[0]], axis=0),
                  jnp.concatenate([zhi[rate:], recv[1]], axis=0))

            def rows(sl):
                def s(a):
                    return lax.dynamic_slice_in_dim(a, sl, chunk, 0)
                return quotient_rows_body(
                    self, (s(clo), s(chi)), (s(wlo), s(whi)),
                    (s(zlo), s(zhi)), (s(zg[0]), s(zg[1])),
                    (s(pi_loc[0]), s(pi_loc[1])), (s(xlo), s(xhi)),
                    (klo, khi), (s(zhilo), s(zhihi)), (s(zhlo), s(zhhi)),
                    beta_d, gamma_d, lam_d, alphas4)

            if blk <= chunk:
                t_loc = rows(0)
            else:
                starts = jnp.arange(0, blk, chunk, dtype=jnp.int32)
                parts = lax.map(rows, starts)
                t_loc = ((parts[0][0].reshape(blk), parts[0][1].reshape(blk)),
                         (parts[1][0].reshape(blk), parts[1][1].reshape(blk)))
            # ---- t(x) -> quotient chunk coefficient columns ----
            t_mat = (jnp.stack([t_loc[0][0], t_loc[1][0]], axis=1),
                     jnp.stack([t_loc[0][1], t_loc[1][1]], axis=1))
            tc = self._coset_intt_blocks(t_mat, m, spi_loc, twi)  # (m/S, 2)
            tc_full = self._gather_rows(tc)             # (m, 2) replicated
            idx = lax.axis_index(self.axis)
            row0 = idx * (n // S)

            def chunk_col(a, k, c):
                # index dtypes pinned: under x64 the python-int offsets
                # promote to int64 while axis_index is int32
                return lax.dynamic_slice(
                    a, (jnp.int32(k * n) + row0, jnp.int32(c)), (n // S, 1))

            q_lo = jnp.concatenate(
                [chunk_col(tc_full[0], k, 0) for k in range(nch)] +
                [chunk_col(tc_full[0], k, 1) for k in range(nch)], axis=1)
            q_hi = jnp.concatenate(
                [chunk_col(tc_full[1], k, 0) for k in range(nch)] +
                [chunk_col(tc_full[1], k, 1) for k in range(nch)], axis=1)
            return q_lo, q_hi

        consts = self._quotient_operands()
        args = (*const_lde, *wires_lde, *z_lde,
                pi_dev[0].reshape(n), pi_dev[1].reshape(n),
                *self.x_lde, *self.k_dev, *self.zh_inv_lde, *self.zh_lde,
                *_ext_arg(beta), *_ext_arg(gamma), *_ext_arg(lam), *al4,
                *(c for c, _ in consts))
        in_specs = ((PS(self.axis, None),) * 6 + (PS(self.axis),) * 2 +
                    (PS(self.axis),) * 2 + (PS(),) * 2 +
                    (PS(self.axis),) * 4 + (PS(),) * 16 +
                    tuple(s for _, s in consts))
        fn = self._smjit(("squotient", chunk), body, in_specs,
                         (PS(self.axis, None),) * 2)
        return fn(*args)

    def _quotient_operands(self):
        from jax.sharding import PartitionSpec as PS
        m = self.m
        S = self._nshards
        ops = []
        if _fourstep_ok(m, S):
            tw = self._ntt_const("tw_i", m)
            ops += [(tw[0], PS(None, self.axis)), (tw[1], PS(None, self.axis))]
        spi = self._ntt_const("shift_inv", m)
        ops += [(spi[0], PS(self.axis)), (spi[1], PS(self.axis))]
        return ops

    def open_at(self, oracle: Oracle, pows):
        import jax
        from jax.sharding import PartitionSpec as PS
        G = self.G

        def body(lo, hi, prl, prh, pil, pih):
            re_p, im_p = open_body(self, (lo, hi), (prl, prh), (pil, pih))
            # (C,) partials -> (S, C) -> exact tree reduction
            re_g = tuple(jax.lax.all_gather(c, self.axis) for c in re_p)
            im_g = tuple(jax.lax.all_gather(c, self.axis) for c in im_p)
            re = sum_rows(G, re_g)
            im = sum_rows(G, im_g)
            return (*re, *im)

        shape = tuple(oracle.coeffs[0].shape)
        fn = self._smjit(("sopen", shape), body,
                         (PS(self.axis, None),) * 2 + (PS(self.axis),) * 4,
                         (PS(),) * 4)
        o = fn(*oracle.coeffs, *pows[0], *pows[1])
        re64 = _from_dev_u64(G, (o[0], o[1]))
        im64 = _from_dev_u64(G, (o[2], o[3]))
        return [(int(a), int(b)) for a, b in zip(re64, im64)]

    def fri_combine(self, lde_list, alphas, y1, y2, zeta, gzeta, z_lde):
        import jax
        from jax.sharding import PartitionSpec as PS
        G = self.G
        widths = [p[0].shape[1] for p in lde_list]
        n_oracles = len(lde_list)
        a_lo_re = np.array([a[0] & 0xFFFFFFFF for a in alphas], np.uint32)
        a_hi_re = np.array([a[0] >> 32 for a in alphas], np.uint32)
        a_lo_im = np.array([a[1] & 0xFFFFFFFF for a in alphas], np.uint32)
        a_hi_im = np.array([a[1] >> 32 for a in alphas], np.uint32)

        def body(*args):
            mats = [(args[2 * i], args[2 * i + 1]) for i in range(n_oracles)]
            (zlo, zhi, xlo, xhi, alr, ahr, ali, ahi_,
             y1r0, y1r1, y1i0, y1i1, y2r0, y2r1, y2i0, y2i1,
             ze0, ze1, ze2, ze3, gz0, gz1, gz2, gz3) = args[2 * n_oracles:]
            y1d = _ext_scal(G, y1r0, y1r1, y1i0, y1i1)
            y2d = _ext_scal(G, y2r0, y2r1, y2i0, y2i1)
            zeta_d = _ext_scal(G, ze0, ze1, ze2, ze3)
            gz_d = _ext_scal(G, gz0, gz1, gz2, gz3)
            F = fri_combine_body(self, mats, (zlo, zhi), (xlo, xhi),
                                 (alr, ahr, ali, ahi_), y1d, y2d,
                                 zeta_d, gz_d)
            return F[0][0], F[0][1], F[1][0], F[1][1]

        def u32(v):
            return np.uint32(v)

        y1a = (u32(y1[0] & 0xFFFFFFFF), u32(y1[0] >> 32),
               u32(y1[1] & 0xFFFFFFFF), u32(y1[1] >> 32))
        y2a = (u32(y2[0] & 0xFFFFFFFF), u32(y2[0] >> 32),
               u32(y2[1] & 0xFFFFFFFF), u32(y2[1] >> 32))
        flat = []
        for p in lde_list:
            flat.extend(p)
        in_specs = ((PS(self.axis, None),) * (2 * n_oracles) +
                    (PS(self.axis, None),) * 2 + (PS(self.axis),) * 2 +
                    (PS(),) * 20)
        fn = self._smjit(("sfricombine", tuple(widths)), body, in_specs,
                         (PS(self.axis),) * 4)
        o = fn(*flat, *z_lde, *self.x_lde,
               G.xp.asarray(a_lo_re), G.xp.asarray(a_hi_re),
               G.xp.asarray(a_lo_im), G.xp.asarray(a_hi_im),
               *y1a, *y2a, *_ext_arg(zeta), *_ext_arg(gzeta))
        # FRI layers run replicated (they shrink geometrically; the sharded
        # bit-exact fold/commit kernels live in parallel/fri.py) — gather F
        # once so the inherited fold/commit/grind programs compile as plain
        # replicated single-device programs.
        rep = [jax.device_put(c, self._replicated) for c in o]
        return ((rep[0], rep[1]), (rep[2], rep[3]))


def prove_sharded(spk: ShardedProvingKey, external_values: np.ndarray,
                  check_constraints: bool = False, timer=None):
    """Full multi-chip prove: identical pipeline and transcript to
    prove.prove(); the ShardedProvingKey's phase programs run SPMD over the
    mesh with explicit collectives."""
    return prove(spk, external_values, check_constraints=check_constraints,
                 timer=timer)
