"""Sharded prover phases: multi-chip wire commitment (INTT -> LDE -> Poseidon
Merkle cap) over a (dp, sp) mesh.

dp shards independent witness batches; sp shards the
polynomial domain (trace rows) — the prover's true scaling axis (SURVEY.md
§5).  Each four-step NTT phase rides exactly one all_to_all; leaf
hashing stays local; each sp shard contributes one subtree root to the cap
via all_gather.

Layout algebra (four-step NTT, see parallel/mesh.py):
  input  x[i] on an (A, B) grid at [i1, i2], i = i1*B + i2, i2 sharded;
  output X[k] on a (B, A) grid at [k2, k1], k = k1 + A*k2, k1 sharded.
Since k sits at row-major position k2*A + k1 of the transposed grid, an
all_gather along the k1 axis followed by a flatten IS natural order.  The
sharded Merkle leaf order is the device-major local flatten
l = s*(B*A/d) + k2*(A/d) + k1_loc, a fixed public permutation of the domain
(leaf_permutation below).
"""

from __future__ import annotations

import numpy as np

from ..field import gl as _gl
from ..field.gl import make_gl
from ..field.poseidon import make_poseidon
from ..circuit.compile import powers_u64
from .mesh import _twiddle_matrix


def _split(u64):
    return ((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u64 >> np.uint64(32)).astype(np.uint32))


def grid_dims(n: int):
    """Split n = A*B with A <= B, both powers of two."""
    lg = n.bit_length() - 1
    A = 1 << (lg // 2)
    return A, n // A


def leaf_permutation(m: int, d: int) -> np.ndarray:
    """leaf index l -> domain index k for the sharded commit of an m-point
    LDE over d sp-shards (device-major transposed four-step layout)."""
    A, B = grid_dims(m)
    al = A // d
    s, k2, k1l = np.meshgrid(np.arange(d), np.arange(B), np.arange(al),
                             indexing="ij")
    k1 = s * al + k1l
    return (k1 + A * k2).reshape(-1)


def make_sharded_wire_commit(mesh, n: int, num_cols: int, rate_bits: int = 3):
    """Jitted (dp, sp)-sharded wire-commit step.

    run(wires_lo, wires_hi): (Bt, n, C) uint32 arrays, Bt sharded over dp,
    returns (caps_lo, caps_hi, evals_lo, evals_hi) with caps (Bt, d, 4) and
    evals (Bt, m//? ...) left in the sharded transposed layout.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from ..prover.ntt import ntt

    G = make_gl(jnp)
    H = make_poseidon(G)
    d = mesh.shape["sp"]
    m = n << rate_bits
    A, B = grid_dims(n)
    Am, Bm = grid_dims(m)
    assert B % d == 0 and A % d == 0 and Bm % d == 0 and Am % d == 0

    tw_i = _twiddle_matrix(A, B, inverse=True)
    tw_f = _twiddle_matrix(Am, Bm, inverse=False)
    shift_pows = powers_u64(_gl.MULTIPLICATIVE_GENERATOR, m)

    consts = tuple(map(lambda u: tuple(_split(u)), (tw_i, tw_f)))
    sp_lo, sp_hi = _split(shift_pows)

    def four_step(lo, hi, tlo, thi, inverse):
        """(Agrid, Bloc, C) column-sharded -> (Bgrid, Agrid/d, C)."""

        def nttc(x, y):
            s = x.shape
            r = ntt(G, (x.reshape(s[0], -1), y.reshape(s[0], -1)),
                    inverse=inverse)
            return r[0].reshape(s), r[1].reshape(s)

        glo, ghi = nttc(lo, hi)
        glo, ghi = G.mul((glo, ghi), (tlo[:, :, None], thi[:, :, None]))

        def a2a(x):
            return jax.lax.all_to_all(x, "sp", split_axis=0, concat_axis=1,
                                      tiled=True)

        glo, ghi = a2a(glo), a2a(ghi)          # (Agrid/d, Bgrid, C)
        glo = jnp.swapaxes(glo, 0, 1)          # (Bgrid, Agrid/d, C)
        ghi = jnp.swapaxes(ghi, 0, 1)
        return nttc(glo, ghi)

    (ti_lo, ti_hi), (tf_lo, tf_hi) = consts

    def local_step(wlo, whi, tilo, tihi, tflo, tfhi, splo, sphi):
        # wlo: (Bloc_dp, A, B/d, C)

        def per_batch(lo3, hi3):
            # ---- INTT ----
            clo, chi = four_step(lo3, hi3, tilo, tihi, True)  # (B, A/d, C)
            # gather coeffs: all_gather along k1 axis -> (B, A, C); row-major
            # flatten of [j2, j1] is j2*A + j1 = natural coeff index j
            alo = jax.lax.all_gather(clo, "sp", axis=1, tiled=True)
            ahi = jax.lax.all_gather(chi, "sp", axis=1, tiled=True)
            C = alo.shape[-1]
            nat_lo = alo.reshape(n, C)
            nat_hi = ahi.reshape(n, C)
            # ---- pad + coset scale ----
            z = jnp.zeros((m - n, C), jnp.uint32)
            flo = jnp.concatenate([nat_lo, z], axis=0)
            fhi = jnp.concatenate([nat_hi, z], axis=0)
            flo, fhi = G.mul((flo, fhi), (splo[:, None], sphi[:, None]))
            # ---- forward NTT on the (Am, Bm) grid, local column slice ----
            grid_lo = flo.reshape(Am, Bm, C)
            grid_hi = fhi.reshape(Am, Bm, C)
            s = jax.lax.axis_index("sp")
            col0 = s * (Bm // d)
            loc_lo = jax.lax.dynamic_slice_in_dim(grid_lo, col0, Bm // d, 1)
            loc_hi = jax.lax.dynamic_slice_in_dim(grid_hi, col0, Bm // d, 1)
            elo, ehi = four_step(loc_lo, loc_hi, tflo, tfhi, False)
            # ---- local Merkle subtree -> per-shard root -> cap ----
            rows = Bm * (Am // d)
            leaf_lo = elo.reshape(rows, C)
            leaf_hi = ehi.reshape(rows, C)
            dlo, dhi = H.hash_no_pad((leaf_lo.T, leaf_hi.T))  # (4, rows)
            size = rows
            while size > 1:
                dlo, dhi = H.two_to_one((dlo[:, 0::2], dhi[:, 0::2]),
                                        (dlo[:, 1::2], dhi[:, 1::2]))
                size //= 2
            caps_lo = jax.lax.all_gather(dlo[:, 0], "sp")  # (d, 4)
            caps_hi = jax.lax.all_gather(dhi[:, 0], "sp")
            return caps_lo, caps_hi, elo, ehi

        outs = [per_batch(wlo[i], whi[i]) for i in range(wlo.shape[0])]
        stack = lambda k: jnp.stack([o[k] for o in outs])
        return stack(0), stack(1), stack(2), stack(3)

    fn = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(PS("dp", None, "sp", None), PS("dp", None, "sp", None),
                  PS(None, "sp"), PS(None, "sp"), PS(None, "sp"),
                  PS(None, "sp"), PS(None), PS(None)),
        out_specs=(PS("dp", None, None), PS("dp", None, None),
                   PS("dp", None, "sp", None), PS("dp", None, "sp", None)),
        check_vma=False))

    def run(wires_lo, wires_hi):
        import jax.numpy as jnp
        Bt = wires_lo.shape[0]
        wl = wires_lo.reshape(Bt, A, B, num_cols)
        wh = wires_hi.reshape(Bt, A, B, num_cols)
        return fn(wl, wh,
                  jnp.asarray(ti_lo), jnp.asarray(ti_hi),
                  jnp.asarray(tf_lo), jnp.asarray(tf_hi),
                  jnp.asarray(sp_lo), jnp.asarray(sp_hi))

    run.grid = (A, B, Am, Bm)
    return run
