"""Device-mesh runtime: sharded NTT/LDE/commit for multi-chip proving.

The reference's only parallelism is rayon threads inside its Rust fork
(SURVEY.md §2.4); the answer here is SPMD over a jax Mesh.  Axes:

  dp  - data parallel: independent proofs / witness batches
  sp  - "sequence parallel" analog: the polynomial evaluation-domain axis
        (trace rows), the true scaling axis of a FRI prover (SURVEY.md §5)

The distributed NTT uses the four-step (Bailey) decomposition: view the
size-n domain as an (a, b) matrix, do local column NTTs, twiddle, reshard
with one all_to_all, then local row NTTs.  This maps butterfly exchanges
onto a single collective instead of log(n) fine-grained ones.
"""

from __future__ import annotations

import functools

import numpy as np

from ..field import gl as _gl
from ..field.gl import P, make_gl
from ..circuit.compile import powers_u64


def _twiddle_matrix(a: int, b: int, inverse: bool) -> np.ndarray:
    """w_n^(i2*k1) twiddles, shape (a, b): rows k1, cols i2 (uint64)."""
    n = a * b
    w = _gl.root_of_unity(n.bit_length() - 1)
    if inverse:
        w = _gl.s_inv(w)
    rows = powers_u64(w, n)  # w^j for j < n
    out = np.empty((a, b), dtype=np.uint64)
    for k1 in range(a):
        out[k1] = rows[(k1 * np.arange(b)) % n]
    return out


def four_step_ntt_reference(G, values, a: int, b: int, inverse=False):
    """Single-device four-step NTT (for testing the distributed layout).

    Input: (lo, hi) of shape (n,) in natural order x[i1*b + i2].
    Output: (n,) with X[k] at position k (natural order).
    """
    from ..prover.ntt import ntt
    xp = G.xp
    lo, hi = values
    n = a * b
    # (a, b): rows i1, cols i2
    lo2, hi2 = lo.reshape(a, b), hi.reshape(a, b)
    # step 1: NTT_a along axis 0 (columns)
    g = ntt(G, (lo2, hi2), inverse=inverse)  # ntt works on (rows, C)
    # g[k1, i2]
    tw = _twiddle_matrix(a, b, inverse)
    twd = (xp.asarray((tw & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
           xp.asarray((tw >> np.uint64(32)).astype(np.uint32)))
    g = G.mul(g, twd)
    # step 3: NTT_b along axis 1: transpose to (b, a), rows i2, cols k1
    gt = (g[0].T, g[1].T)
    x = ntt(G, gt, inverse=inverse)  # (b, a): rows k2, cols k1
    # X[k1 + a*k2] = x[k2, k1]: row-major flatten is already natural order.
    # (inverse case: the two sub-NTTs divide by a and b -> total 1/n.)
    return x[0].reshape(-1), x[1].reshape(-1)


def make_sharded_ntt(mesh, axis: str, a: int, b: int, inverse=False):
    """Build a shard_map-ed four-step NTT over `axis` (sp) of the mesh.

    Values: (a, b) matrix, sharded along columns (i2) on input; output is
    the (b, a) matrix X'[k2, k1] sharded along columns (k1) — i.e. natural
    index k = k1 + a*k2 lives at out[k2, k1].  One all_to_all between the
    two local NTT phases.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from ..prover.ntt import ntt

    G = make_gl(jnp)
    d = mesh.shape[axis]
    assert b % d == 0 and a % d == 0
    tw = _twiddle_matrix(a, b, inverse)
    tw_lo = (tw & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tw_hi = (tw >> np.uint64(32)).astype(np.uint32)

    def local(lo, hi, tlo, thi):
        # lo, hi: (a, b/d) local columns; tlo/thi matching twiddle slice
        g = ntt(G, (lo, hi), inverse=inverse)
        g = G.mul(g, (tlo, thi))
        # reshard: row blocks (k1) scatter, column blocks gather -> (a/d, b)
        def a2a(x):
            return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=1,
                                      tiled=True)
        glo, ghi = a2a(g[0]), a2a(g[1])  # (a/d, b)
        x = ntt(G, (glo.T, ghi.T), inverse=inverse)  # (b, a/d)
        return x[0], x[1]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(PS(None, axis), PS(None, axis), PS(None, axis),
                  PS(None, axis)),
        out_specs=(PS(None, axis), PS(None, axis)), check_vma=False))

    def run(values):
        lo, hi = values
        import jax.numpy as jnp
        return fn(lo, hi, jnp.asarray(tw_lo), jnp.asarray(tw_hi))

    return run
