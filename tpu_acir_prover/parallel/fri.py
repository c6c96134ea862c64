"""Sharded FRI: layer commit + fold over the sp (domain) mesh axis.

The single-chip FRI (prover/fri.py, prove.py fri_commit_layer/fri_fold)
keeps each layer as a GF(p^2) value vector on the coset in natural order;
leaf j of a layer tree packs the fold pair (F(x_j), F(-x_j)) = rows j and
j+h.  Sharding the domain as contiguous row blocks over d devices makes a
fold step exactly TWO ppermutes between devices:

  1. pair exchange: shard s >= d/2 ships its block to s - d/2, so each low
     shard holds both halves of its pairs (the +/- coset points);
  2. rebalance: each low shard splits its folded block in two and ships the
     halves to shards 2s and 2s+1, restoring even natural-order sharding
     for the next layer.

Leaf hashing and the Merkle subtree reduction stay local; each low shard
contributes cap_total/(d/2) cap digests via one all_gather.  Caps and
folded values are bit-identical to the single-chip path (test_parallel_fri),
so a multi-chip prover emits byte-identical proofs.

This is the SPMD replacement for the reference fork's rayon-parallel
FRI (SURVEY.md §2.3 "FRI commit/fold/query", §2.4).
"""

from __future__ import annotations

import numpy as np

from ..field import gl as _gl
from ..field.gl import P, make_gl
from ..field.poseidon import make_poseidon
from ..circuit.compile import powers_u64

_HALF = (P + 1) // 2


def layer_inv2x_padded(m_l: int, shift: int) -> np.ndarray:
    """inv2x[j] = 1/(2*shift*w^j) for j < h, zero-padded to m_l so the
    array shards identically to the layer values."""
    h = m_l // 2
    w_inv = _gl.s_inv(_gl.root_of_unity(m_l.bit_length() - 1))
    base = powers_u64(w_inv, h)
    scale = _gl.s_inv((2 * shift) % P)
    lo = (base & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (base >> np.uint64(32)).astype(np.uint32)
    G = _gl.make_gl(np)
    vals = G.to_u64(G.mul((lo, hi), G.const(scale, base.shape)))
    return np.concatenate([np.asarray(vals, dtype=np.uint64),
                           np.zeros(h, dtype=np.uint64)])


def make_sharded_fri_layer(mesh, m_l: int, cap_height: int):
    """Jitted sharded FRI layer step: commit the current layer (cap out)
    and fold it with beta (next layer out, evenly resharded).

    run(values_ext, inv2x_dev, beta) with values_ext = ((rl, rh), (il, ih))
    of shape (m_l,) sharded over "sp"; returns (caps_u64 list, next_ext).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    G = make_gl(jnp)
    E_mulbase_HALF = G.const(_HALF, (1,))
    H = make_poseidon(G)
    from ..field.ext import make_ext
    E = make_ext(G)

    d = mesh.shape["sp"]
    assert d >= 2 and d % 2 == 0, "sp axis must be even"
    h = m_l // 2
    blk = m_l // d
    cap_total = 1 << min(cap_height, h.bit_length() - 1)
    assert cap_total >= d // 2, \
        f"cap {cap_total} smaller than low-half shard count {d//2}"
    cps = cap_total // (d // 2)          # cap entries per low shard
    assert blk >= cps and blk % cps == 0

    lowperm = [(i + d // 2, i) for i in range(d // 2)]
    rebalance_a = [(s, 2 * s) for s in range(d // 2)]
    rebalance_b = [(s, 2 * s + 1) for s in range(d // 2)]

    def local(rl, rh, il, ih, xl, xh, b0, b1, b2, b3):
        def pget(x, perm):
            return jax.lax.ppermute(x, "sp", perm)

        # 1. pair exchange: low shard s gains the partner block (rows j+h)
        prl, prh, pil, pih = (pget(v, lowperm) for v in (rl, rh, il, ih))
        v0 = ((rl, rh), (il, ih))
        v1 = ((prl, prh), (pil, pih))

        # 2. layer commit: leaf rows [v0.re, v0.im, v1.re, v1.im]
        leaf_lo = jnp.stack([rl, il, prl, pil], axis=0)        # (4, blk)
        leaf_hi = jnp.stack([rh, ih, prh, pih], axis=0)
        dlo, dhi = H.hash_no_pad((leaf_lo, leaf_hi))           # (4, blk)
        size = blk
        while size > cps:
            dlo, dhi = H.two_to_one((dlo[:, 0::2], dhi[:, 0::2]),
                                    (dlo[:, 1::2], dhi[:, 1::2]))
            size //= 2
        caps_lo = jax.lax.all_gather(dlo, "sp")                # (d, 4, cps)
        caps_hi = jax.lax.all_gather(dhi, "sp")

        # 3. fold: out = (v0+v1)/2 + beta*(v0-v1)*inv2x
        s_ = E.add(v0, v1)
        df = E.sub(v0, v1)
        beta_d = ((b0.reshape(()), b1.reshape(())),
                  (b2.reshape(()), b3.reshape(())))
        out = E.add(E.mul_base(s_, E_mulbase_HALF),
                    E.mul(beta_d, E.mul_base(df, (xl, xh))))

        # 4. rebalance: block halves to shards 2s and 2s+1
        halfb = blk // 2

        def reshard(x):
            return (pget(x[:halfb], rebalance_a) +
                    pget(x[halfb:], rebalance_b))

        nrl, nrh = reshard(out[0][0]), reshard(out[0][1])
        nil, nih = reshard(out[1][0]), reshard(out[1][1])
        return caps_lo, caps_hi, nrl, nrh, nil, nih

    sh = PS("sp")
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(sh, sh, sh, sh, sh, sh, PS(), PS(), PS(), PS()),
        out_specs=(PS(), PS(), sh, sh, sh, sh), check_vma=False))

    def run(values_ext, inv2x_dev, beta):
        b = [jnp.uint32(beta[0] & 0xFFFFFFFF), jnp.uint32(beta[0] >> 32),
             jnp.uint32(beta[1] & 0xFFFFFFFF), jnp.uint32(beta[1] >> 32)]
        (rl, rh), (il, ih) = values_ext
        caps_lo, caps_hi, *next_ = fn(rl, rh, il, ih, *inv2x_dev, *b)
        # low half shards hold the real cap slices, in natural order
        cl = np.asarray(caps_lo[:d // 2])
        ch = np.asarray(caps_hi[:d // 2])
        caps = []
        for s in range(d // 2):
            for j in range(cps):
                u = [int(cl[s, k, j]) + (int(ch[s, k, j]) << 32)
                     for k in range(4)]
                caps.append(tuple(v % (1 << 64) for v in u))
        nrl, nrh, nil, nih = next_
        return caps, ((nrl, nrh), (nil, nih))

    run.layer_size = m_l
    return run


def fri_chain_plan(m: int, d: int, final_domain: int):
    """Layer sizes the sharded chain can fold (block sizes must stay even
    and divisible); the remainder folds on one device, like the single-chip
    tail of the hybrid prover."""
    sizes = []
    size = m
    while size > final_domain and (size // d) % 2 == 0 and size // d >= 2:
        sizes.append(size)
        size //= 2
    return sizes, size
