"""Poseidon Merkle trees with caps, vectorized over all nodes per level.

Analog of the reference's external plonky2 Merkle commitment (SURVEY.md
§2.3, "LDE + Merkle commitment"): leaf hashing is one batched Poseidon
sponge over every row of the LDE matrix at once, and each tree level is one
batched two_to_one compression — elementwise integer work with static
shapes.  A *cap* of 2^cap_height roots is kept (like plonky2's MerkleCap)
so multi-chip builds can hash sub-trees locally and only exchange caps.
"""

from __future__ import annotations

import numpy as np

from ..field.poseidon import hash_no_pad_ints, two_to_one_ints, DIGEST

# jitted tree-query programs, shared across trees with identical shapes
_QUERY_JITS = {}

# bulk chunk for the heap-loop level builder (nodes hashed per iteration)
_HEAP_CHUNK = 1 << 13


def leaf_digests(H, matrix):
    """(M, C) matrix pair -> (DIGEST, M) leaf digests (one batched sponge
    over every row)."""
    lo, hi = matrix
    return H.hash_no_pad((lo.T, hi.T))


def merkle_levels(H, leaf, cap_size: int, chunk: int = _HEAP_CHUNK):
    """All digest levels above (and including) a (DIGEST, M) leaf level,
    down to `cap_size` nodes, as a traceable function.

    levels[0] = leaf, levels[-1] = cap; bit-identical to the naive
    per-level two_to_one loop.  On the jax backend the levels are built in
    a HEAP layout (node i's children at 2i, 2i+1) with two rolled loops —
    a bulk fori_loop hashing `chunk` nodes per step in descending order
    (children of [s, s+c) live at [2s, 2s+2c), always already computed)
    and a masked top loop for the < chunk levels — so a whole tree traces
    TWO two_to_one bodies instead of log2(M) of them.  A bare Poseidon
    permutation is ~2.6k jaxpr eqns of limb arithmetic; the unrolled
    per-level loop dominated commit-program compile times (75 s per
    sharded commit on a 2-core host)."""
    xp = H.G.xp
    lo, hi = leaf
    M = lo.shape[1]
    levels = [leaf]
    if M <= cap_size:
        return levels
    is_jax = "jax" in getattr(xp, "__name__", "")
    n_levels = (M // cap_size).bit_length() - 1
    if not is_jax or M // 2 <= max(cap_size, 2):
        cur = leaf
        size = M
        while size > cap_size:
            cur = H.two_to_one((cur[0][:, 0::2], cur[1][:, 0::2]),
                               (cur[0][:, 1::2], cur[1][:, 1::2]))
            levels.append(cur)
            size //= 2
        return levels

    from jax import lax
    import jax.numpy as jnp
    D = lo.shape[0]
    c = min(chunk, M // 2)
    # heap: (D, 2M); [M, 2M) = leaves, internal node i at [i] for i in [1, M)
    heap = (xp.concatenate([xp.zeros((D, M), xp.uint32), lo], axis=1),
            xp.concatenate([xp.zeros((D, M), xp.uint32), hi], axis=1))

    def bulk_body(k, hp):
        s = M - (k + 1) * c
        kids_lo = lax.dynamic_slice(hp[0], (0, 2 * s), (D, 2 * c))
        kids_hi = lax.dynamic_slice(hp[1], (0, 2 * s), (D, 2 * c))
        par = H.two_to_one((kids_lo[:, 0::2], kids_hi[:, 0::2]),
                           (kids_lo[:, 1::2], kids_hi[:, 1::2]))
        return (lax.dynamic_update_slice(hp[0], par[0], (0, s)),
                lax.dynamic_update_slice(hp[1], par[1], (0, s)))

    # bulk covers nodes [c, M): levels of size >= c
    heap = lax.fori_loop(0, M // c - 1, bulk_body, heap)

    if cap_size < c:
        # top: nodes [cap_size, c) in the (D, 2c) heap prefix; iteration t
        # computes ALL c candidate parents but merges in only the row range
        # of the one level actually ready ([c >> (t+1), c >> t)) — fixed
        # shapes, one traced body, ~c*log extra hashes (noise: c is small)
        seg = (heap[0][:, :2 * c], heap[1][:, :2 * c])
        iota = jnp.arange(c, dtype=jnp.int32)
        T = (c // cap_size).bit_length() - 1

        def top_body(t, sg):
            par = H.two_to_one((sg[0][:, 0:2 * c:2], sg[1][:, 0:2 * c:2]),
                               (sg[0][:, 1:2 * c:2], sg[1][:, 1:2 * c:2]))
            lo_b = c >> (t + 1)
            hi_b = c >> t
            m = (iota >= lo_b) & (iota < hi_b)
            return (xp.concatenate([xp.where(m, par[0], sg[0][:, :c]),
                                    sg[0][:, c:]], axis=1),
                    xp.concatenate([xp.where(m, par[1], sg[1][:, :c]),
                                    sg[1][:, c:]], axis=1))

        seg = lax.fori_loop(0, T, top_body, seg)
        heap = (xp.concatenate([seg[0], heap[0][:, 2 * c:]], axis=1),
                xp.concatenate([seg[1], heap[1][:, 2 * c:]], axis=1))

    for l in range(1, n_levels + 1):
        size = M >> l
        levels.append((heap[0][:, size:2 * size], heap[1][:, size:2 * size]))
    return levels


class MerkleTree:
    """Committed matrix + digest levels (device-resident backend arrays).

    levels[0] = leaf digests, levels[-1] = cap; each level is a stacked
    (lo, hi) pair of shape (DIGEST, size).
    """

    def __init__(self, G, leaves_lo, leaves_hi, levels, cap_height):
        self.G = G
        self.leaves_lo = leaves_lo  # (M, C) uint32
        self.leaves_hi = leaves_hi
        self.levels = levels
        self.cap_height = cap_height
        self._host_levels = None
        # single-slot cache: rows_u64/paths_for share one gather per proof,
        # but query indices are fresh per proof and trees (e.g. the
        # constants oracle) can outlive many proofs — an unbounded dict
        # would leak one result set per proof
        self._query_cache = (None, None)

    @property
    def num_leaves(self):
        return self.leaves_lo.shape[0]

    def cap_u64(self):
        """Cap digests as host numpy uint64 (cap_size, DIGEST)."""
        lo, hi = self.levels[-1]
        return np.asarray(self.G.to_u64((lo, hi))).T

    def rows_u64(self, indices):
        """Gather leaf rows for many indices: (len(indices), C) uint64."""
        return self.rows_and_paths(indices)[0]

    def open_row(self, index: int):
        """Merkle path for leaf `index`: (leaf_values_u64, path) where path is
        a list of sibling digests (uint64[DIGEST]) from leaf level up to cap."""
        rows, paths = self.rows_and_paths([index])
        return rows[0], paths[0]

    def paths_for(self, indices):
        """Merkle paths for many leaves (see rows_and_paths)."""
        return self.rows_and_paths(indices)[1]

    def rows_and_paths(self, indices):
        """Leaf rows + sibling paths for many indices as ONE jitted device
        program and ONE device->host transfer per tree (query assembly moves
        few bytes, so its cost is the number of launches and transfers)."""
        G = self.G
        xp = G.xp
        key = tuple(indices)
        if self._query_cache[0] == key:
            return self._query_cache[1]
        idx_np = np.asarray(indices, dtype=np.int32)
        nlev = len(self.levels) - 1

        def run(idx, llo, lhi, *levs):
            row_lo = xp.take(llo, idx, axis=0)
            row_hi = xp.take(lhi, idx, axis=0)
            cur = idx
            outs_lo, outs_hi = [], []
            for l in range(nlev):
                sib = cur ^ 1
                outs_lo.append(xp.take(levs[2 * l], sib, axis=1))
                outs_hi.append(xp.take(levs[2 * l + 1], sib, axis=1))
                cur = cur >> 1
            if not outs_lo:
                z = xp.zeros((0, idx.shape[0]), xp.uint32)
                return row_lo, row_hi, z, z
            return (row_lo, row_hi, xp.concatenate(outs_lo, axis=0),
                    xp.concatenate(outs_hi, axis=0))

        is_jax = "jax" in getattr(xp, "__name__", "")
        if is_jax:
            import jax
            jkey = ("treequery", nlev, self.leaves_lo.shape, len(idx_np))
            fn = _QUERY_JITS.get(jkey)
            if fn is None:
                fn = jax.jit(run)
                _QUERY_JITS[jkey] = fn
        else:
            fn = run
        flat_levels = [c for lev in self.levels[:-1] for c in lev]
        row_lo, row_hi, cat_lo, cat_hi = fn(
            xp.asarray(idx_np), self.leaves_lo, self.leaves_hi, *flat_levels)
        rows = np.asarray(G.to_u64((row_lo, row_hi)))
        flat = np.asarray(G.to_u64((cat_lo, cat_hi)))
        paths = [[flat[4 * l:4 * (l + 1), q] for l in range(nlev)]
                 for q in range(len(indices))]
        self._query_cache = (key, (rows, paths))
        return rows, paths


def merkle_commit(G, H, matrix, cap_height: int) -> MerkleTree:
    """Commit to a (M, C) matrix of field values ((lo, hi) uint32 arrays).

    Leaf i hashes row i (all C values); levels are built until 2^cap_height
    nodes remain.
    """
    lo, hi = matrix
    m, c = lo.shape
    log_m = int(m).bit_length() - 1
    assert (1 << log_m) == m
    assert cap_height <= log_m
    digest = H.hash_no_pad((lo.T, hi.T))  # stacked (DIGEST, M)
    levels = [digest]
    cur = digest
    size = m
    while size > (1 << cap_height):
        left = (cur[0][:, 0::2], cur[1][:, 0::2])
        right = (cur[0][:, 1::2], cur[1][:, 1::2])
        cur = H.two_to_one(left, right)
        levels.append(cur)
        size >>= 1
    return MerkleTree(G, lo, hi, levels, cap_height)


def verify_merkle_path(leaf_values_u64, index: int, path, cap_u64) -> bool:
    """Check a Merkle path against a cap (host side, scalar Poseidon).

    NB: no np.asarray on python-int inputs — numpy 2.x silently coerces
    ints >= 2^63 to float64, corrupting field elements."""
    node = hash_no_pad_ints([int(v) for v in leaf_values_u64])
    idx = index
    for sib in path:
        s = tuple(int(x) for x in sib)
        node = two_to_one_ints(s, node) if (idx & 1) else two_to_one_ints(node, s)
        idx >>= 1
    expect = tuple(int(x) for x in cap_u64[idx])
    return node == expect
