"""Batch FRI: commit/fold on the accelerator, query assembly + host verify.

This owns what the reference delegates to its external plonky2 fork's FRI
(SURVEY.md §2.3 "FRI commit/fold/query"); the design is accelerator-first:

  * the combined polynomial F and every fold layer live as GF(p^2) value
    vectors on the LDE coset in natural order, so a fold step is one
    elementwise expression over static shapes (slice halves, mul, add) —
    no gather/scatter, no data-dependent shapes;
  * each committed layer's Merkle leaf i packs the +/- coset pair
    (F(x_i), F(-x_i)) as 4 base columns, so one path authenticates a whole
    fold step;
  * proof-of-work grinding is one batched Poseidon sweep over nonzero
    candidate nonces instead of a scalar loop.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..field import gl as _gl
from ..field.ext import e_add, e_sub, e_mul
from ..field.gl import P
from ..field.poseidon import make_poseidon, RATE, WIDTH, hash_no_pad_ints
from .merkle import verify_merkle_path
from .proof import FriStep
from ..circuit.compile import powers_u64

_GNP = _gl.make_gl(np)
_HALF = (P + 1) // 2  # 1/2 mod p


def _to_dev(G, u64):
    u64 = np.asarray(u64, dtype=np.uint64)
    return (G.xp.asarray((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            G.xp.asarray((u64 >> np.uint64(32)).astype(np.uint32)))


def _mul_u64(arr: np.ndarray, scalar: int) -> np.ndarray:
    lo = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (arr >> np.uint64(32)).astype(np.uint32)
    c = _GNP.const(scalar, arr.shape)
    return _GNP.to_u64(_GNP.mul((lo, hi), c))


def grind(challenger, pow_bits: int, batch: int = 1 << 14) -> int:
    """Find a nonce whose resulting challenge has >= pow_bits leading zeros,
    with batched host Poseidon (one permutation sweep per `batch` nonces)."""
    Hnp = make_poseidon(_GNP)
    bound = np.uint64(1) << np.uint64(64 - pow_bits)
    base_state = np.array(challenger.state, dtype=np.uint64)
    buf = list(challenger.input_buf)
    k = len(buf) + 1
    assert k <= RATE
    start = 0
    while True:
        nonces = np.arange(start, start + batch, dtype=np.uint64)
        st = np.tile(base_state.reshape(WIDTH, 1), (1, batch))
        for i, v in enumerate(buf):
            st[i, :] = v
        st[k - 1, :] = nonces
        lo = (st & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (st >> np.uint64(32)).astype(np.uint32)
        out = Hnp.permute((lo, hi))
        ch = _GNP.to_u64((out[0][RATE - 1], out[1][RATE - 1]))
        hits = np.nonzero(ch < bound)[0]
        if hits.size:
            return int(nonces[hits[0]])
        start += batch


# ---------------------------------------------------------------------------
# Query-side helpers (host, python ints)


def fold_step(v0, v1, x: int, beta) -> Tuple[int, int]:
    """One verifier fold: v0 = L(x), v1 = L(-x) -> L'(x^2)."""
    s = e_add(v0, v1)
    d = e_sub(v0, v1)
    inv2x = pow(2 * x % P, P - 2, P)
    t = e_mul(beta, (d[0] * inv2x % P, d[1] * inv2x % P))
    return e_add(((s[0] * _HALF) % P, (s[1] * _HALF) % P), t)


def verify_fri_query(index: int, e0, steps: List[FriStep], betas,
                     layer_caps_u64, final_coeffs, log_m0: int,
                     shift: int, final_domain: int, rate_bits: int) -> None:
    """Check one query round: fold chain from the derived F(x) value down to
    the final polynomial.  Raises AssertionError on mismatch."""
    m = 1 << log_m0
    cur_shift = shift % P
    idx = index
    val = e0
    li = 0
    while m > final_domain:
        h = m // 2
        j = idx % h
        step = steps[li]
        leaf = [step.pair[0][0], step.pair[0][1], step.pair[1][0], step.pair[1][1]]
        assert verify_merkle_path(leaf, j, step.path, layer_caps_u64[li]), \
            f"FRI layer {li} merkle path failed"
        v0, v1 = step.pair
        mine = v0 if idx < h else v1
        assert mine == val, f"FRI layer {li} value mismatch"
        x = (cur_shift * _gl.s_pow(_gl.root_of_unity(m.bit_length() - 1), j)) % P
        val = fold_step(v0, v1, x, betas[li])
        idx = j
        cur_shift = (cur_shift * cur_shift) % P
        m = h
        li += 1
    # evaluate final poly at the surviving point
    x = (cur_shift * _gl.s_pow(_gl.root_of_unity(m.bit_length() - 1), idx)) % P
    acc = (0, 0)
    for c in reversed(final_coeffs):
        acc = e_add(e_mul(acc, (x, 0)), c)
    assert acc == val, "FRI final polynomial mismatch"


def check_final_poly_degree(final_coeffs, final_domain: int, rate_bits: int):
    """Degree bound: only the low final_domain/2^rate_bits coeffs may be set."""
    bound = final_domain >> rate_bits
    for c in final_coeffs[bound:]:
        assert c == (0, 0), "FRI final polynomial exceeds degree bound"
