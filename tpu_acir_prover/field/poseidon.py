"""Poseidon2 permutation over Goldilocks, width 12 — our own instantiation.

Role: the algebraic hash used for Merkle commitments and the Fiat-Shamir
challenger, this framework's analog of plonky2's internal Poseidon hasher
(reference config at /root/reference/plonky2-backend/src/lib.rs:11-13).

Why Poseidon2 (Grassi-Khovratovich-Schofnegger 2023 structure) and not
classic Poseidon: Merkle leaf hashing is a dominant prover cost (every LDE
row of every oracle is sponge-hashed), and the classic t=12 Cauchy MDS
costs 144 generic field muls per round.  Poseidon2 replaces it with an
external matrix made entirely of small add-chains (zero generic muls) and
an internal matrix costing 12 muls + a tree sum — ~5x fewer generic field
multiplies per permutation.

Instantiation (deliberately NOT a published constant set — we are not
targeting byte-compatibility; see docs/DESIGN.md):
  - width t = 12, rate 8, capacity 4, sbox x^7 (gcd(7, p-1) = 1)
  - 8 external rounds (4 + 4) and 22 internal rounds, the standard
    parameter choice for t = 12, alpha = 7 at 128-bit security
  - external matrix M_E = circ(2*M4, M4, M4) with the paper's M4
    add-chain; internal matrix M_I = all-ones + diag(mu_i - 1)
    (out_i = sum_j x_j + (mu_i - 1) * x_i)
  - round constants and the internal diagonal mu derived from SHA-256 in
    counter mode (nothing up our sleeves), reduced mod p; the diagonal is
    re-derived until M_I is invertible (det != 0 mod p)

Layout: the state is a single stacked (12, *batch) (lo, hi) uint32 pair,
rounds run under lax.scan on the JAX backend (tiny jaxpr, fast compiles),
and hashing N Merkle leaves is N independent elementwise lanes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import gl as _gl

WIDTH = 12
RATE = 8
CAP = 4
DIGEST = 4
EXTERNAL_ROUNDS = 8  # 4 at the beginning + 4 at the end
INTERNAL_ROUNDS = 22
ALPHA = 7


def _h64(tag: str) -> int:
    h = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(h[:8], "little") % _gl.P


def _derive_round_constants():
    """External rounds use full-width constants; internal rounds add a
    constant to lane 0 only (stored in column 0)."""
    ext = np.zeros((EXTERNAL_ROUNDS, WIDTH), dtype=np.uint64)
    for r in range(EXTERNAL_ROUNDS):
        for i in range(WIDTH):
            ext[r, i] = _h64(f"tpu-acir-prover.poseidon2.ext.{r}.{i}")
    internal = np.zeros(INTERNAL_ROUNDS, dtype=np.uint64)
    for r in range(INTERNAL_ROUNDS):
        internal[r] = _h64(f"tpu-acir-prover.poseidon2.int.{r}")
    return ext, internal


def _derive_diag():
    """Internal-matrix diagonal mu: M_I = J + diag(mu - 1) (J = all-ones),
    i.e. M_I[i][j] = 1 for i != j and mu_i on the diagonal.  Re-derive
    until det(M_I) != 0 mod p (a random matrix is invertible w.h.p.)."""
    ctr = 0
    while True:
        mu = [_h64(f"tpu-acir-prover.poseidon2.diag.{ctr}.{i}")
              for i in range(WIDTH)]
        # det via Gaussian elimination mod p
        m = [[1] * WIDTH for _ in range(WIDTH)]
        for i in range(WIDTH):
            m[i][i] = mu[i]
        det = 1
        singular = False
        for c in range(WIDTH):
            piv = next((r for r in range(c, WIDTH) if m[r][c]), None)
            if piv is None:
                singular = True
                break
            if piv != c:
                m[c], m[piv] = m[piv], m[c]
                det = _gl.P - det
            det = det * m[c][c] % _gl.P
            inv = pow(m[c][c], _gl.P - 2, _gl.P)
            for r in range(c + 1, WIDTH):
                f = m[r][c] * inv % _gl.P
                if f:
                    for k in range(c, WIDTH):
                        m[r][k] = (m[r][k] - f * m[c][k]) % _gl.P
        if not singular and det:
            return np.array(mu, dtype=np.uint64)
        ctr += 1


# the Poseidon2 paper's M4; M_E = circ(2*M4, M4, M4) expanded to 12x12
_M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]
_ME_INT = [[(2 if a == b else 1) * _M4[i][j]
            for b in range(WIDTH // 4) for j in range(4)]
           for a in range(WIDTH // 4) for i in range(4)]

_EXT_RC, _INT_RC = _derive_round_constants()
ROUND_CONSTANTS = _EXT_RC  # (8, 12) uint64 — external-round constants
INTERNAL_CONSTANTS = _INT_RC  # (22,) uint64
DIAG = _derive_diag()  # (12,) uint64: internal-matrix diagonal mu
# precomputed mu - 1 for the out_i = sum + (mu_i - 1) x_i form
DIAG_M1 = ((DIAG.astype(object) - 1) % _gl.P).astype(np.uint64)


def make_poseidon(G):
    """Poseidon2 ops over a field namespace ``G = make_gl(xp)``.

    States/digests are stacked (lo, hi) uint32 array pairs with a leading
    lane axis: state shape (12, *batch), digest shape (4, *batch).
    """
    xp = G.xp
    is_jax = "jax" in getattr(xp, "__name__", "")

    ext_lo_np = (_EXT_RC & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ext_hi_np = (_EXT_RC >> np.uint64(32)).astype(np.uint32)
    int_lo_np = (_INT_RC & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    int_hi_np = (_INT_RC >> np.uint64(32)).astype(np.uint32)
    dm1_lo_np = (DIAG_M1 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    dm1_hi_np = (DIAG_M1 >> np.uint64(32)).astype(np.uint32)

    def _bshape(extra_rank):
        return (WIDTH,) + (1,) * extra_rank

    def _sbox(x):
        x2 = G.mul(x, x)
        x3 = G.mul(x2, x)
        x6 = G.mul(x3, x3)
        return G.mul(x6, x)

    u32 = xp.uint32

    def _limbs4(state):
        """(12, *batch) (lo, hi) u32 pair -> four (12, *batch) u16-limb
        arrays (still u32 dtype), least-significant first."""
        lo, hi = state
        mask = u32(0xFFFF)
        return (lo & mask, lo >> u32(16), hi & mask, hi >> u32(16))

    def _recombine_reduce(a0, a1, a2, a3):
        """Four u16-weighted accumulators (each < 2^25) -> canonical field
        element: carry-propagate into (lo, hi, overflow) then reduce128.
        Flat, shallow dataflow — safe against the XLA fusion-duplication
        blowup that deep add chains trigger (see tree_fold in prove.py)."""
        mask = u32(0xFFFF)
        t1 = (a0 >> u32(16)) + a1
        t2 = (t1 >> u32(16)) + a2
        t3 = (t2 >> u32(16)) + a3
        lo = (a0 & mask) | ((t1 & mask) << u32(16))
        hi = (t2 & mask) | ((t3 & mask) << u32(16))
        ovf = t3 >> u32(16)
        return G.reduce128(lo, hi, ovf, xp.zeros_like(ovf))

    me_f32 = np.array(_ME_INT, dtype=np.float32)  # (12, 12), entries <= 14
    if is_jax:
        from jax import lax as _plax
        _matmul_kw = dict(precision=_plax.Precision.HIGHEST)
    else:
        _matmul_kw = {}

    def _external_matrix(state):
        """M_E = circ(2*M4, M4, M4) as one small-integer matmul per u16
        limb, computed EXACTLY in float32: products < 2^20 and sums of 12
        of them < 2^24 stay inside the f32 24-bit significand.  Exactness
        needs full f32 products, hence Precision.HIGHEST: a TF32 or bf16
        matmul (what DEFAULT may pick on a GPU) keeps ~11 or 8 bits of each
        u16 limb and corrupts every digest.  One einsum per limb keeps the
        jaxpr tiny, then one field reduction per output lane; the dataflow
        stays shallow — deep add chains trigger the XLA fusion-duplication
        blowup (see tree_fold in prove.py)."""
        mf = xp.asarray(me_f32)
        accs = [xp.einsum("ij,j...->i...", mf,
                          limb.astype(xp.float32),
                          **_matmul_kw).astype(u32)
                for limb in _limbs4(state)]  # 4 x (12, *batch), < 2^24
        return _recombine_reduce(*accs)

    def _internal_matrix(state):
        """out_i = sum_j x_j + (mu_i - 1) * x_i (M_I = J + diag(mu - 1)).
        The all-ones sum uses the same exact u16-limb accumulation
        (sums < 2^20); the diagonal is a full-width random constant, so it
        costs 12 real field muls."""
        lo, hi = state
        extra = lo.ndim - 1
        # dtype pinned: numpy promotes uint32 sums to uint64 (jax does not),
        # which poisons the u16-limb recombination with 64-bit garbage
        accs = [limb.sum(axis=0, dtype=xp.uint32)
                for limb in _limbs4(state)]  # < 2^20
        s = _recombine_reduce(*accs)  # (*batch,)
        d = (xp.asarray(dm1_lo_np).reshape(_bshape(extra)),
             xp.asarray(dm1_hi_np).reshape(_bshape(extra)))
        dx = G.mul(d, state)
        return G.add(dx, (s[0][None], s[1][None]))

    def _add_rc(state, rc):
        extra = state[0].ndim - 1
        return G.add(state, (rc[0].reshape(_bshape(extra)),
                             rc[1].reshape(_bshape(extra))))

    def _external_round(state, rc):
        state = _add_rc(state, rc)
        state = _sbox(state)
        return _external_matrix(state)

    def _internal_round(state, rc):
        # rc: ((), ()) scalar pair added to lane 0 only
        lo, hi = state
        l0 = (lo[0:1], hi[0:1])
        l0 = G.add(l0, (rc[0].reshape((1,) + (1,) * (lo.ndim - 1)),
                        rc[1].reshape((1,) + (1,) * (lo.ndim - 1))))
        s0 = _sbox(l0)
        state = (xp.concatenate([s0[0], lo[1:]], axis=0),
                 xp.concatenate([s0[1], hi[1:]], axis=0))
        return _internal_matrix(state)

    half = EXTERNAL_ROUNDS // 2

    def _permute_python(state):
        state = _external_matrix(state)
        for r in range(half):
            state = _external_round(
                state, (xp.asarray(ext_lo_np[r]), xp.asarray(ext_hi_np[r])))
        for r in range(INTERNAL_ROUNDS):
            state = _internal_round(
                state, (xp.asarray(int_lo_np[r]), xp.asarray(int_hi_np[r])))
        for r in range(half, EXTERNAL_ROUNDS):
            state = _external_round(
                state, (xp.asarray(ext_lo_np[r]), xp.asarray(ext_hi_np[r])))
        return state

    if is_jax:
        from jax import lax

        def _scan_rounds(state, lo_c, hi_c, round_fn):
            def body(carry, rc):
                return round_fn(carry, rc), None

            state, _ = lax.scan(body, state,
                                (xp.asarray(lo_c), xp.asarray(hi_c)))
            return state

        def permute(state):
            state = _external_matrix(state)
            state = _scan_rounds(state, ext_lo_np[:half], ext_hi_np[:half],
                                 _external_round)
            state = _scan_rounds(state, int_lo_np, int_hi_np,
                                 _internal_round)
            state = _scan_rounds(state, ext_lo_np[half:], ext_hi_np[half:],
                                 _external_round)
            return state
    else:
        permute = _permute_python

    def zero_state(batch_shape):
        z = xp.zeros((WIDTH,) + tuple(batch_shape), dtype=xp.uint32)
        return (z, z)

    def hash_no_pad(inputs):
        """Sponge hash of (C, *batch) stacked values -> (4, *batch) digest.

        Overwrite-mode absorption in chunks of RATE, no padding (lengths are
        static per call site, as in plonky2's hash_n_to_m_no_pad).

        On the jax backend multi-chunk absorption runs as ONE lax.scan over
        chunks (masked overwrite of the first k lanes) so each hash call
        site traces a single permutation body — a bare permute is ~2.6k
        jaxpr eqns of limb arithmetic, and the unrolled absorb loop was a
        dominant term in phase-program compile times.  Chunk values and the
        overwrite masks are scan inputs; the result is bit-identical to the
        sequential loop."""
        lo, hi = inputs
        c = lo.shape[0]
        state = zero_state(lo.shape[1:])
        if not is_jax or c <= RATE:
            for off in range(0, c, RATE):
                k = min(RATE, c - off)
                state = (xp.concatenate([lo[off:off + k], state[0][k:]],
                                        axis=0),
                         xp.concatenate([hi[off:off + k], state[1][k:]],
                                        axis=0))
                state = permute(state)
            return (state[0][:DIGEST], state[1][:DIGEST])
        from jax import lax
        nch = -(-c // RATE)
        pad = nch * RATE - c
        batch = lo.shape[1:]
        if pad:
            z = xp.zeros((pad,) + batch, xp.uint32)
            lo = xp.concatenate([lo, z], axis=0)
            hi = xp.concatenate([hi, z], axis=0)
        # mask[t, i]: lane i is overwritten by chunk t (k = 8, ..., tail)
        mask = (np.arange(nch)[:, None] * RATE +
                np.arange(RATE)[None, :]) < c
        bshape = (RATE,) + (1,) * len(batch)
        xs = (lo.reshape((nch, RATE) + batch),
              hi.reshape((nch, RATE) + batch),
              xp.asarray(mask))

        def body(st, x):
            clo, chi, m = x
            m = m.reshape(bshape)
            st = (xp.concatenate([xp.where(m, clo, st[0][:RATE]),
                                  st[0][RATE:]], axis=0),
                  xp.concatenate([xp.where(m, chi, st[1][:RATE]),
                                  st[1][RATE:]], axis=0))
            return permute(st), None

        state, _ = lax.scan(body, state, xs)
        return (state[0][:DIGEST], state[1][:DIGEST])

    def two_to_one(left, right):
        """Compress two (4, *batch) digests into one."""
        z = zero_state(left[0].shape[1:])
        state = (xp.concatenate([left[0], right[0], z[0][RATE:]], axis=0),
                 xp.concatenate([left[1], right[1], z[1][RATE:]], axis=0))
        state = permute(state)
        return (state[0][:DIGEST], state[1][:DIGEST])

    ns = dict(
        permute=permute, hash_no_pad=hash_no_pad, two_to_one=two_to_one,
        zero_state=zero_state, external_matrix=_external_matrix, G=G,
    )
    return type("Poseidon", (), ns)


# ---------------------------------------------------------------------------
# Scalar (python-int) permutation for the host challenger and proof
# verification paths — ~1000x faster than tiny-batch numpy for single states.

_EXT_INT = [[int(_EXT_RC[r, i]) for i in range(WIDTH)]
            for r in range(EXTERNAL_ROUNDS)]
_INT_INT = [int(v) for v in _INT_RC]
_DIAG_M1_INT = [int(v) for v in DIAG_M1]
_P = _gl.P


def _sbox_int(x):
    x2 = x * x % _P
    x3 = x2 * x % _P
    return x3 * x3 % _P * x % _P


def _external_matrix_int(state):
    return [sum(_ME_INT[i][j] * state[j] for j in range(WIDTH)) % _P
            for i in range(WIDTH)]


def _internal_matrix_int(state):
    s = sum(state) % _P
    return [(s + _DIAG_M1_INT[i] * state[i]) % _P for i in range(WIDTH)]


def permute_ints(state):
    """Poseidon2 permutation on a list of 12 python ints (host scalar path).

    Bit-identical to the vectorized `make_poseidon(...).permute` (tested)."""
    assert len(state) == WIDTH
    state = _external_matrix_int(list(state))
    half = EXTERNAL_ROUNDS // 2
    for r in range(half):
        state = [_sbox_int((state[i] + _EXT_INT[r][i]) % _P)
                 for i in range(WIDTH)]
        state = _external_matrix_int(state)
    for r in range(INTERNAL_ROUNDS):
        state = list(state)
        state[0] = _sbox_int((state[0] + _INT_INT[r]) % _P)
        state = _internal_matrix_int(state)
    for r in range(half, EXTERNAL_ROUNDS):
        state = [_sbox_int((state[i] + _EXT_INT[r][i]) % _P)
                 for i in range(WIDTH)]
        state = _external_matrix_int(state)
    return state


def hash_no_pad_ints(inputs):
    state = [0] * WIDTH
    for off in range(0, len(inputs), RATE):
        chunk = inputs[off:off + RATE]
        state = list(chunk) + state[len(chunk):]
        state = permute_ints(state)
    return tuple(state[:DIGEST])


def two_to_one_ints(left, right):
    state = list(left) + list(right) + [0] * (WIDTH - RATE)
    state = permute_ints(state)
    return tuple(state[:DIGEST])
