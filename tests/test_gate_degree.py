"""Constraint-degree harness: this framework's analog of the reference's gate
testing framework (plonky2_ecdsa/biguint/gates/gate_testing.rs:20-159,
SURVEY.md C25).

The reference's `test_low_degree` evaluates a gate's constraints over the
LDE of random low-degree wire polynomials and asserts the resulting degree
bound; `test_eval_fns` checks that two independent evaluation paths agree.
Our equivalents for the wide universal gate + partial-product permutation +
LogUp lookup argument (prover/prove.py module docstring has the constraint
list):

  * low-degree: the alpha-combined constraint C(x), divided by Z_H(x)
    pointwise on the coset LDE, must be a polynomial of degree < NCH*n.
    The prover's quotient phase keeps only the first NCH chunks of the
    INTT; here we recompute the FULL m-point quotient with independent
    pure-python scalar field math and assert the discarded tail is exactly
    zero on a satisfied witness (and nonzero on a violated one).
  * eval coherence: the independent recomputation must reproduce the
    prover's quotient-phase chunk columns bit-for-bit.
"""

import numpy as np

import factories
from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.builder import (CircuitBuilder, NUM_PAIRS,
                                             NUM_SELECTORS, lookup_groups,
                                             perm_groups)
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.field import gl as _gl
from tpu_acir_prover.field.ext import e_add, e_sub, e_mul, e_inv, e_pow
from tpu_acir_prover.field.gl import P
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover.prover.ntt import coset_intt
from tpu_acir_prover.prover.prove import ProvingKey, _mat_to_dev

BETA = (3141, 5926)
GAMMA = (5358, 9793)
LAM = (2718, 2818)
ALPHA = (2384, 6264)


def _u64mat(G, pair):
    return np.asarray(G.to_u64(pair))


def _full_quotient_int(pk, cc, wires_u64, pub_values):
    """Recompute C(x)/Z_H(x) at every coset point with python-int field
    math (the independent path), then INTT all m coefficients."""
    G = pk.G
    n, m = pk.n, pk.m
    W = pk.W
    rate = pk.config.rate
    has_lk = pk.has_lookups
    K = pk.K
    p_groups = perm_groups(W)
    lk_groups_ = lookup_groups(W) if has_lk else []

    wires_dev = _mat_to_dev(G, wires_u64)
    wires_o = pk.commit(wires_dev)
    z_mat = pk.round2_phase(wires_dev, BETA, GAMMA, LAM if has_lk else None)
    z_o = pk.commit(z_mat)

    cmat = _u64mat(G, pk.constants_oracle.lde)   # (m, csel+W[+1])
    wmat = _u64mat(G, wires_o.lde)               # (m, W[+1])
    zmat = _u64mat(G, z_o.lde)                   # (m, 2*num_z_ext)
    num_z_ext = pk.num_z_ext

    g = _gl.MULTIPLICATIVE_GENERATOR
    omega_m = _gl.root_of_unity(m.bit_length() - 1)
    ncons = pk.num_constraints
    alphas = [e_pow(ALPHA, i) for i in range(ncons)]

    t_re = np.zeros(m, dtype=np.uint64)
    t_im = np.zeros(m, dtype=np.uint64)
    x = g % P
    for i in range(m):
        qm = [int(cmat[i, j]) for j in range(NUM_PAIRS)]
        q = [int(cmat[i, NUM_PAIRS + j]) for j in range(W)]
        qc = int(cmat[i, NUM_PAIRS + W])
        qlk = int(cmat[i, NUM_SELECTORS - 1])
        sig = [int(cmat[i, NUM_SELECTORS + j]) for j in range(W)]
        table = int(cmat[i, NUM_SELECTORS + W]) if has_lk else 0
        w = [int(wmat[i, j]) for j in range(W)]
        mcol = int(wmat[i, W]) if has_lk else 0
        zv = [(int(zmat[i, 2 * t]), int(zmat[i, 2 * t + 1]))
              for t in range(num_z_ext)]
        ig = (i + rate) % m
        zgv = [(int(zmat[ig, 2 * t]), int(zmat[ig, 2 * t + 1]))
               for t in range(num_z_ext)]

        # PI(x) = sum_j (-pub_j) L_j(x)
        pi_x = 0
        wj = 1
        for pub in pub_values:
            lj = ((x ** n - 1) % P) * wj % P * pow(n * (x - wj) % P, P - 2, P) % P
            pi_x = (pi_x - pub * lj) % P
            wj = wj * _gl.root_of_unity(cc.log_n) % P

        c_gate = qc
        for j in range(NUM_PAIRS):
            c_gate = (c_gate + qm[j] * w[2 * j] % P * w[2 * j + 1]) % P
        for j in range(W):
            c_gate = (c_gate + q[j] * w[j]) % P
        c_gate = (c_gate + pi_x) % P
        constraints = [(c_gate, 0)]

        zh_x = (pow(x, n, P) - 1) % P
        l1 = zh_x * pow(n * (x - 1) % P, P - 2, P) % P
        constraints.append(e_mul((l1, 0), e_sub(zv[0], (1, 0))))

        chain = [zv[0]] + zv[1:K] + [zgv[0]]
        for t, (s, e) in enumerate(p_groups):
            fnum = (1, 0)
            fden = (1, 0)
            for j in range(s, e):
                kx = pow(g, j, P) * x % P
                fnum = e_mul(fnum, e_add(e_add((w[j], 0), e_mul(BETA, (kx, 0))),
                                         GAMMA))
                fden = e_mul(fden, e_add(e_add((w[j], 0),
                                               e_mul(BETA, (sig[j], 0))),
                                         GAMMA))
            constraints.append(e_sub(e_mul(chain[t], fnum),
                                     e_mul(chain[t + 1], fden)))

        if has_lk:
            nh = len(lk_groups_)
            facs = [e_sub(LAM, (w[j], 0)) for j in range(W)]
            for t, (s, e) in enumerate(lk_groups_):
                h_g = zv[K + t]
                prod = (1, 0)
                for j in range(s, e):
                    prod = e_mul(prod, facs[j])
                rhs = (0, 0)
                for j in range(s, e):
                    term = (1, 0)
                    for k2 in range(s, e):
                        if k2 != j:
                            term = e_mul(term, facs[k2])
                    rhs = e_add(rhs, term)
                constraints.append(e_sub(e_mul(h_g, prod),
                                         e_mul((qlk, 0), rhs)))
            h_t = zv[K + nh]
            constraints.append(e_sub(e_mul(h_t, e_sub(LAM, (table, 0))),
                                     (1, 0)))
            s_z, s_gz = zv[K + nh + 1], zgv[K + nh + 1]
            c_s = e_sub(s_gz, s_z)
            for t in range(nh):
                c_s = e_sub(c_s, zv[K + t])
            c_s = e_add(c_s, e_mul((mcol, 0), h_t))
            constraints.append(c_s)
            constraints.append(e_mul((l1, 0), s_z))

        c_all = (0, 0)
        for a, c in zip(alphas, constraints):
            c_all = e_add(c_all, e_mul(a, c))
        t_pt = e_mul(c_all, e_inv((zh_x, 0)))
        t_re[i], t_im[i] = t_pt
        x = x * omega_m % P

    def _intt_col(v):
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.uint64(32)).astype(np.uint32)
        r = coset_intt(G, (G.xp.asarray(lo), G.xp.asarray(hi)))
        return np.asarray(G.to_u64(r)).reshape(m)

    return (_intt_col(t_re), _intt_col(t_im)), wires_o, z_o


def _setup(name="fibonacci", lookup: bool = False):
    if lookup:
        b = CircuitBuilder(lookup_bits=4)
        x = b.add_external()
        y = b.add_external()
        b.range_check(x, 4)
        b.range_check(y, 3)
        s = b.add(x, y)
        b.range_check(s, 9)
        cc = compile_circuit(b)
        pk = ProvingKey(cc, TEST_CONFIG, xp=np)
        vals = cc.generate_witness(np.array([11, 6], dtype=np.uint64))
        assert cc.check_constraints(vals) is None
        wires = cc.wire_values(vals)
        mcol = cc.multiplicities(wires)
        wmat = np.concatenate([wires, mcol.reshape(1, cc.n)], axis=0).T
        return pk, cc, wmat, cc.public_values(vals)
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    pk = ProvingKey(cc, TEST_CONFIG, xp=np)
    vals = cc.generate_witness(tr.external_values(wm))
    assert cc.check_constraints(vals) is None
    return pk, cc, cc.wire_values(vals).T, cc.public_values(vals)


def test_quotient_low_degree():
    """Satisfied witness -> quotient degree < NCH*n: the INTT tail the
    prover discards is identically zero (low-degree bound,
    gate_testing.rs:20-63 analog)."""
    pk, cc, wires_u64, pub = _setup()
    n, nch = pk.n, pk.num_chunks
    (t_re, t_im), _, _ = _full_quotient_int(pk, cc, wires_u64, pub)
    assert np.all(t_re[nch * n:] == 0), "quotient real tail not zero"
    assert np.all(t_im[nch * n:] == 0), "quotient imag tail not zero"
    # sanity: the quotient itself is not the zero polynomial
    assert t_re[:nch * n].any() or t_im[:nch * n].any()


def test_quotient_low_degree_with_lookups():
    """Same bound with the LogUp columns active (helper constraints reach
    degree 5, S recurrence ties the running sum)."""
    pk, cc, wires_u64, pub = _setup(lookup=True)
    n, nch = pk.n, pk.num_chunks
    (t_re, t_im), _, _ = _full_quotient_int(pk, cc, wires_u64, pub)
    assert np.all(t_re[nch * n:] == 0), "quotient real tail not zero"
    assert np.all(t_im[nch * n:] == 0), "quotient imag tail not zero"


def test_quotient_degree_violated_witness():
    """A corrupted wire breaks divisibility by Z_H: the tail is nonzero
    (the negative direction of the low-degree harness)."""
    pk, cc, wires_u64, pub = _setup()
    n, nch = pk.n, pk.num_chunks
    bad = wires_u64.copy()
    bad[2, 0] = (int(bad[2, 0]) + 1) % P
    (t_re, t_im), _, _ = _full_quotient_int(pk, cc, bad, pub)
    assert t_re[nch * n:].any() or t_im[nch * n:].any(), \
        "tampered witness still yielded a low-degree quotient"


def test_quotient_eval_coherence():
    """The jitted quotient phase and this test's independent scalar
    recomputation agree bit-for-bit on the kept chunks (test_eval_fns
    analog, gate_testing.rs:85-159)."""
    for lookup in (False, True):
        pk, cc, wires_u64, pub = _setup(lookup=lookup)
        n, nch = pk.n, pk.num_chunks
        (t_re, t_im), wires_o, z_o = _full_quotient_int(pk, cc, wires_u64,
                                                        pub)
        pi_vals = np.zeros(pk.n, dtype=np.uint64)
        for j, pv in enumerate(pub):
            pi_vals[j] = (P - pv) % P
        q = pk.quotient_phase(wires_o.lde, z_o.lde, pi_vals, BETA, GAMMA,
                              LAM if lookup else None, ALPHA)
        q_u64 = np.asarray(pk.G.to_u64(q))  # (n, 2*nch)
        for k in range(nch):
            assert np.array_equal(q_u64[:, k], t_re[k * n:(k + 1) * n])
            assert np.array_equal(q_u64[:, nch + k], t_im[k * n:(k + 1) * n])
