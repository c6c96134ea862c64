"""PLONK-style circuit builder: the framework's gate/wire/generator front end.

Role: the replacement for BOTH the reference's translator target
API (plonky2's CircuitBuilder used at /root/reference/plonky2-backend/src/
circuit_translation/mod.rs:61-330) and the reference fork's gate zoo.  The
reference lowers ACIR onto ~22 specialized gate types with per-gate
constraint polynomials; here everything lowers onto ONE wide universal
arithmetic gate plus a LogUp lookup argument, so the whole quotient
evaluation stays a single fused elementwise expression over the LDE — the
shape XLA fuses best (docs/DESIGN.md).

Gate (W = NUM_WIRES routed wires per row; selectors qM_0..qM_{W/2-1},
q_0..q_{W-1}, qC, qLK):

    sum_j qM_j * w_{2j} * w_{2j+1} + sum_i q_i * w_i + qC + PI(x) = 0

The paired products make one row an 8-term dot product — the wide-row
answer to the reference's wide_ecc_config (135 wires,
circuit_translation/mod.rs:69) without a gate zoo.

Rows with qLK = 1 are LOOKUP rows: all W wire values must appear in the
preprocessed table (value range [0, 2^lookup_bits)), enforced by a LogUp
fractional-sum argument (see prover/prove.py).  This plays the role of the
reference's U32RangeCheckGate / 2-bit-limb range constraints (SURVEY.md
C14-C18) at a cost of ONE row per W range checks instead of one row per
2-bit limb.

Copy constraints are implicit: wire slots referencing the same variable id
end up in one permutation cycle (sigma built at compile time).

Witness generation: every derived variable carries one generator op; the
compiler schedules ops into topological levels and executes each level as a
batched numpy limb operation — the static-scheduling answer to plonky2's
runtime SimpleGenerator fixpoint (SURVEY.md §7 hard part 3; reference runs
generators inside circuit_data.prove, prove_action.rs:91-97).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..field.gl import P

NUM_WIRES = 16
NUM_PAIRS = NUM_WIRES // 2
# selector layout: [qM_0..qM_{P-1}, q_0..q_{W-1}, qC, qLK]
NUM_SELECTORS = NUM_PAIRS + NUM_WIRES + 2
SEL_QM0 = 0
SEL_Q0 = NUM_PAIRS
SEL_QC = NUM_PAIRS + NUM_WIRES
SEL_QLK = NUM_SELECTORS - 1

# permutation-argument factor group size (keeps each transition constraint
# at degree <= 7, i.e. within the rate-8 LDE; see prover/prove.py)
PERM_GROUP = 6
# lookup helper group size (constraint degree 1 + group <= 7)
LOOKUP_GROUP = 4


def perm_groups(num_wires: int) -> List[Tuple[int, int]]:
    """[(start, end)] wire-index ranges of the permutation factor groups."""
    out = []
    i = 0
    while i < num_wires:
        out.append((i, min(i + PERM_GROUP, num_wires)))
        i += PERM_GROUP
    return out


def lookup_groups(num_wires: int) -> List[Tuple[int, int]]:
    out = []
    i = 0
    while i < num_wires:
        out.append((i, min(i + LOOKUP_GROUP, num_wires)))
        i += LOOKUP_GROUP
    return out


# Generator opcodes (see compile.py for the batched executor).
GEN_EXTERNAL = 0  # value supplied at prove time (ACIR witness)
GEN_CONST = 1     # out = const
GEN_ADD = 2       # out = v[a] + v[b]
GEN_SUB = 3       # out = v[a] - v[b]
GEN_MUL = 4       # out = v[a] * v[b]
GEN_MULADDC = 5   # out = v[a] * const + v[b]
GEN_INV = 6       # out = v[a]^-1  (0 -> 0, like plonky2's inverse generator)
GEN_BIT = 7       # out = (v[a] >> const) & 1
GEN_HINT_OUT = 8  # out = hint[a].fn(inputs)[const]  (custom host generator)
GEN_MULMULC = 9   # out = v[a] * v[b] * const


@dataclass
class GenOp:
    op: int
    out: int
    a: int = 0
    b: int = 0
    const: int = 0


@dataclass
class Hint:
    """Custom host-side witness generator: python ints in, python ints out.
    The analog of plonky2's SimpleGenerator (e.g. BigUintDivRemGenerator,
    biguint.rs:316-360) — compute a hint, then constrain it algebraically."""
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    fn: object  # Callable[[List[int]], List[int]]


@dataclass
class GateRow:
    wires: Tuple[Optional[int], ...]  # var ids, None = unused (zero var)
    qm: Tuple[int, ...] = (0,) * NUM_PAIRS
    q: Tuple[int, ...] = (0,) * NUM_WIRES
    qc: int = 0


class CircuitBuilder:
    """Accumulates gate rows, variables, generators, lookups and publics."""

    def __init__(self, lookup_bits: int = 0):
        self.rows: List[GateRow] = []
        self.gen_ops: List[GenOp] = []
        self.hints: List[Hint] = []
        self.num_vars = 0
        self._const_cache: Dict[int, int] = {}
        self.public_inputs: List[int] = []
        self.lookup_bits = lookup_bits
        self.pending_lookups: List[int] = []
        # var 0 is the always-zero constant (unused wire slots point here)
        self.zero = self.constant(0)
        assert self.zero == 0
        self.one = self.constant(1)

    # -- variables -------------------------------------------------------

    def _new_var(self) -> int:
        v = self.num_vars
        self.num_vars += 1
        return v

    def add_external(self) -> int:
        """A variable whose value is fed in at prove time (ACIR witness)."""
        v = self._new_var()
        self.gen_ops.append(GenOp(GEN_EXTERNAL, v))
        return v

    def hint(self, inputs: Sequence[int], num_outputs: int, fn) -> List[int]:
        """Create num_outputs variables computed by fn(input_values) at
        witness-generation time.  UNCONSTRAINED — caller must add the
        algebraic check (the hint+check pattern, SURVEY.md C19/C21)."""
        outs = [self._new_var() for _ in range(num_outputs)]
        hid = len(self.hints)
        self.hints.append(Hint(tuple(inputs), tuple(outs), fn))
        for j, o in enumerate(outs):
            self.gen_ops.append(GenOp(GEN_HINT_OUT, o, a=hid, const=j))
        return outs

    def constant(self, value: int) -> int:
        value %= P
        if value in self._const_cache:
            return self._const_cache[value]
        v = self._new_var()
        self.gen_ops.append(GenOp(GEN_CONST, v, const=value))
        # constrain: value - w0 = 0  -> q0=-1, qC=value
        self.gate([v], q=[-1], qc=value)
        self._const_cache[value] = v
        return v

    # -- raw gate --------------------------------------------------------

    def gate(self, wires: Sequence[Optional[int]], qm=0,
             q: Sequence[int] = (), qc: int = 0):
        """Append one row.  qm may be a scalar (coefficient of w0*w1, the
        narrow-gate legacy form) or a sequence of NUM_PAIRS coefficients."""
        w = list(wires) + [None] * (NUM_WIRES - len(wires))
        qs = [int(x) % P for x in q] + [0] * (NUM_WIRES - len(q))
        if isinstance(qm, (list, tuple)):
            qms = [int(x) % P for x in qm] + [0] * (NUM_PAIRS - len(qm))
        else:
            qms = [int(qm) % P] + [0] * (NUM_PAIRS - 1)
        self.rows.append(GateRow(tuple(w), tuple(qms), tuple(qs), int(qc) % P))

    def dot_row(self, mul_terms: Sequence[Tuple[int, int, int]],
                lin_terms: Sequence[Tuple[int, int]] = (), const: int = 0,
                out: Optional[int] = None, make_gen: bool = True) -> Optional[int]:
        """One row constraining
            sum_i c_i * a_i * b_i + sum_j d_j * v_j + const - out == 0
        (out omitted -> assert the sum is zero).  Wire budget:
        2*len(mul_terms) + len(lin_terms) + (1 if out) <= NUM_WIRES and
        len(mul_terms) <= NUM_PAIRS.  If make_gen and out is an int var id
        created by the caller via new_derived(), emits the generator chain.
        Returns out."""
        nm, nl = len(mul_terms), len(lin_terms)
        assert nm <= NUM_PAIRS and 2 * nm + nl + (out is not None) <= NUM_WIRES
        wires: List[Optional[int]] = []
        qm = []
        for c, a, b in mul_terms:
            qm.append(c % P)
            wires.append(a)
            wires.append(b)
        q = [0] * (2 * nm)
        for d, v in lin_terms:
            wires.append(v)
            q.append(d % P)
        if out is not None:
            wires.append(out)
            q.append(P - 1)
        self.gate(wires, qm=qm, q=q, qc=const)
        if out is not None and make_gen:
            # generator chain: acc = const; acc += c*a*b; acc += d*v
            cur = self.zero if const % P == 0 else self.constant(const)
            steps = []
            for c, a, b in mul_terms:
                steps.append(("m", c % P, a, b))
            for d, v in lin_terms:
                steps.append(("l", d % P, v, None))
            for idx, (kind, c, a, b) in enumerate(steps):
                nv = out if idx == len(steps) - 1 else self._new_var()
                if kind == "m":
                    t = self._new_var()
                    self.gen_ops.append(GenOp(GEN_MULMULC, t, a, b, c))
                    self.gen_ops.append(GenOp(GEN_ADD, nv, t, cur))
                else:
                    self.gen_ops.append(GenOp(GEN_MULADDC, nv, a, cur, c))
                cur = nv
            if not steps:
                self.gen_ops.append(GenOp(GEN_CONST, out, const=const % P))
        return out

    def new_derived(self) -> int:
        """A fresh variable whose generator the caller will attach (e.g. via
        dot_row make_gen)."""
        return self._new_var()

    # -- public inputs -----------------------------------------------------

    def register_public_input(self, var: int):
        """Expose `var` as a public input (analog of reference
        register_public_input, circuit_translation/mod.rs:305-310).  The
        compiler emits one PI row per entry; verifier binds via PI(x)."""
        self.public_inputs.append(var)

    # -- lookups -------------------------------------------------------------

    def lookup(self, var: int):
        """Assert var in [0, 2^lookup_bits) via the lookup table (flushed
        W per row at compile time)."""
        assert self.lookup_bits > 0, "builder built without lookups"
        self.pending_lookups.append(var)

    # -- arithmetic gadgets ------------------------------------------------

    def add(self, a: int, b: int) -> int:
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_ADD, out, a, b))
        self.gate([a, b, out], q=[1, 1, -1])
        return out

    def sub(self, a: int, b: int) -> int:
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_SUB, out, a, b))
        self.gate([a, b, out], q=[1, -1, -1])
        return out

    def mul(self, a: int, b: int) -> int:
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_MUL, out, a, b))
        self.gate([a, b, out], qm=1, q=[0, 0, -1])
        return out

    def mul_const(self, a: int, c: int) -> int:
        c %= P
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_MULADDC, out, a, self.zero, c))
        self.gate([a, out], q=[c, -1])
        return out

    def add_const(self, a: int, c: int) -> int:
        c %= P
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_MULADDC, out, a, self.constant(c), 1))
        self.gate([a, out], q=[1, -1], qc=c)
        return out

    def mul_add(self, a: int, b: int, c: int) -> int:
        """out = a*b + c in one row."""
        out = self._new_var()
        t = self._new_var()
        # generators: t = a*b ; out = t + c  (single row constrains directly)
        self.gen_ops.append(GenOp(GEN_MUL, t, a, b))
        self.gen_ops.append(GenOp(GEN_ADD, out, t, c))
        self.gate([a, b, c, out], qm=1, q=[0, 0, 1, -1])
        return out

    def lincomb(self, terms: Sequence[Tuple[int, int]], const: int = 0) -> int:
        """out = sum(c_i * v_i) + const, chained W-2 terms per row.

        Analog of the reference's AssertZero linear accumulation
        (assert_zero_translator.rs:62-88); width-16 rows take 14 terms
        plus a running accumulator each.
        """
        const %= P
        terms = [(c % P, v) for c, v in terms if c % P != 0]
        if not terms:
            return self.constant(const)
        acc = None
        i = 0
        while i < len(terms):
            chunk = terms[i:i + NUM_WIRES - 1] if acc is None \
                else terms[i:i + NUM_WIRES - 2]
            qc = const if i == 0 else 0
            out = self._new_var()
            # generator chain
            if acc is None:
                cur = self.zero if qc == 0 else self.constant(qc)
            else:
                cur = acc
            for j, (c, v) in enumerate(chunk):
                nv = out if j == len(chunk) - 1 else self._new_var()
                self.gen_ops.append(GenOp(GEN_MULADDC, nv, v, cur, c))
                cur = nv
            # constraint row
            wires = [v for _, v in chunk]
            qs = [c for c, _ in chunk]
            if acc is not None:
                wires.append(acc)
                qs.append(1)
            wires.append(out)
            qs.append(-1)
            self.gate(wires, q=qs, qc=qc)
            acc = out
            i += len(chunk)
        return acc

    def assert_lincomb_zero(self, terms: Sequence[Tuple[int, int]],
                            const: int = 0):
        """Constrain sum(c_i*v_i) + const == 0 without materializing the
        sum (chunks fold into an accumulator; last row asserts)."""
        const %= P
        terms = [(c % P, v) for c, v in terms if c % P != 0]
        if not terms:
            assert const == 0, "unsatisfiable constant constraint"
            return
        # fold all but the last chunk into an accumulator, assert on last
        if len(terms) <= NUM_WIRES:
            self.gate([v for _, v in terms], q=[c for c, _ in terms], qc=const)
            return
        head = terms[:-(NUM_WIRES - 1)]
        tail = terms[-(NUM_WIRES - 1):]
        acc = self.lincomb(head, const)
        self.gate([v for _, v in tail] + [acc],
                  q=[c for c, _ in tail] + [1])

    def assert_zero_lincomb(self, mul_terms: Sequence[Tuple[int, int, int]],
                            terms: Sequence[Tuple[int, int]], const: int = 0):
        """Constrain sum(c*wl*wr) + sum(c*v) + const == 0 (full ACIR
        Expression shape, assert_zero_translator.rs:25-38).  Multiplication
        terms ride the paired-product selectors, NUM_PAIRS at a time."""
        mul_terms = [(c % P, a, b) for c, a, b in mul_terms if c % P != 0]
        lin = [(c % P, v) for c, v in terms if c % P != 0]
        # pack as many mul pairs + lin terms into single dot rows, folding
        # partial sums into accumulator vars
        acc = None
        while mul_terms or lin:
            nm = min(len(mul_terms), NUM_PAIRS)
            room = NUM_WIRES - 2 * nm - (1 if acc is not None else 0)
            nl = min(len(lin), max(0, room - 1))
            chunk_m = mul_terms[:nm]
            chunk_l = lin[:nl]
            mul_terms = mul_terms[nm:]
            lin = lin[nl:]
            extra = ([(1, acc)] if acc is not None else [])
            qc = const if acc is None else 0
            if not mul_terms and not lin:
                # final chunk: assert directly
                wires, qm, q = [], [], []
                for c, a, b in chunk_m:
                    qm.append(c)
                    wires += [a, b]
                    q += [0, 0]
                for d, v in chunk_l + extra:
                    wires.append(v)
                    q.append(d)
                self.gate(wires, qm=qm, q=q, qc=qc)
                return
            out = self.new_derived()
            self.dot_row(chunk_m, chunk_l + extra, qc, out)
            acc = out
        if acc is not None:
            self.assert_zero(acc)
        elif const % P != 0:
            raise AssertionError("unsatisfiable constant constraint")

    def assert_zero(self, a: int):
        self.gate([a], q=[1])

    def assert_equal(self, a: int, b: int):
        self.gate([a, b], q=[1, -1])

    def assert_const(self, a: int, c: int):
        self.gate([a], q=[1], qc=-c)

    # -- boolean / bit gadgets ----------------------------------------------

    def assert_bool(self, b: int):
        """b^2 - b = 0."""
        self.gate([b, b], qm=1, q=[-1])

    def select(self, bit: int, a: int, b: int) -> int:
        """bit ? a : b  == b + bit*a - bit*b; bit must be boolean."""
        out = self.new_derived()
        self.dot_row([(1, bit, a), (P - 1, bit, b)], [(1, b)], 0, out)
        return out

    def select_vec(self, bit: int, avec: Sequence[int],
                   bvec: Sequence[int]) -> List[int]:
        """Elementwise bit ? a_i : b_i (one row per element; each row is
        one constraint, so independent selects cannot share a row)."""
        return [self.select(bit, a, v) for a, v in zip(avec, bvec)]

    def split_le(self, a: int, n_bits: int) -> List[int]:
        """Decompose a into n_bits boolean vars (LSB first) and constrain the
        recombination (analog of reference convert_number_to_binary_number,
        circuit_translation/mod.rs:262-271)."""
        bits = []
        for k in range(n_bits):
            b = self._new_var()
            self.gen_ops.append(GenOp(GEN_BIT, b, a, const=k))
            self.assert_bool(b)
            bits.append(b)
        self.assert_lincomb_zero([(1 << k, b) for k, b in enumerate(bits)] +
                                 [(P - 1, a)])
        return bits

    def le_sum_vars(self, bits: Sequence[int]) -> int:
        """Recombine LSB-first boolean vars into a field element
        (analog of builder.le_sum, mod.rs:273-279)."""
        return self.lincomb([(1 << k, b) for k, b in enumerate(bits)])

    def range_check(self, a: int, n_bits: int):
        """Assert a < 2^n_bits.  With lookups enabled this is limb lookups
        (the role of the reference's U32RangeCheckGate, SURVEY.md C17);
        otherwise a bit decomposition."""
        if self.lookup_bits == 0:
            self.split_le(a, n_bits)
            return
        B = self.lookup_bits
        if n_bits == B:
            self.lookup(a)
            return
        if n_bits < B:
            # a < 2^n  <=>  a in table AND a*2^(B-n) in table
            shifted = self.mul_const(a, 1 << (B - n_bits))
            self.lookup(a)
            self.lookup(shifted)
            return
        # wide value: hint B-bit limbs, constrain recombination + lookups
        nfull, rem = divmod(n_bits, B)
        widths = [B] * nfull + ([rem] if rem else [])

        def fn(vals):
            v = vals[0]
            outs = []
            sh = 0
            for wd in widths:
                outs.append((v >> sh) & ((1 << wd) - 1))
                sh += wd
            return outs

        limbs = self.hint([a], len(widths), fn)
        terms = []
        sh = 0
        for limb, wd in zip(limbs, widths):
            self.range_check(limb, wd)
            terms.append((1 << sh, limb))
            sh += wd
        self.assert_lincomb_zero(terms + [(P - 1, a)])

    # bitwise ops on single bits
    def bit_and(self, x: int, y: int) -> int:
        return self.mul(x, y)

    def bit_xor(self, x: int, y: int) -> int:
        """x + y - 2xy in one row."""
        out = self._new_var()
        t = self._new_var()
        self.gen_ops.append(GenOp(GEN_MUL, t, x, y))
        v = self._new_var()
        self.gen_ops.append(GenOp(GEN_MULADDC, v, t, x, P - 2))
        self.gen_ops.append(GenOp(GEN_ADD, out, v, y))
        self.gate([x, y, out], qm=P - 2, q=[1, 1, -1])
        return out

    def bit_or(self, x: int, y: int) -> int:
        """x + y - xy in one row."""
        out = self._new_var()
        t = self._new_var()
        self.gen_ops.append(GenOp(GEN_MUL, t, x, y))
        v = self._new_var()
        self.gen_ops.append(GenOp(GEN_MULADDC, v, t, x, P - 1))
        self.gen_ops.append(GenOp(GEN_ADD, out, v, y))
        self.gate([x, y, out], qm=P - 1, q=[1, 1, -1])
        return out

    def bit_not(self, x: int) -> int:
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_SUB, out, self.one, x))
        self.gate([x, out], q=[1, 1], qc=-1)
        return out

    # -- division / inverse --------------------------------------------------

    def inverse(self, a: int) -> int:
        """out = 1/a with the hint+check pattern (reference nonnative inv,
        SURVEY.md C21): generator computes the inverse, circuit checks
        a*out == 1 (so a=0 makes the circuit unsatisfiable)."""
        out = self._new_var()
        self.gen_ops.append(GenOp(GEN_INV, out, a))
        self.gate([a, out], qm=1, qc=-1)
        return out

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inverse(b))

    def is_zero(self, a: int) -> int:
        """Boolean out: out = 1 iff a == 0.  Hint z ~ a^-1; constraints
        out = 1 - a*z and a*out = 0 (plonky2-style is_equal/is_zero)."""
        z = self._new_var()
        self.gen_ops.append(GenOp(GEN_INV, z, a))
        out = self._new_var()
        t = self._new_var()
        self.gen_ops.append(GenOp(GEN_MUL, t, a, z))
        self.gen_ops.append(GenOp(GEN_SUB, out, self.one, t))
        # a*z + out - 1 = 0
        self.gate([a, z, out], qm=1, q=[0, 0, 1], qc=-1)
        # a*out = 0
        self.gate([a, out], qm=1)
        return out

    def is_equal(self, a: int, b: int) -> int:
        """Analog of the fork-added is_equal used by the memory translator
        (memory_translator.rs:96-111)."""
        return self.is_zero(self.sub(a, b))
