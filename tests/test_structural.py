"""Structural anti-false-positive checks and witness-core differential
tests (reference analogs: check_linked_output_targets_property,
tests/factories/utils.rs:29-53; and the C witness core vs pure-numpy
fallback, which previously had no cross-check)."""

import subprocess
import sys

import numpy as np
import pytest

import factories
from tpu_acir_prover.acir.translator import (check_linked_outputs,
                                             translate_program)
from tpu_acir_prover.circuit.compile import compile_circuit


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_outputs_constrained(name):
    prog, _ = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    check_linked_outputs(tr, cc, prog.functions[0])


def test_unconstrained_output_detected():
    """A translator that drops an output binding must be caught: simulate
    by asking about a witness that maps to a variable in no wire slot."""
    from tpu_acir_prover.acir import ir
    prog, _ = factories.one_mul()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    # fabricate a dangling binding: a fresh external var never placed in
    # any row, claimed to be output witness 99
    tr.witness_to_var[99] = tr.builder.add_external()
    bad_circuit = ir.Circuit(
        prog.functions[0].current_witness_index,
        prog.functions[0].opcodes, None, prog.functions[0].private_parameters,
        prog.functions[0].public_parameters, (99,))
    with pytest.raises(AssertionError, match="not bound|never reached"):
        check_linked_outputs(tr, cc, bad_circuit)


def _witness_native_vs_python(name):
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)
    from tpu_acir_prover import native
    if native.get_lib() is None:
        pytest.skip("native witness core unavailable")
    vals_native = cc._generate_witness_native(ext)
    # force the batched-numpy fallback by hiding the generator program
    gp, cc.gen_program = cc.gen_program, None
    try:
        vals_py = cc.generate_witness(ext)
    finally:
        cc.gen_program = gp
    assert np.array_equal(vals_native, vals_py), name


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_witness_core_differential(name):
    """Native C witness core and pure-numpy fallback must agree exactly
    on every factory circuit (the two paths are selected silently, so
    nothing else cross-checks them)."""
    _witness_native_vs_python(name)
