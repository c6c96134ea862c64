"""The in-graph row-chunked quotient evaluation (lax.map over contiguous
row chunks, prove.quotient_body) must produce byte-identical proofs to the
full-domain evaluation — it exists only to bound the live temporaries of
large traces."""

import os

import numpy as np
import pytest

import factories
from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover.prover.prove import ProvingKey, prove
from tpu_acir_prover.prover.serialization import serialize_proof
from tpu_acir_prover.prover.verify import verify


@pytest.mark.parametrize("name", ["fibonacci", "range_33"])
def test_chunked_quotient_byte_identical(name, monkeypatch):
    import jax.numpy as jnp
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)

    pk_full = ProvingKey(cc, TEST_CONFIG, xp=jnp)
    proof_full = prove(pk_full, ext)

    m = pk_full.m
    chunk = m // 4
    assert chunk >= TEST_CONFIG.rate
    monkeypatch.setenv("TPU_ACIR_QUOTIENT_CHUNK", str(chunk))
    pk_chunked = ProvingKey(cc, TEST_CONFIG, xp=jnp)
    proof_chunked = prove(pk_chunked, ext)
    verify(pk_chunked.vk, proof_chunked)
    assert serialize_proof(proof_chunked) == serialize_proof(proof_full)
