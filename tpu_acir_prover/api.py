"""High-level pipeline: the use-case layer (reference actions/*.rs analog).

prove_file / write_vk_file / verify_file mirror ProveAction / WriteVKAction /
VerifyAction (actions/prove_action.rs:27-43, write_vk_action.rs:64-81,
verify_action.rs:10-18), with one deliberate improvement the reference
flags in its own comments (prove_action.rs:18-19): the translated+compiled
circuit and device-resident proving key are cached by bytecode hash and
shared between prove and write_vk instead of being rebuilt per command.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .acir import codec
from .acir.translator import translate_program, AcirTranslator
from .circuit.compile import CompiledCircuit, compile_circuit
from .prover.config import ProofConfig, STANDARD_CONFIG
from .prover.prove import ProvingKey, prove
from .prover.compress import compress_proof, decompress_proof
from .prover.serialization import (COMPRESSED_PROOF_MAGIC,
                                   deserialize_compressed_proof,
                                   deserialize_proof, deserialize_vk,
                                   serialize_compressed_proof,
                                   serialize_proof, serialize_vk)
from .prover.verify import verify


def _select_xp(backend: Optional[str] = None):
    backend = backend or os.environ.get("TPU_ACIR_BACKEND", "jax")
    if backend == "numpy":
        return np
    from .utils.jaxcfg import setup_jax
    setup_jax()
    import jax.numpy as jnp
    return jnp


_CACHE: Dict[Tuple[bytes, ProofConfig, int], Tuple[AcirTranslator, ProvingKey]] = {}


def load_and_compile(bytecode_path: str, config: ProofConfig = STANDARD_CONFIG,
                     backend: Optional[str] = None):
    """ACIR artifact -> (translator, proving key), cached by file content."""
    with open(bytecode_path, "rb") as f:
        content = f.read()
    xp = _select_xp(backend)
    key = (hashlib.sha256(content).digest(), config, id(xp))
    if key in _CACHE:
        return _CACHE[key]
    program = codec.load_program_artifact(bytecode_path)
    tr = translate_program(program)
    compiled = compile_circuit(tr.builder)
    pk = ProvingKey(compiled, config, xp=xp)
    _CACHE[key] = (tr, pk)
    return tr, pk


def _prove_dispatch(pk, ext):
    """jax backend defaults to the fused single-program prover (one compiled
    XLA program, one host<->device round trip — tests/test_fused.py asserts
    byte-identity with the per-phase path) for traces up to 2^18 rows;
    larger traces use the per-phase path, whose inter-phase temporaries are
    freed between programs.  On an H100 80GB (700 W) the fused ECDSA prove
    at 2^17 rows peaked at 2.7 GB and the per-phase prove at 2^20 rows at
    13.1 GB (peak_bytes_in_use, PERF.md); the cutoff is kept until the
    fused program's peak at larger sizes is measured.  TPU_ACIR_FUSED=0/1
    forces."""
    is_jax = pk.G.xp is not np
    fused_default = "1" if pk.n <= (1 << 18) else "0"
    if is_jax and os.environ.get("TPU_ACIR_FUSED", fused_default) != "0":
        from .prover.fused import prove_fused
        return prove_fused(pk, ext)
    return prove(pk, ext)


def prove_file(bytecode_path: str, witness_path: str, out_path: str,
               config: ProofConfig = STANDARD_CONFIG,
               backend: Optional[str] = None, compress: bool = True) -> bytes:
    tr, pk = load_and_compile(bytecode_path, config, backend)
    ws = codec.load_witness_stack(witness_path)
    witness_map = ws.peek().witness if ws.stack else {}
    ext = tr.external_values(witness_map)
    proof = _prove_dispatch(pk, ext)
    if compress:
        # the reference always writes compressed proofs (prove_action.rs:64-79)
        data = serialize_compressed_proof(compress_proof(pk.vk, proof))
    else:
        data = serialize_proof(proof)
    with open(out_path, "wb") as f:
        f.write(data)
    return data


def write_vk_file(bytecode_path: str, out_path: str,
                  config: ProofConfig = STANDARD_CONFIG,
                  backend: Optional[str] = None) -> bytes:
    _, pk = load_and_compile(bytecode_path, config, backend)
    data = serialize_vk(pk.vk)
    with open(out_path, "wb") as f:
        f.write(data)
    return data


def verify_file(vk_path: str, proof_path: str) -> None:
    """Raises on failure; returns None on success (reference semantics:
    empty output = success, panic = failure, verify_action.rs:10-18)."""
    import struct
    with open(vk_path, "rb") as f:
        vk = deserialize_vk(f.read())
    with open(proof_path, "rb") as f:
        data = f.read()
    if len(data) >= 4 and struct.unpack("<I", data[:4])[0] == COMPRESSED_PROOF_MAGIC:
        proof = decompress_proof(vk, deserialize_compressed_proof(data))
    else:
        proof = deserialize_proof(data)
    verify(vk, proof)
