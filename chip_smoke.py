#!/usr/bin/env python3
"""Smoke run of the prover's main path on an NVIDIA GPU, in one process.

    python chip_smoke.py           one GPU, phases 1-4 below
    python chip_smoke.py --multi   four GPUs: the sharded prover only

Phases of the default run, in order:

  1. device: JAX's platform, device kind and count, then the card's name
     and power limit as nvidia-smi reports them;
  2. kernels against the plain reference at real widths, bit for bit:
     the Goldilocks NTT and inverse NTT at 2^20 x 6 against the numpy
     backend, and the Poseidon leaf hash plus every Merkle level of a
     2^20 x 17 matrix (the ECDSA wires oracle's LDE size) against JAX's CPU
     backend on the 16-bit-limb field path;
  3. the ECDSA secp256k1 fixture (2^17 rows, STANDARD_CONFIG, fused
     driver) through ``cli.main``: prove, write_vk, verify, a tampered
     proof rejected, and the proof's sha256 equal to the CPU digest below;
  4. the synthetic 2^20-row trace through the per-phase driver, verified.

``--multi`` proves the ECDSA fixture with ``prove_sharded`` on a 4-GPU
``sp`` mesh and compares its proof file byte for byte (by sha256) with the
single-device proof, whose digest is pinned below.

The last line of stdout is one JSON object naming the device.  Any failure,
and a process in which JAX finds no GPU, exits nonzero without it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# sha256 of the proof file `cli prove` writes for tests/factories.py's
# ecdsa_secp256k1() fixture under STANDARD_CONFIG, the same on JAX's CPU
# backend and on one H100 (PERF.md); recompute it on the CPU with:
#   JAX_PLATFORMS=cpu python -c "import chip_smoke as c, tempfile; \
#       print(c.sha256(c.ecdsa_cli(tempfile.mkdtemp())[0]))"
ECDSA_PROOF_SHA256 = \
    "1fba5e6d2c8af5db62eb1fc22348553f4b45ca227435cdb379c625851860c7d6"

NTT_LOG_N, NTT_COLS = 20, 6
MERKLE_LOG_ROWS, MERKLE_COLS = 20, 17
BIG_LOG_N = 20


def say(*parts):
    print(*parts, flush=True)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def require_gpu(count: int = 1):
    """The first `count` JAX devices, which must be GPUs; SystemExit
    otherwise (never a fallback to the CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPU(s), JAX found "
                         f"{len(devs)} {devs[0].platform} device(s)")
    return devs[:count]


def peak_bytes(dev):
    """The device's high-water mark of bytes in use (None where the
    backend keeps no memory statistics, as on the CPU)."""
    stats = dev.memory_stats()
    return stats["peak_bytes_in_use"] if stats else None


def _rand_pair(shape, seed):
    from tpu_acir_prover.field.gl import P
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _timed(fn, *args):
    """(compile seconds, steady run seconds, output) of a jitted fn; the
    run ends in block_until_ready."""
    import jax
    t = time.perf_counter()
    exe = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t
    jax.block_until_ready(exe(*args))
    t = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    return t_compile, time.perf_counter() - t, out


def _equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b)) and len(a) == len(b)


# ---------------------------------------------------------------------------
# phases


def phase_device(devs):
    d = devs[0]
    say(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    say(f"nvidia-smi: {smi.stdout.strip()}")


def phase_ntt():
    import jax
    import jax.numpy as jnp
    from tpu_acir_prover.field.gl import make_gl
    from tpu_acir_prover.prover.ntt import intt, ntt
    G, Gnp = make_gl(jnp), make_gl(np)
    lo, hi = _rand_pair((1 << NTT_LOG_N, NTT_COLS), seed=1)
    for name, f in (("ntt", ntt), ("intt", intt)):
        fn = jax.jit(lambda a, b, f=f: f(G, (a, b)))
        tc, tr, out = _timed(fn, jnp.asarray(lo), jnp.asarray(hi))
        ref = f(Gnp, (lo, hi))
        check(_equal(out, ref), f"{name} differs from the numpy reference")
        say(f"kernel {name} 2^{NTT_LOG_N}x{NTT_COLS}: bit-identical to "
            f"numpy; compile {tc:.3f} s, run {tr * 1e3:.3f} ms")


def phase_merkle():
    """Leaf sponge + all Merkle levels on the GPU vs JAX's CPU backend on
    the 16-bit-limb path (an independent field implementation)."""
    import jax
    import jax.numpy as jnp
    from tpu_acir_prover.field.gl import make_gl
    from tpu_acir_prover.field.poseidon import make_poseidon
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.merkle import leaf_digests, merkle_levels
    cap = 1 << STANDARD_CONFIG.cap_height

    def build(H):
        return jax.jit(lambda a, b: merkle_levels(
            H, leaf_digests(H, (a, b)), cap))

    lo, hi = _rand_pair((1 << MERKLE_LOG_ROWS, MERKLE_COLS), seed=2)
    H = make_poseidon(make_gl(jnp))
    tc, tr, out = _timed(build(H), jnp.asarray(lo), jnp.asarray(hi))
    cpu = jax.devices("cpu")[0]
    Hc = make_poseidon(make_gl(jnp, force_u32=True))
    ref = build(Hc)(jax.device_put(lo, cpu), jax.device_put(hi, cpu))
    flat = [c for lev in out for c in lev]
    flat_ref = [c for lev in ref for c in lev]
    check(_equal(flat, flat_ref), "Merkle levels differ from the reference")
    say(f"kernel poseidon leaf+merkle 2^{MERKLE_LOG_ROWS}x{MERKLE_COLS}: "
        f"{len(out)} levels bit-identical to JAX-CPU u32 limbs "
        f"(external matrix: f32 einsum at Precision.HIGHEST); "
        f"compile {tc:.3f} s, run {tr * 1e3:.3f} ms")


def ecdsa_cli(workdir: str):
    """Prove, write_vk and verify the ECDSA fixture through cli.main.
    Returns (proof bytes, cold seconds, steady seconds, paths)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import factories
    from tpu_acir_prover import cli
    from tpu_acir_prover.acir import codec, ir
    prog, wm = factories.ecdsa_secp256k1()
    paths = {k: os.path.join(workdir, k)
             for k in ("prog.json", "witness.gz", "proof", "vk")}
    codec.save_program_artifact(paths["prog.json"], prog)
    codec.save_witness_stack(paths["witness.gz"],
                             ir.WitnessStack([ir.StackItem(0, wm)]))
    prove = ["prove", "-b", paths["prog.json"], "-w", paths["witness.gz"],
             "-o", paths["proof"]]
    t = time.perf_counter()
    check(cli.main(prove) == 0, "cli prove failed")
    cold = time.perf_counter() - t
    t = time.perf_counter()
    check(cli.main(prove) == 0, "cli prove failed")
    steady = time.perf_counter() - t
    check(cli.main(["write_vk", "-b", paths["prog.json"],
                    "-o", paths["vk"]]) == 0, "cli write_vk failed")
    check(cli.main(["verify", "-k", paths["vk"],
                    "-p", paths["proof"]]) == 0, "proof rejected")
    with open(paths["proof"], "rb") as f:
        return f.read(), cold, steady, paths


def phase_ecdsa(dev):
    from tpu_acir_prover import cli
    with tempfile.TemporaryDirectory() as wd:
        proof, cold, steady, paths = ecdsa_cli(wd)
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 0x01
        tampered = os.path.join(wd, "tampered")
        with open(tampered, "wb") as f:
            f.write(bytes(bad))
        check(cli.main(["verify", "-k", paths["vk"],
                        "-p", tampered]) == 1, "tampered proof accepted")
    digest = sha256(proof)
    check(digest == ECDSA_PROOF_SHA256,
          f"proof sha256 {digest} != CPU digest {ECDSA_PROOF_SHA256}")
    say(f"ecdsa 2^17 via cli: verified, tampered proof rejected, sha256 "
        f"equals the CPU digest ({len(proof)} bytes)")
    say(f"ecdsa 2^17: cold set-up {cold:.3f} s, steady prove "
        f"{steady:.3f} s, peak_bytes_in_use {peak_bytes(dev)}")


def phase_big_trace(dev):
    from tpu_acir_prover import api
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.prove import ProvingKey
    from tpu_acir_prover.prover.verify import verify
    from tpu_acir_prover.utils.bench_circuits import mul_chain_circuit
    cc = mul_chain_circuit(BIG_LOG_N)
    ext = np.array([], dtype=np.uint64)
    t = time.perf_counter()
    pk = ProvingKey(cc, STANDARD_CONFIG)
    api._prove_dispatch(pk, ext)
    cold = time.perf_counter() - t
    t = time.perf_counter()
    proof = api._prove_dispatch(pk, ext)
    steady = time.perf_counter() - t
    verify(pk.vk, proof)
    say(f"mul_chain 2^{BIG_LOG_N} (per-phase driver): verified; cold "
        f"set-up {cold:.3f} s, steady prove {steady:.3f} s, "
        f"peak_bytes_in_use {peak_bytes(dev)}")


def phase_multi(devs, program=None, config=None,
                digest=ECDSA_PROOF_SHA256):
    """prove_sharded on an sp mesh over `devs`, verified, and its proof
    file (as ``cli prove`` writes it) byte-identical to the single-device
    proof, whose sha256 is `digest`.  Defaults: the ECDSA fixture at
    STANDARD_CONFIG and the pinned digest, which the CPU and a single H100
    both produce, so the single-device prover need not be compiled here."""
    from jax.sharding import Mesh
    from tpu_acir_prover.acir.translator import translate_program
    from tpu_acir_prover.circuit.compile import compile_circuit
    from tpu_acir_prover.parallel.prove import ShardedProvingKey, \
        prove_sharded
    from tpu_acir_prover.prover.compress import compress_proof
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.serialization import \
        serialize_compressed_proof
    from tpu_acir_prover.prover.verify import verify
    if program is None:
        sys.path.insert(0, os.path.join(REPO, "tests"))
        import factories
        program = factories.ecdsa_secp256k1()
    config = config or STANDARD_CONFIG
    prog, wm = program
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)
    mesh = Mesh(np.array(devs), ("sp",))
    t = time.perf_counter()
    spk = ShardedProvingKey(cc, config, mesh=mesh)
    proof = prove_sharded(spk, ext)
    t_cold = time.perf_counter() - t
    t = time.perf_counter()
    proof = prove_sharded(spk, ext)
    t_steady = time.perf_counter() - t
    verify(spk.vk, proof)
    got = sha256(serialize_compressed_proof(compress_proof(spk.vk, proof)))
    check(got == digest, f"sharded proof sha256 {got} != single-device "
          f"proof sha256 {digest}")
    peaks = [peak_bytes(d) for d in devs]
    say(f"sharded prove sp={len(devs)} n=2^{cc.log_n}: verified, "
        f"byte-identical to the single-device proof (sha256 {got}); cold "
        f"set-up {t_cold:.3f} s, steady prove {t_steady:.3f} s, "
        f"peak_bytes_in_use per device {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded ECDSA prove vs single-GPU")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    sys.path.insert(0, REPO)
    count = 4 if args.multi else 1
    devs = require_gpu(count)
    from tpu_acir_prover.utils.jaxcfg import setup_jax
    setup_jax()
    phase_device(devs)
    if args.multi:
        phase_multi(devs)
    else:
        phase_ntt()
        phase_merkle()
        phase_ecdsa(devs[0])
        phase_big_trace(devs[0])
    import jax
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
