"""Benchmark harness.

Emits one JSON metric line per benchmark on stdout; the LAST line is the
headline end-to-end prover wall time.
Default (BENCH_MODE=all): NTT kernel line, ECDSA flagship e2e line, then
the 2^LOG_N e2e prove line.  BENCH_MODE=ntt|ecdsa|prove runs a single
benchmark.  Any failure exits nonzero.

Timing notes: proofs are host objects (the prove call transfers the proof
pytree), so wall-clock around the call includes the device work; kernel
timings end in block_until_ready.

Baselines (BASELINE.md): the reference publishes no numbers; vs_baseline
is the ratio to a single-core Rust estimate — ~20 s e2e at 2^20 rows
(plonky2-class), ~175e6 butterflies/s for the FFT kernel.
"""

import json
import os
import sys
import time

import numpy as np

LOG_N = int(os.environ.get("BENCH_LOG_N", "20"))
COLS = int(os.environ.get("BENCH_COLS", "6"))
REPS = int(os.environ.get("BENCH_REPS", "4"))
MODE = os.environ.get("BENCH_MODE", "all")  # all | prove | ntt | ecdsa
RUST_SINGLE_CORE_BUTTERFLIES_PER_S = 175e6
# single-core Rust plonky2 end-to-end prove estimate at 2^20 rows
# (plonky2 README-class numbers extrapolated to one core): ~20 s
RUST_SINGLE_CORE_PROVE_S = 20.0


def emit(metric, value, unit, vs):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs}), flush=True)


def _timer():
    from tpu_acir_prover.utils.timing import PhaseTimer
    return PhaseTimer(enabled=True)


def bench_prove():
    """End-to-end prover wall time at 2^LOG_N rows (steady state, compile
    cached in the ProvingKey).  Uses the fused single-program prover unless
    BENCH_FUSED=0 selects the per-phase driver."""
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.prove import ProvingKey, prove
    from tpu_acir_prover.prover.fused import prove_fused
    from tpu_acir_prover.utils.bench_circuits import mul_chain_circuit

    fused = os.environ.get("BENCH_FUSED", "1") != "0"
    do_prove = prove_fused if fused else prove

    cc = mul_chain_circuit(LOG_N)
    t0 = time.perf_counter()
    pk = ProvingKey(cc, STANDARD_CONFIG)
    print(f"  pk_build: {time.perf_counter() - t0:.2f}s", file=sys.stderr,
          flush=True)
    ext = np.array([], dtype=np.uint64)
    t0 = time.perf_counter()
    do_prove(pk, ext)  # warmup: compiles
    print(f"  warmup_prove: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr, flush=True)
    reps = max(1, REPS // 2)
    t0 = time.perf_counter()
    for _ in range(reps):
        timer = _timer()
        proof = do_prove(pk, ext, timer=timer)
    dt = (time.perf_counter() - t0) / reps
    timer.report()  # phase breakdown of the last rep, unconditionally
    del proof
    emit(f"prover_wall_time_2pow{LOG_N}_rows", round(dt, 3), "s",
         round(RUST_SINGLE_CORE_PROVE_S / dt, 2))


def bench_ecdsa():
    """End-to-end ECDSA prove+verify wall time (the reference's flagship
    workload, test_precompiled.rs:7-44) at STANDARD_CONFIG."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import factories
    from tpu_acir_prover.acir.translator import translate_program
    from tpu_acir_prover.circuit.compile import compile_circuit
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.fused import prove_fused
    from tpu_acir_prover.prover.prove import ProvingKey
    from tpu_acir_prover.prover.verify import verify

    prog, wm = factories.ecdsa_secp256k1()
    t0 = time.perf_counter()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    print(f"  ecdsa translate+compile: {time.perf_counter() - t0:.2f}s "
          f"({cc.n} rows)", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    pk = ProvingKey(cc, STANDARD_CONFIG)
    print(f"  ecdsa pk_build: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr, flush=True)
    ext = tr.external_values(wm)
    t0 = time.perf_counter()
    proof = prove_fused(pk, ext)
    print(f"  ecdsa warmup_prove: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr, flush=True)
    verify(pk.vk, proof)
    reps = max(1, REPS // 2)
    t0 = time.perf_counter()
    for _ in range(reps):
        proof = prove_fused(pk, ext)
    dt = (time.perf_counter() - t0) / reps
    verify(pk.vk, proof)
    emit(f"ecdsa_prover_wall_time_2pow{cc.log_n}_rows", round(dt, 3), "s",
         round(RUST_SINGLE_CORE_PROVE_S / dt, 2))


def bench_ntt():
    """Goldilocks NTT kernel throughput (the prover's default NTT form)."""
    import jax
    import jax.numpy as jnp
    from tpu_acir_prover.field.gl import make_gl, P
    from tpu_acir_prover.prover.ntt import ntt

    G = make_gl(jnp)
    n = 1 << LOG_N
    rng = np.random.default_rng(0)
    vals = rng.integers(0, P, size=(n, COLS), dtype=np.uint64)
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))

    fn = jax.jit(lambda a, b: ntt(G, (a, b)))
    jax.block_until_ready(fn(lo, hi))  # compile + warmup
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(lo, hi))
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    butterflies = COLS * (n // 2) * LOG_N
    rate = butterflies / dt
    emit(f"goldilocks_ntt_butterflies_per_s_chip (2^{LOG_N} x {COLS})",
         round(rate, 1), "butterflies/s",
         round(rate / RUST_SINGLE_CORE_BUTTERFLIES_PER_S, 3))


def main():
    from tpu_acir_prover.utils.jaxcfg import setup_jax
    setup_jax()
    if MODE == "prove":
        return bench_prove()
    if MODE == "ecdsa":
        return bench_ecdsa()
    if MODE == "ntt":
        return bench_ntt()
    # all: headline (prove) LAST
    bench_ntt()
    bench_ecdsa()
    return bench_prove()


if __name__ == "__main__":
    sys.exit(main())
