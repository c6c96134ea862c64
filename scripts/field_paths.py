#!/usr/bin/env python3
"""Probe behind the field-path choice (field/gl.py ``uses_u64``) and the
NTT form (prover/ntt.py, rolled only).

    python scripts/field_paths.py           GPU: NTT and Merkle timings
    python scripts/field_paths.py --count   any backend: NTTs per prove

Timings: the 2^20 x 6 forward NTT and the Poseidon leaf hash plus every
Merkle level of a 2^20 x 17 matrix, each jitted once on the native-u64
field path and once on the 16-bit-limb path (``make_gl(jnp,
force_u32=True)``); compile seconds and one steady run ending in
block_until_ready.  They need a GPU and exit nonzero without one.

Count: the NTT instances a prove traces, with their (log n, columns,
inverse), for the fused and the per-phase driver on a small circuit with
lookups.  Each traced instance is compiled once, so this is the number of
NTTs in the compiled programs; it is fixed by the drivers' code, not by n.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timings():
    import jax.numpy as jnp
    import jax
    import chip_smoke
    from tpu_acir_prover.field.gl import make_gl
    from tpu_acir_prover.field.poseidon import make_poseidon
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.merkle import leaf_digests, merkle_levels
    from tpu_acir_prover.prover.ntt import ntt
    cap = 1 << STANDARD_CONFIG.cap_height
    out = {}
    for path, force_u32 in (("u64", False), ("u32_limbs", True)):
        G = make_gl(jnp, force_u32=force_u32)
        H = make_poseidon(G)
        lo, hi = chip_smoke._rand_pair((1 << 20, 6), seed=1)
        tc, tr, _ = chip_smoke._timed(
            jax.jit(lambda a, b, G=G: ntt(G, (a, b))),
            jnp.asarray(lo), jnp.asarray(hi))
        out[f"ntt_2^20x6_{path}"] = {"compile_s": tc, "run_ms": tr * 1e3}
        lo, hi = chip_smoke._rand_pair((1 << 20, 17), seed=2)
        tc, tr, _ = chip_smoke._timed(
            jax.jit(lambda a, b, H=H: merkle_levels(
                H, leaf_digests(H, (a, b)), cap)),
            jnp.asarray(lo), jnp.asarray(hi))
        out[f"merkle_2^20x17_{path}"] = {"compile_s": tc, "run_ms": tr * 1e3}
    return out


def count_ntts():
    import jax
    from tpu_acir_prover import api
    from tpu_acir_prover.acir.translator import translate_program
    from tpu_acir_prover.circuit.compile import compile_circuit
    from tpu_acir_prover.prover import ntt as ntt_mod
    from tpu_acir_prover.prover.config import STANDARD_CONFIG
    from tpu_acir_prover.prover.prove import ProvingKey
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import factories
    seen = []
    rolled = ntt_mod._ntt_rolled

    def counted(G, lo, hi, log_n, inverse):
        seen.append((log_n, int(lo.shape[1]), inverse))
        return rolled(G, lo, hi, log_n, inverse)

    ntt_mod._ntt_rolled = counted
    prog, wm = factories.bitwise()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)
    out = {"circuit": f"bitwise, 2^{cc.log_n} rows, lookups"}
    for driver, fused in (("fused", "1"), ("per_phase", "0")):
        os.environ["TPU_ACIR_FUSED"] = fused
        jax.clear_caches()
        seen.clear()
        pk = ProvingKey(cc, STANDARD_CONFIG)
        in_key = list(seen)
        seen.clear()
        api._prove_dispatch(pk, ext)
        out[driver] = {"proving_key": len(in_key), "prove": len(seen),
                       "prove_instances": sorted(set(seen))}
    ntt_mod._ntt_rolled = rolled
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", action="store_true",
                    help="count NTT instances per prove (any backend)")
    args = ap.parse_args(argv)
    from tpu_acir_prover.utils.jaxcfg import setup_jax
    setup_jax()
    if args.count:
        print(json.dumps(count_ntts()))
        return 0
    import chip_smoke
    d = chip_smoke.require_gpu()[0]
    chip_smoke.phase_device([d])
    print(json.dumps({"device": d.device_kind, **timings()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
