"""Platform plumbing: the exactness the GPU path relies on, the compile
cache placement, per-platform path selection, and chip_smoke.py's contract.

Tests marked ``gpu`` need a GPU that JAX can see; they skip elsewhere (the
suite runs on the CPU) and chip_smoke.py covers the same ground on the card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_acir_prover.field.gl import P, make_gl, uses_u64
from tpu_acir_prover.field.poseidon import WIDTH, _ME_INT, make_poseidon
from tpu_acir_prover.prover.ntt import ntt
from tpu_acir_prover.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _device(platform):
    """The first device of `platform`, or skip (decided at run time)."""
    try:
        return jax.devices(platform)[0]
    except RuntimeError:
        pytest.skip(f"no {platform} device visible to JAX")


def _split(v):
    v = np.asarray(v, dtype=np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


@pytest.mark.parametrize("platform", ["cpu",
                                      pytest.param("gpu",
                                                   marks=pytest.mark.gpu)])
def test_external_matrix_exact_at_worst_case_limbs(platform):
    """Every u16 limb 0xFFFF maximizes the f32 einsum's partial sums
    (14 * 0xFFFF * 12 terms < 2^24): the result must equal an integer
    matmul exactly, which holds only at full f32 precision."""
    dev = _device(platform)
    H = make_poseidon(make_gl(jnp))
    state = np.full((WIDTH, 4), 0xFFFFFFFF, dtype=np.uint32)
    state[:, 1] = 0xFFFF0000        # canonical values with mixed limbs
    state[:, 2] = 0x0000FFFF
    state[:, 3] = 0xFFFFFFFE
    lo = jax.device_put(state, dev)
    hi = jax.device_put(state, dev)
    out = jax.jit(H.external_matrix)((lo, hi))
    got = (np.asarray(out[1], dtype=object) << 32) | np.asarray(out[0],
                                                                dtype=object)
    val = (state.astype(object) << 32) | state.astype(object)
    want = (np.array(_ME_INT, dtype=object) @ val) % P
    assert (got == want).all()


def _lowered_ntt(platform, log_n):
    """StableHLO text of the jitted NTT as lowered for `platform`."""
    from jax import export
    G = make_gl(jnp)
    sds = jax.ShapeDtypeStruct((1 << log_n, 3), jnp.uint32)
    fn = jax.jit(lambda a, b: ntt(G, (a, b)))
    return export.export(fn, platforms=[platform])(sds, sds).mlir_module()


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_platform_path_selection(platform):
    """The measured choices, in the program lowered for the platform:
    native-u64 field ops and the rolled NTT, whose program does not grow
    with log n (the unrolled form adds a pass per stage)."""
    assert uses_u64(jnp) and not uses_u64(np)
    small, large = _lowered_ntt(platform, 6), _lowered_ntt(platform, 12)
    assert "xui64>" in small
    assert small.count("stablehlo.while") == 3
    for op in ("stablehlo.while", "stablehlo.multiply", "stablehlo.gather"):
        assert small.count(op) == large.count(op), op


@pytest.mark.parametrize("log_n", [1, 9])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_jax_matches_numpy(log_n, inverse):
    """The jax (rolled) NTT agrees with the numpy (static radix-2) one bit
    for bit, down to the 2-point transform."""
    lo, hi = _split(np.random.default_rng(4).integers(
        0, P, size=(1 << log_n, 3), dtype=np.uint64))
    G = make_gl(jnp)
    out = jax.jit(lambda a, b: ntt(G, (a, b), inverse=inverse))(lo, hi)
    ref = ntt(make_gl(np), (lo, hi), inverse=inverse)
    assert np.array_equal(np.asarray(out[0]), ref[0])
    assert np.array_equal(np.asarray(out[1]), ref[1])


def test_cache_dir_honours_jax_env():
    assert jaxcfg.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) \
        is None
    assert jaxcfg.cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_chip_smoke_refuses_cpu_only_process():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


def test_chip_smoke_script_fails_without_gpu():
    """Run as a user runs it, with no GPU: nonzero exit, no JSON result."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("argv,expect", [
    ([], ["device", "ntt", "merkle", "ecdsa", "big_trace"]),
    (["--multi"], ["device", "multi"]),
])
def test_chip_smoke_phase_selection(monkeypatch, capsys, argv, expect):
    ran = []
    monkeypatch.setenv("JAX_PLATFORMS", os.environ.get("JAX_PLATFORMS", ""))
    monkeypatch.setattr(chip_smoke, "require_gpu",
                        lambda count=1: ["dev"] * count)
    for name in ("device", "ntt", "merkle", "ecdsa", "big_trace", "multi"):
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda *a, name=name: ran.append(name))
    assert chip_smoke.main(argv) == 0
    assert ran == expect
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"ok": true')


@pytest.mark.gpu
def test_ntt_on_gpu_matches_numpy():
    dev = _device("gpu")
    rng = np.random.default_rng(3)
    lo, hi = _split(rng.integers(0, P, size=(1 << 12, 3), dtype=np.uint64))
    G = make_gl(jnp)
    out = jax.jit(lambda a, b: ntt(G, (a, b)))(jax.device_put(lo, dev),
                                               jax.device_put(hi, dev))
    ref = ntt(make_gl(np), (lo, hi))
    assert np.array_equal(np.asarray(out[0]), ref[0])
    assert np.array_equal(np.asarray(out[1]), ref[1])
