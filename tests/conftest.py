"""Test configuration: the suite runs on JAX's CPU backend with an 8-device
virtual mesh, so the sharding tests need no accelerator.

XLA_FLAGS is read when the first backend initializes, which has not
happened yet when this file runs.  JAX_PLATFORMS defaults to ``cpu``; the
tests marked ``gpu`` run only where it names a GPU platform, as in
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` on a machine with
an NVIDIA card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# native-u64 Goldilocks path (field/gl.py): ~5x fewer ops per field
# multiply than the 16-bit-limb path -> much faster XLA:CPU compiles and
# virtual-mesh execution; bit-identical values
jax.config.update("jax_enable_x64", True)

# persistent XLA compile cache: phase-program compiles on a small CPU host
# cost 10s-300s each; the cache makes them one-time across the whole suite
# and across runs
from tpu_acir_prover.utils.jaxcfg import setup_jax_cache  # noqa: E402

setup_jax_cache()
