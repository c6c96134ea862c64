# Orchestration analog of the reference's Makefile happy path
# (/root/reference/Makefile:38-54): one-command repro targets a reviewer on
# a small CPU-only box can actually run.  No installation step — the
# package is pure Python on the baked-in jax/numpy.

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: help test test-fast examples happy-path dryrun bench clean-cache

help:
	@echo "targets:"
	@echo "  test-fast    core unit tests (field/hash/codec/golden/structural)"
	@echo "  test         full suite on the CPU (the compile cache helps reruns)"
	@echo "  examples     reference-style happy path over every example circuit"
	@echo "  happy-path   single prove -> write_vk -> verify round trip via the CLI"
	@echo "  dryrun       8-virtual-device sharded multi-device prove"
	@echo "  bench        benchmark (emits JSON metric lines; needs a GPU)"
	@echo "  clean-cache  drop the persistent XLA compile cache"

test-fast:
	$(PY) -m pytest tests/test_field.py tests/test_hashing.py \
	  tests/test_acir_codec.py tests/test_acir_golden.py \
	  tests/test_structural.py tests/test_compress.py tests/test_lookup.py \
	  tests/test_bigint_curve.py tests/test_sha256.py -q

test:
	$(PY) -m pytest tests/ -q

examples:
	$(CPU_ENV) $(PY) examples/run_examples.py

happy-path:
	@tmp=$$(mktemp -d) && cd $$tmp && \
	PYTHONPATH=$(CURDIR) $(CPU_ENV) $(PY) -c "import sys; \
	sys.path.insert(0, '$(CURDIR)/tests'); import factories; \
	from tpu_acir_prover.acir import codec, ir; \
	prog, wm = factories.fibonacci(); \
	codec.save_program_artifact('prog.json', prog); \
	codec.save_witness_stack('witness.gz', ir.WitnessStack([ir.StackItem(0, wm)]))" && \
	PYTHONPATH=$(CURDIR) $(CPU_ENV) $(PY) -m tpu_acir_prover.cli prove -b prog.json -w witness.gz -o proof && \
	PYTHONPATH=$(CURDIR) $(CPU_ENV) $(PY) -m tpu_acir_prover.cli write_vk -b prog.json -o vk && \
	PYTHONPATH=$(CURDIR) $(CPU_ENV) $(PY) -m tpu_acir_prover.cli verify -k vk -p proof && \
	echo "happy path ok: proved + verified" && rm -rf $$tmp

dryrun:
	$(CPU_ENV) $(PY) __graft_entry__.py

bench:
	$(PY) bench.py

clean-cache:
	rm -rf .jax_cache
