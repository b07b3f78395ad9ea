# Single entry point for the build/test/bench matrix
# (reference analogue: CMakeLists test registration + .github/workflows).
#
# The CPU test matrix pins the virtual 8-device mesh; smoke, gpu-test and
# bench need a GPU visible to JAX.

PY ?= python
TEST_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: all install libradial test test-fast test-gpu smoke bench dryrun clean

all: libradial install

install:
	pip install -e . --no-deps --no-build-isolation

libradial: rslmtoasa/native/libradial.so

rslmtoasa/native/libradial.so: rslmtoasa/native/radial.cpp
	g++ -O2 -shared -fPIC $< -o $@

# full CPU suite: unit tiers + the reference case matrices at 1e-6 when
# the reference tree is mounted
test: libradial
	$(TEST_ENV) $(PY) -m pytest tests/ -q

# one case per reference family (fast iteration)
test-fast: libradial
	$(TEST_ENV) RSLMTO_FAST_MATRIX=1 $(PY) -m pytest tests/ -q

# the CLI pipeline on one GPU against the CPU (see chip_smoke.py)
smoke:
	$(PY) chip_smoke.py

# engine-level GPU-vs-CPU tests (skip without a GPU)
test-gpu:
	$(PY) -m pytest tests/ -q -m gpu --noconftest

# complex128 scalar recursion throughput (needs a GPU)
bench:
	$(PY) bench.py

# multi-chip sharding compile+run check on the virtual CPU mesh
dryrun:
	$(TEST_ENV) $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

clean:
	rm -f rslmtoasa/native/libradial.so
