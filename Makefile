# bgn_jax build targets (analog of the reference Makefile:1-12)

.PHONY: all native test bench smoke demo clean

all: native

# the library is also built at first use (bgn_jax/utils/native.py)
native: build/libbgnhost.so

build/libbgnhost.so: csrc/hostmath_accel.cpp
	mkdir -p build
	g++ -O2 -fPIC -shared -std=c++17 -o $@ $<

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# One pytest process per file: immune to the XLA:CPU long-process
# compiler instability (see tests/conftest.py).
test-isolated:
	for f in tests/test_*.py; do \
	  python -m pytest $$f -q || exit 1; \
	done

bench:
	python bench.py

smoke:
	python chip_smoke.py

demo:
	python -m bgn_jax.cli

clean:
	rm -rf build
