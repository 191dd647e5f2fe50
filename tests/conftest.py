"""Test configuration: force the local CPU backend with 8 virtual devices
so multi-device sharding paths are exercised without a GPU (the
fake-backend layer the reference lacks; SURVEY.md §4 item 4).  The
platform goes through jax.config.update so it holds even when jax was
imported before this file ran.

Tests that need the GPU carry the `gpu` marker and skip inside the
`gpu_device` fixture (run them on the card with JAX_PLATFORMS=cuda, see
below); `python chip_smoke.py` runs the same phases at full width."""
import os

flags = os.environ.get("XLA_FLAGS", "")
# xla_cpu_parallel_codegen_split_count=1: XLA:CPU sporadically SIGABRTs
# while compiling our large unrolled/scan graphs with parallel codegen.
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
        " --xla_cpu_parallel_codegen_split_count=1").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# CPU unless JAX_PLATFORMS names another platform: on the GPU machine,
# `JAX_PLATFORMS=cuda python -m pytest -o addopts= tests -m gpu` runs the
# tests that need the card.
_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _PLATFORMS)
if _PLATFORMS == "cpu":
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()

from bgn_jax.utils.cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: XLA:CPU compiles of the 512-bit graphs
# dominate suite wall time; cache them across runs and across the
# per-module jax.clear_caches() below (which drops only the in-memory
# executables).  0.5s threshold: the suite's cost is ~100 per-process
# kernel first-calls, most of them 2-4s compiles.
enable_compile_cache(".jax_cache_cpu", min_compile_secs=0.5)


def pytest_collection_modifyitems(config, items):
    """Tests marked `slow` (multi-minute 1024-bit CPU compiles) run only
    when explicitly requested via BGN_RUN_SLOW=1."""
    if os.environ.get("BGN_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: set BGN_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


# Modules whose shard_map / wide-key compiles are the big-allocation
# storms behind XLA:CPU's sporadic backend_compile SIGABRT (r5
# re-confirmed: with no hygiene at all a worker crashed in
# test_parallel; every file passes standalone).
_HEAVY_COMPILE_MODULES = {
    "test_parallel", "test_pipeline", "test_multihost",
    "test_largekey", "test_large_msgspace",
}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_around_heavy_modules(request):
    """Targeted cache hygiene (r5).  The old per-module
    jax.clear_caches() forced EVERY module to re-pay each kernel's
    first-call cost (2-14s of tracing + persistent-cache load per
    kernel; warm execution is milliseconds) -- the dominant term of the
    18-21-minute suite.  Clearing only around the heavy-compile modules
    protects their big compiles from accumulated executables while the
    light modules share one warm kernel set per worker.  Mode-flip
    tests additionally clear surgically via
    tests/_kernels.clear_mode_kernels."""
    heavy = request.module.__name__.rsplit(".", 1)[-1] \
        in _HEAVY_COMPILE_MODULES
    if heavy:
        jax.clear_caches()
    yield
    if heavy:
        jax.clear_caches()


@pytest.fixture(scope="session")
def shared_keypair64():
    """ONE 64-bit keypair shared across the fast test modules.  Same
    rationale as shared_keypair: MontCtx.p_host keys the jit and
    persistent caches by key VALUE, so every distinct 64-bit key used to
    retrace + recompile the whole kernel set (test_rns alone built 8)."""
    import random

    from bgn_jax import scheme
    rng = random.Random(5)
    return scheme.keygen(64, 101, rng=rng)


@pytest.fixture(scope="session")
def shared_tables64(shared_keypair64):
    import random

    pk, sk = shared_keypair64
    return pk.setup_decryption(sk, rng=random.Random(5))


@pytest.fixture(scope="session")
def shared_keypair():
    """ONE keypair + decrypt tables shared across test modules (VERDICT
    r3 item 8): MontCtx.p_host is a static pytree field, so the jit AND
    persistent caches are keyed by key VALUE -- per-module random keys
    defeated both and re-traced every kernel per module.

    r5: 64-bit (L = 6 limbs), the SAME underlying key as
    shared_keypair64 (identical rng stream; msg_space only guards the
    prime sizes and sets the BSGS bound), so the two fixtures share ONE
    kernel trace/compile set.  Tracing cost of the unrolled-CIOS kernel
    graphs scales ~L^2 -- the old 160-bit key (L = 12) made every
    scheme-level test pay 20-80s of pure-Python tracing (the dominant
    term of the 18-21-minute suite).  Reference msg_space otherwise
    (bgn_test.go:8-13: 1021); full-width realism lives in
    test_reference_constants (512-bit end-to-end) and test_largekey
    (1024-bit, slow-gated)."""
    import random

    from bgn_jax import scheme
    rng = random.Random(5)
    pk, sk = scheme.keygen(64, 1021, rng=rng)
    tables = pk.setup_decryption(sk, rng=rng)
    return pk, sk, tables


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips (here, never at import) on hosts
    without one.  Tests under the `gpu` marker take this fixture."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
