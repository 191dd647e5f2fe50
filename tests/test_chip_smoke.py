"""chip_smoke.py's phases at a 64-bit key on the CPU, plus the rules the
GPU bring-up rests on: the field-path dispatch, the compile-cache
directory and the native library built from csrc/ at first use."""

import os
import random
import subprocess
import sys

import jax
import pytest

from _kernels import clear_mode_kernels

import chip_smoke as cs
from bgn_jax.fieldcore import montgomery as mg
from bgn_jax.ops import pairing as pairing_mod
from bgn_jax.utils import cache, native

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def rns_forced(monkeypatch):
    """The GPU's field path (RNS) on the CPU, traced afresh."""
    clear_mode_kernels()
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "1")
    yield
    clear_mode_kernels()


@pytest.mark.parametrize("backend,want", [
    ("gpu", True), ("cpu", False), ("neuron", RuntimeError),
    ("rocm", RuntimeError)])
def test_field_path_dispatch(backend, want, monkeypatch, shared_keypair64):
    """gpu -> RNS, cpu -> limbs, any other backend -> a clear error; a
    key without an RNS context stays on limbs everywhere."""
    monkeypatch.setattr(pairing_mod, "_RNS_MODE", "auto")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    rns = shared_keypair64[0].dev.rns
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            pairing_mod.use_rns(rns)
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            mg.platform()
    else:
        assert pairing_mod.use_rns(rns) is want
        assert mg.platform() == backend
    assert pairing_mod.use_rns(None) is False


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    otherwise a fixed directory inside the checkout."""
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
        assert cache.enable_compile_cache(".jax_cache_cpu", 0.5) == \
            str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
        path = cache.enable_compile_cache(".jax_cache_cpu", 0.5)
        assert path == os.path.join(_REPO, ".jax_cache_cpu")
        assert jax.config.jax_compilation_cache_dir == path


def test_native_library_builds_from_source(tmp_path, monkeypatch):
    """csrc/ builds at first use into a build directory, and the library
    agrees with the pure-Python number theory."""
    from bgn_jax import hostmath as hm

    path = native.build(str(tmp_path))
    assert path is not None and os.path.exists(path)
    assert native.build(str(tmp_path)) == path      # up to date: reused
    lib = native.load(path)
    rng = random.Random(3)
    ns = [rng.getrandbits(120) | 1 for _ in range(200)] + [2 ** 127 - 1]
    got = [native.is_probable_prime(n, lib=lib) for n in ns]
    monkeypatch.setattr(native, "_TRIED", True)    # pure-Python path
    monkeypatch.setattr(native, "_LIB", None)
    want = [hm.is_probable_prime(n) for n in ns]
    assert got == want and got[-1] is True and any(got[:-1])


def test_native_build_without_compiler(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.build(str(tmp_path / "out")) is None
    assert "no C++ compiler" in capsys.readouterr().err


def test_chip_smoke_refuses_cpu():
    """No GPU -> non-zero exit and no `ok` line (no CPU carry-on)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(_REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_smoke_rns_exact(rns_forced, shared_keypair64):
    pk, sk = shared_keypair64
    cs.check_rns_exact(cs.field_of_key(pk, sk), 64, random.Random(1))


def test_smoke_pairing_vs_hostmath(rns_forced, shared_keypair64):
    pk, sk = shared_keypair64
    cs.check_pairing(cs.field_of_key(pk, sk), 8, random.Random(2))


def test_smoke_main_path(rns_forced, shared_keypair64, shared_tables64):
    pk, sk = shared_keypair64
    cs.main_path(pk, sk, shared_tables64, 16, 8, random.Random(3),
                 jax.random.key(0), "cpu", iters=1)


def test_smoke_four_devices(rns_forced, shared_keypair64, shared_tables64):
    """The --four phase on 4 of the 8 virtual CPU devices; the closing
    line counts the cards used, not the 8 visible."""
    pk, sk = shared_keypair64
    cs.four_cards(pk, sk, shared_tables64, 8, 2, random.Random(4))
    assert len(jax.devices()) == 8
    for n in (1, 4):
        line = cs.ok_line(jax.devices()[:n])
        assert line == {"ok": True, "device": {
            "platform": "cpu", "kind": jax.devices()[0].device_kind,
            "count": n}}


@pytest.mark.gpu
def test_smoke_on_gpu(gpu_device, shared_keypair64, shared_tables64):
    """The same phases on the card, where the dispatch itself picks RNS."""
    pk, sk = shared_keypair64
    assert pairing_mod.use_rns(pk.dev.rns)
    cs.check_rns_exact(cs.field_of_key(pk, sk), 256, random.Random(1))
    cs.check_pairing(cs.field_of_key(pk, sk), 8, random.Random(2))
    cs.main_path(pk, sk, shared_tables64, 64, 32, random.Random(3),
                 jax.random.key(0), "gpu", iters=1)
