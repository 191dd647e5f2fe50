"""ctypes bindings for the native host-math accelerator (csrc/).

The C++ library accelerates keygen's number-theory hot loops (the role
PBC's C param generator plays for the reference, bgn.go:93): Miller-Rabin
primality and the A1 cofactor search with an incremental small-prime sieve.
It is built from csrc/hostmath_accel.cpp at first use (or by `make
native`) into build/, which .gitignore lists.  Without a C++ compiler it
prints one stderr line and keygen uses the identical pure-Python path
(hostmath.py)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from typing import Optional

from .cache import REPO_ROOT

SOURCE = os.path.join(REPO_ROOT, "csrc", "hostmath_accel.cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build")
LIB_NAME = "libbgnhost.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def build(out_dir: str = BUILD_DIR) -> Optional[str]:
    """Compile the library into out_dir unless an up-to-date copy is
    there; returns its path, or None (with one stderr line) when no C++
    compiler is found or the build fails."""
    out = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(SOURCE):
        return out
    names = [os.environ["CXX"]] if os.environ.get("CXX") else \
        ["g++", "c++", "clang++"]
    cxx = next(filter(None, map(shutil.which, names)), None)
    if cxx is None:
        print("bgn_jax: no C++ compiler found; keygen uses the "
              "pure-Python number theory", file=sys.stderr)
        return None
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, "-O2", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, SOURCE], capture_output=True, text=True)
    if r.returncode != 0:
        print(f"bgn_jax: native build failed ({cxx}): "
              f"{r.stderr.strip()[:300]}; keygen uses the pure-Python "
              "number theory", file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.bgn_is_probable_prime.restype = ctypes.c_int
    lib.bgn_is_probable_prime.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.bgn_find_cofactor.restype = ctypes.c_ulonglong
    lib.bgn_find_cofactor.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_ulonglong, ctypes.c_int]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    _LIB = load(path) if path else None
    return _LIB


def available() -> bool:
    return _load() is not None


def is_probable_prime(n: int, rounds: int = 40,
                      lib: Optional[ctypes.CDLL] = None) -> Optional[bool]:
    """Native Miller-Rabin; None if the library is unavailable."""
    lib = lib or _load()
    if lib is None or n < 0:
        return None
    nbytes = max((n.bit_length() + 7) // 8, 1)
    if nbytes > 72 * 8:
        return None
    r = lib.bgn_is_probable_prime(n.to_bytes(nbytes, "little"), nbytes,
                                  rounds)
    if r < 0:
        return None
    return bool(r)


def find_cofactor(n: int, start_l: int = 4, max_l: int = 1 << 40,
                  rounds: int = 40) -> Optional[int]:
    """Native A1 cofactor search; None if unavailable or not found."""
    lib = _load()
    if lib is None:
        return None
    nbytes = max((n.bit_length() + 7) // 8, 1)
    if nbytes > 70 * 8:
        return None
    l = lib.bgn_find_cofactor(n.to_bytes(nbytes, "little"), nbytes,
                              start_l, max_l, rounds)
    return int(l) if l else None
