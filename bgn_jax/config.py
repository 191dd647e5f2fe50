"""Unified configuration: one dataclass for scheme + mesh + kernel knobs.

SURVEY.md §5 specifies a single `BGNParams` capturing the reference's
entire configuration surface -- the positional NewKeyGen argument list
(bgn.go:65), PolyEncodingParams (bgn.go:20-24) and the Deterministic bool
-- plus the mesh/sharding and field-path choices that the reference has
no analog for.  The BGN_RNS_MILLER env var remains as an OVERRIDE of the
`rns_miller` field (an env var that is explicitly set wins), so
operational tweaking without code changes still works.

Usage:
    params = BGNParams(key_bits=512, msg_space=1021)
    pk, sk = params.keygen(rng)
    mesh = params.make_mesh()          # None when single-device

keygen/bench/CLI all construct from this (bench.py, cli.py); documented
in docs/ARCHITECTURE.md.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class BGNParams:
    """Everything configurable, in one place.

    Scheme fields mirror NewKeyGen(keyBits, msgSpace, polyBase,
    fpScaleBase, fpPrecision, deterministic) (reference bgn.go:65) and
    default to the reference's test constants (bgn_test.go:8-13)."""

    # -- scheme (reference NewKeyGen args + PolyEncodingParams) ----------
    key_bits: int = 512
    msg_space: int = 1021
    poly_base: int = 3
    fp_scale_base: int = 3
    fp_precision: float = 0.0001
    deterministic: bool = True

    # -- mesh / sharding (no reference analog; SURVEY.md §2.3) -----------
    # n_devices None = all visible; 1-D 'data' mesh (DP + giant-step
    # sharding both ride it; parallel/pipeline.py adds a 'stage' axis).
    n_devices: Optional[int] = None
    mesh_axis: str = "data"

    # -- field path (None = library default; BGN_RNS_MILLER env wins) ----
    rns_miller: Optional[str] = None    # "auto" | "1" | "0"

    def __post_init__(self):
        if self.key_bits < 16 or self.key_bits % 2:
            raise ValueError("key_bits must be an even int >= 16")
        if self.msg_space < 2:
            raise ValueError("msg_space must be >= 2")

    # -- construction -----------------------------------------------------

    def keygen(self, rng=None):
        """Generate a key pair under this configuration (applies the
        field-path field first)."""
        from . import scheme
        self.apply_kernel_modes()
        return scheme.keygen(self.key_bits, self.msg_space, self.poly_base,
                             self.fp_scale_base, self.fp_precision,
                             self.deterministic, rng=rng)

    def make_mesh(self):
        """The 1-D device mesh, or None when only one device is in scope
        (callers then skip the sharded paths)."""
        import jax

        from .parallel import mesh as mesh_mod
        n = self.n_devices if self.n_devices is not None \
            else len(jax.devices())
        if n < 2:
            return None
        return mesh_mod.make_mesh(n, self.mesh_axis)

    def apply_kernel_modes(self) -> None:
        """Push the field-path field into the dispatch module.  An
        explicitly-set BGN_RNS_MILLER env var takes precedence (the
        operator override); an unset field leaves the default untouched."""
        from .ops import pairing as pairing_mod

        if self.rns_miller is not None and \
                "BGN_RNS_MILLER" not in os.environ:
            pairing_mod._RNS_MODE = self.rns_miller

    # -- (de)serialization ------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BGNParams":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown BGNParams fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def reference_test_config(cls) -> "BGNParams":
        """The reference's shared test constants (bgn_test.go:8-13)."""
        return cls(key_bits=512, msg_space=1021, poly_base=3,
                   fp_scale_base=3, fp_precision=0.0001,
                   deterministic=True)
