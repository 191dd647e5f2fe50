"""BGNParams unified configuration (bgn_jax/config.py; SURVEY.md §5)."""

import random

import pytest

from bgn_jax.config import BGNParams


def test_defaults_are_reference_test_constants():
    p = BGNParams()
    assert (p.key_bits, p.msg_space, p.poly_base, p.fp_scale_base,
            p.fp_precision, p.deterministic) == (512, 1021, 3, 3, 0.0001,
                                                 True)
    assert BGNParams.reference_test_config() == p


def test_dict_roundtrip_and_unknown_fields():
    p = BGNParams(key_bits=64, msg_space=101, rns_miller="1")
    assert BGNParams.from_dict(p.to_dict()) == p
    with pytest.raises(ValueError, match="unknown BGNParams"):
        BGNParams.from_dict({"key_bits": 64, "bogus": 1})


def test_validation():
    with pytest.raises(ValueError):
        BGNParams(key_bits=15)
    with pytest.raises(ValueError):
        BGNParams(key_bits=63)
    with pytest.raises(ValueError):
        BGNParams(msg_space=1)


def test_keygen_and_mesh():
    p = BGNParams(key_bits=64, msg_space=101)
    pk, sk = p.keygen(rng=random.Random(5))   # shared key value (conftest)
    assert pk.n == sk.a1_params.n
    mesh = p.make_mesh()            # 8 CPU devices under conftest
    assert mesh is not None and mesh.shape[p.mesh_axis] == 8
    assert BGNParams(key_bits=64, msg_space=101,
                     n_devices=1).make_mesh() is None


def test_env_var_overrides_field(monkeypatch):
    from bgn_jax.ops import pairing as pairing_mod

    before = pairing_mod._RNS_MODE
    try:
        # no env var: the field wins
        monkeypatch.delenv("BGN_RNS_MILLER", raising=False)
        BGNParams(key_bits=64, msg_space=101,
                  rns_miller="0").apply_kernel_modes()
        assert pairing_mod._RNS_MODE == "0"
        # env var set: it wins over the field
        monkeypatch.setenv("BGN_RNS_MILLER", "1")
        pairing_mod._RNS_MODE = "1"
        BGNParams(key_bits=64, msg_space=101,
                  rns_miller="0").apply_kernel_modes()
        assert pairing_mod._RNS_MODE == "1"
    finally:
        pairing_mod._RNS_MODE = before
