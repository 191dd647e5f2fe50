"""Reference-interop tests: gob wire format, PBC byte/string codecs,
wrapper round-trips, and the conformance channel (synthetic vectors in the
exact tools/dump_reference.go layout; real Go-produced fixtures are picked
up automatically from tests/vectors/reference/).

Everything here is host-side except the small-key device round-trip, so
this file runs in seconds.
"""

import base64
import glob
import json
import os
import random

import numpy as np
import pytest

from bgn_jax import hostmath as hm
from bgn_jax import scheme
from bgn_jax.interop import (ciphertext_from_gob, ciphertext_to_gob,
                             conformance, gob, pbc,
                             poly_ciphertext_from_gob, poly_ciphertext_to_gob,
                             public_key_from_gob, public_key_to_gob,
                             verify_reference_vectors)

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors", "reference")


# ---------------------------------------------------------------------------
# gob wire format
# ---------------------------------------------------------------------------


def test_gob_point_example():
    """The worked struct{X, Y int}{22, 33} example from the encoding/gob
    package documentation, byte for byte."""
    point_t = gob.struct_of("Point", [("X", gob.INT_T), ("Y", gob.INT_T)])
    want = bytes.fromhex(
        "1fff8103010105506f696e7401ff8200"
        "01020101580104000101590104000000"
        "07ff82012c014200")
    got = gob.dumps(point_t, {"X": 22, "Y": 33})
    assert got == want
    assert gob.loads(got) == {"X": 22, "Y": 33}


def test_gob_uint_int_float_encodings():
    # spec: < 128 one byte; else -len prefix + big-endian bytes
    assert gob.encode_uint(7) == b"\x07"
    assert gob.encode_uint(256) == b"\xfe\x01\x00"
    assert gob.encode_int(0) == b"\x00"
    assert gob.encode_int(-1) == b"\x01"
    assert gob.encode_int(22) == b"\x2c"
    assert gob.encode_int(-65) == b"\xff\x81"
    # float: Float64bits byte-reversed; 17.0 -> fe 31 40 (docs example)
    assert gob.encode_float(17.0) == b"\xfe\x31\x40"
    r = gob._Reader(gob.encode_float(-2.5))
    assert r.float_() == -2.5


def test_gob_zero_field_omission_and_defaults():
    t = gob.struct_of("W", [("A", gob.INT_T), ("B", gob.BYTES_T),
                            ("C", gob.BOOL_T)])
    blob = gob.dumps(t, {"A": 0, "B": b"", "C": False})
    # all-zero struct: the value message is just typeid + terminator
    assert gob.loads(blob) == {"A": 0, "B": b"", "C": False}


def test_gob_nested_and_slices_roundtrip():
    big_t = gob.gob_encoder_type("Int")
    inner = gob.struct_of("Inner", [("K", gob.INT_T), ("F", gob.FLOAT_T)])
    outer = gob.struct_of("Outer", [
        ("Bs", gob.slice_of(gob.BYTES_T)), ("N", big_t),
        ("S", gob.STRING_T), ("I", inner)])
    v = {"Bs": [b"\x00\x01", b"", b"xyz"],
         "N": gob.big_int_gob_encode(-(1 << 200)),
         "S": "type a1\n", "I": {"K": -7, "F": 0.0001}}
    out = gob.loads(gob.dumps(outer, v))
    assert out == v
    assert gob.big_int_gob_decode(out["N"]) == -(1 << 200)


def test_gob_big_int_payload():
    for x in (0, 1, -1, 255, 1021, -(1 << 130), (1 << 512) - 3):
        assert gob.big_int_gob_decode(gob.big_int_gob_encode(x)) == x
    # version<<1 | sign layout
    assert gob.big_int_gob_encode(5) == b"\x02\x05"
    assert gob.big_int_gob_encode(-5) == b"\x03\x05"
    assert gob.big_int_gob_encode(0) == b"\x02"


# ---------------------------------------------------------------------------
# PBC codecs
# ---------------------------------------------------------------------------


def test_a1_params_string_layout():
    s = pbc.a1_params_to_str(p=103, n=13, l=8)
    assert s == "type a1\np 103\nn 13\nl 8\n"
    assert pbc.parse_a1_params_str(s) == (103, 13, 8)
    # the reference's own parser (bgn.go:583-593) must agree
    assert pbc.parse_l_from_params(s) == 8


def test_a1_params_string_validation():
    with pytest.raises(ValueError):
        pbc.parse_a1_params_str("type a\np 7\nn 3\nl 4\n")
    with pytest.raises(ValueError):
        pbc.parse_a1_params_str("type a1\np 7\nn 3\nl 4\n")  # 7 != 12-1


def test_element_bytes_layout():
    p = (1 << 64) + 13  # 65-bit p -> 9-byte coordinates
    assert pbc.element_length_in_bytes(p) == 9
    P = (2, 3)
    b = pbc.point_to_bytes(P, p)
    assert len(b) == 18 and b[8] == 2 and b[17] == 3
    assert pbc.point_from_bytes(b, p) == P
    # identity <-> all-zero (PBC curve_to_bytes quirk, documented)
    z = pbc.point_to_bytes(None, p)
    assert z == b"\x00" * 18
    assert pbc.point_from_bytes(z, p) is None
    zgt = pbc.gt_to_bytes((1, 0), p)
    assert pbc.gt_from_bytes(zgt, p) == (1, 0)
    with pytest.raises(ValueError):
        pbc.point_from_bytes(b"\x00" * 17, p)
    with pytest.raises(ValueError):
        pbc.fp_to_bytes(p, p)


# ---------------------------------------------------------------------------
# Wrapper round-trips on a real (small) key
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def keypair(shared_keypair64):
    return shared_keypair64


def test_public_key_gob_roundtrip(keypair):
    pk, _sk = keypair
    blob = public_key_to_gob(pk)
    pk2 = public_key_from_gob(blob)
    assert (pk2.n, pk2.l, pk2.p) == (pk.n, pk.l, pk.p)
    assert pk2.P_host == pk.P_host and pk2.Q_host == pk.Q_host
    assert pk2.msg_space == pk.msg_space
    assert pk2.deterministic == pk.deterministic
    assert pk2.poly_params.poly_base == pk.poly_params.poly_base
    # the params string inside survives the reference's own l-parser
    w = gob.loads(blob)
    assert pbc.parse_l_from_params(w["PairingParams"]) == pk.l
    # and a reimported key encrypts identically
    ms, rs = [1, 5, 9], [11, 22, 33]
    a = pk.encrypt_with_randomness(ms, rs)
    b = pk2.encrypt_with_randomness(ms, rs)
    from bgn_jax.interop.reference import _element_bytes
    assert _element_bytes(pk, a) == _element_bytes(pk2, b)


def test_ciphertext_gob_roundtrip(keypair, shared_tables64):
    pk, sk = keypair
    tables = shared_tables64
    ms = [0, 1, 7, 10]   # squares stay inside msg_space for the L2 check
    ct = pk.encrypt(ms, rng=random.Random(2))
    blobs = ciphertext_to_gob(pk, ct)
    assert len(blobs) == len(ms)
    back = ciphertext_from_gob(pk, blobs)
    assert not back.level2
    assert list(sk.decrypt(back, pk, tables)) == ms
    # L2 via a pairing
    prod = pk.mult(ct, ct)
    blobs2 = ciphertext_to_gob(pk, prod)
    back2 = ciphertext_from_gob(pk, blobs2)
    assert back2.level2
    assert list(sk.decrypt(back2, pk, tables)) == [m * m for m in ms]
    with pytest.raises(ValueError):
        ciphertext_from_gob(pk, b"")


def test_poly_ciphertext_gob_roundtrip(keypair, shared_tables64):
    pk, sk = keypair
    from bgn_jax import encoding, polyct
    tables = shared_tables64
    pt = polyct.encrypt_poly(pk, encoding.new_poly_plaintext(pk, 38.0),
                             rng=random.Random(4))
    blob = poly_ciphertext_to_gob(pk, pt)
    back = poly_ciphertext_from_gob(pk, blob)
    assert back.degree == pt.degree
    assert back.scale_factor == pt.scale_factor
    dec = polyct.decrypt_poly(sk, back, pk, tables)
    assert dec.poly_eval() == pytest.approx(38.0)


# ---------------------------------------------------------------------------
# Conformance channel
# ---------------------------------------------------------------------------


def test_conformance_synthetic_vectors():
    """The full dump_reference.go pipeline on golden-model vectors: import
    key -> verify pairing/encrypt/op/decrypt bytes, incl. the device
    encryption path at a small key size."""
    vec = conformance.synthesize_vectors(key_bits=64, msg_space=101)
    counts = verify_reference_vectors(vec, device=True)
    assert counts["encrypt"] == 7
    assert counts["ops"] == 7
    assert counts["device_encrypt"] == 7


def test_conformance_detects_corruption():
    vec = conformance.synthesize_vectors(key_bits=64, msg_space=101)
    bad = json.loads(json.dumps(vec))
    blob = bytearray(bytes.fromhex(bad["ciphertexts"][2]["bytes_hex"]))
    blob[-1] ^= 1
    bad["ciphertexts"][2]["bytes_hex"] = bytes(blob).hex()
    with pytest.raises(conformance.ConformanceError):
        verify_reference_vectors(bad)
    bad2 = json.loads(json.dumps(vec))
    bad2["gt_gen_bytes_hex"] = bad2["gt_gen_bytes_hex"][:-2] + "00"
    with pytest.raises(conformance.ConformanceError):
        verify_reference_vectors(bad2)


def test_conformance_gob_public_key_channel():
    """The synthetic vector's public_key_gob goes through the same gob
    decode path a real Go-produced blob would."""
    vec = conformance.synthesize_vectors(key_bits=64, msg_space=101)
    pk = public_key_from_gob(base64.b64decode(vec["public_key_gob"]))
    assert format(pk.n, "x") == vec["n"]
    assert pbc.point_to_bytes(pk.P_host, pk.p).hex() == vec["p_bytes_hex"]


def test_reference_fixtures_if_present():
    """Real sachaservan/bgn vectors (run tools/dump_reference.go next to a
    reference checkout and drop the JSON in tests/vectors/reference/)."""
    files = sorted(glob.glob(os.path.join(VEC_DIR, "*.json")))
    if not files:
        pytest.skip("no reference-produced vector files present "
                    "(see tools/dump_reference.go)")
    for f in files:
        with open(f) as fh:
            vec = json.load(fh)
        counts = verify_reference_vectors(vec)
        assert counts["encrypt"] > 0
