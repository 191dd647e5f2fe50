"""bgn_jax: a BGN (Boneh-Goh-Nissim) somewhat-homomorphic encryption
framework built on JAX/XLA.

Capabilities mirror sachaservan/bgn (see SURVEY.md): composite-order
bilinear-pairing BGN with one homomorphic multiplication, BSGS decryption,
polynomial/fixed-point plaintext encodings, ZK gadgets, serialization -- all
re-designed for the accelerator: ciphertexts live in batched limb arrays,
every scheme op is a batched XLA kernel, and scaling is expressed with
jax.sharding meshes.

Quick start:
    import bgn_jax
    pk, sk = bgn_jax.keygen(512, 1021)
    tables = pk.setup_decryption(sk)
    ct = pk.encrypt([3, 4, 5])
    prod = pk.mult(ct, ct)              # one homomorphic multiplication
    sk.decrypt(prod, pk, tables)        # -> [9, 16, 25]
"""

from .scheme import (BGNPublicKey, BGNSecretKey, Ciphertext,  # noqa: F401
                     PolyEncodingParams, keygen)
from .config import BGNParams  # noqa: F401
from .encoding import (PolyPlaintext, new_poly_plaintext,  # noqa: F401
                       new_unbalanced_plaintext)
from .polyct import (PolyCiphertext, encrypt_poly, decrypt_poly,  # noqa
                     add_poly, sub_poly, neg_poly, mult_poly,
                     mult_const_poly, eval_poly, make_poly_l2)
from . import gadgets, serialize, hostmath  # noqa: F401

__version__ = "0.1.0"
