"""BFV n = 4096 with two primes (BASELINE.json config 1) against troy's
compiled CPU path, on the CPU.

The twin of tests/test_config1_reference_vectors.py: host keygen, two
host-sampled encryptions, their sum and its decryption, each word for word
against tests/data/ref_bfv_n4096_config1.txt (generator kept beside it),
through tools/troy_vectors_torch.py, which chip_smoke.py's phase 36
replays on the card. No JAX.
"""

import pathlib
import sys

import torch

torch.set_num_threads(1)

# tools/ holds the cases this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import troy_vectors_torch as tv  # noqa: E402


def test_config1_keygen_encrypt_add_decrypt():
    """The primes and t, the seeded secret key, c1 and c2 (a fresh
    Encryptor each: troy's seeded factory replays per encryption), their
    sum (one data limb: the last prime is for key switching), its
    decryption and its decode."""
    tv.verify(tv.config1_flow("cpu"))
