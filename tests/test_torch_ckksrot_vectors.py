"""CKKS NTT-form rotation and conjugation, and BFV at an even t = 2^41,
against troy's compiled CPU path, on the CPU.

The twin of tests/test_ckksrot_event_vectors.py, word for word against
tests/data/ref_ckksrot_event.txt (generator kept beside it), through
tools/troy_vectors_torch.py, which chip_smoke.py's phase 36 replays on the
card. No JAX.
"""

import pathlib
import sys

import torch

torch.set_num_threads(1)

# tools/ holds the cases this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import troy_vectors_torch as tv  # noqa: E402


def test_ckks_rotation_and_conjugation_bit_exact():
    """rotate_vector(1) and complex_conjugate at q = {50,30,50} with troy's
    Galois keys."""
    tv.verify(tv.ckks_rotation("cpu"))


def test_even_t_multiply_bit_exact():
    """BEHZ multiply with t = 2^41 (even, a power of two: the app layer's
    t) bit-exact against troy, and the exact t/Q scale-and-round of its
    decryption."""
    tv.verify(tv.even_t_multiply("cpu"))
