"""Seeded random op sequences through troy_tpu_torch against plaintext
models, on the CPU.

The twin of tests/test_differential_fuzz.py: its seeds, parameter sets, op
lists and slot models (BFV and BGV at n = 64, CKKS at n = 64, BFV on kernel
J's route at n = 2048), the decryption decoded to the model after every
step, and beside it ``decrypt_many`` of the running ciphertext and a copy
held to ``decrypt``'s words. Then BFV with a coefficient model at
t = 2^41 over {60,60,60} and at a t that cannot batch, and the ops the
sequences leave out (public-key encrypt, multiply_many, exponentiate,
field_trace, rescale_to, mod_switch_plain_to). The sequences live in
tools/fuzz_torch.py, which chip_smoke.py's phase 36 runs on the card.
Seeded, so a failure replays. No JAX.
"""

import pathlib
import sys

import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch.utils import numth

torch.set_num_threads(1)

# tools/ holds the cases this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import fuzz_torch as fz  # noqa: E402

# a prime t that is not 1 mod 2n: BatchEncoder cannot batch it
NON_BATCHING_T = (1 << 20) - 3


@pytest.mark.parametrize("scheme", [P.SchemeType.bfv, P.SchemeType.bgv])
@pytest.mark.parametrize("fuzz_seed", [0, 1, 2])
def test_bfv_bgv_random_sequences(scheme, fuzz_seed):
    assert fz.bfv_bgv_sequence(scheme, fuzz_seed) >= 1


@pytest.mark.parametrize("fuzz_seed", [0, 1, 2])
def test_ckks_random_sequences(fuzz_seed):
    assert fz.ckks_sequence(fuzz_seed) >= 1


def test_bfv_mxu_path_random_sequence():
    """The same over kernel J's route (n = 2048, use_mxu=True)."""
    assert fz.mxu_sequence() >= 1


@pytest.mark.parametrize("t, q_bits", [(1 << 41, [60, 60, 60]),
                                       (NON_BATCHING_T, [40, 40, 40])],
                         ids=["t=2^41", "non-batching t"])
def test_bfv_polynomial_sequences(t, q_bits):
    """An even t (the app layer's 2^41) and a t that cannot
    batch: coefficient plaintexts, negacyclic products mod t."""
    if t == NON_BATCHING_T:
        assert numth.is_prime(t) and t % 128 != 1
    assert fz.polynomial_sequence(t, q_bits, 0) >= 5


@pytest.mark.parametrize("scheme", [P.SchemeType.bfv, P.SchemeType.bgv,
                                    P.SchemeType.ckks])
def test_ops_the_sequences_leave_out(scheme):
    assert fz.other_ops(scheme) == (5 if scheme == P.SchemeType.ckks else 4)
