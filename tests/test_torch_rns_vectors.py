"""The BEHZ RNS tool of troy_tpu_torch against troy's own RNSTool, on the
CPU.

The twin of tests/test_rns_reference_vectors.py: tests/data/
ref_rnstool_ops.txt holds troy's fastbconvmTilde, smMrq, fastFloor,
fastbconvSk, decryptScaleAndRound and divideAndRoundqLastInplace on
deterministic inputs (generator kept beside it), and each step's plain
version (ops/rns.py, ops/keyswitch.py) must give troy's words: BEHZ bases
with m~ = 2^32 and the gamma-corrected t/Q scaling. The card runs
composites in place of the separate steps (kernel E's lift, and ACi: A's
inverse with C's conversion and E's rounding in its last pass), so their
plain versions are held to the same words here, and
tools/troy_vectors_torch.py's ``rns_composites``, which chip_smoke.py's
phase 36 replays on the card, runs the wrappers. No JAX.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from troy_tpu_torch import interop
from troy_tpu_torch.ops import keyswitch
from troy_tpu_torch.ops import ntt as dntt
from troy_tpu_torch.ops import rns as drns

torch.set_num_threads(1)

N = 64
# tools/ holds the cases this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import troy_vectors_torch as tv  # noqa: E402


@pytest.fixture(scope="module")
def env():
    vecs, sizes = tv.rnstool()
    cd = tv.bfv64("cpu").first_context_data
    return vecs, sizes, cd


def _in(vecs, name, rows):
    return interop.to_torch(vecs[name].reshape(rows, N), "cpu")


def test_base_sizes_match(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    tool = cd.rns_tool
    assert cd.limbs == k
    assert len(tool.base_Bsk.values) == k_bsk
    assert len(tool.base_Bsk_m_tilde.values) == k_bskm


def test_fastbconv_m_tilde(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    got = drns.fastbconv_m_tilde_plain(_in(vecs, "inq", k), cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  vecs["bconv_mtilde"].reshape(k_bskm, N))


def test_sm_mrq(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    got = drns.sm_mrq_plain(_in(vecs, "bconv_mtilde", k_bskm), cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  vecs["sm_mrq"].reshape(k_bsk, N))


def test_fast_floor(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    stacked = torch.cat([_in(vecs, "inq", k), _in(vecs, "sm_mrq", k_bsk)])
    got = drns.fast_floor_plain(stacked, cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  vecs["fast_floor"].reshape(k_bsk, N))


def test_fastbconv_sk(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    got = drns.fastbconv_sk_plain(_in(vecs, "fast_floor", k_bsk), cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  vecs["bconv_sk"].reshape(k, N))


def test_decrypt_scale_and_round(env):
    vecs, (k, k_bsk, k_bskm), cd = env
    got = drns.decrypt_scale_and_round_plain(_in(vecs, "inq", k), cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got), vecs["scale_round"])


def test_divide_and_round_q_last(env):
    """Kernel K's divide (ops/keyswitch.py divide_and_round_q_last), on
    the CPU through divide_round_last_plain."""
    vecs, (k, k_bsk, k_bskm), cd = env
    got = keyswitch.divide_and_round_q_last(_in(vecs, "inq", k)[None],
                                            cd.ntt)
    np.testing.assert_array_equal(interop.to_numpy(got)[0],
                                  vecs["div_round_qlast"].reshape(k - 1, N))


def test_behz_lift_is_troys_sm_mrq_of_fastbconv_m_tilde(env):
    """Kernel E's lift, one launch on the card, is fastbconv_m_tilde then
    sm_mrq: troy's sm_mrq words from inq. (E's tail scales by t before the
    floor, so troy's fast_floor and fastbconv_sk are held one by one
    above.)"""
    vecs, (k, k_bsk, k_bskm), cd = env
    got = drns.behz_lift_plain(_in(vecs, "inq", k), cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  vecs["sm_mrq"].reshape(k_bsk, N))


def test_fused_decrypt_of_the_ntt_of_inq(env):
    """ACi, the BFV decrypt's last step on A's route, takes NTT-form
    phases: on the NTT of inq it gives troy's decryptScaleAndRound of
    inq."""
    vecs, (k, k_bsk, k_bskm), cd = env
    phase = dntt.rns_ntt_forward(_in(vecs, "inq", k), cd.ntt)
    got = drns.ntt_inverse_decrypt_scale_and_round_plain(phase, cd.rns)
    np.testing.assert_array_equal(interop.to_numpy(got), vecs["scale_round"])


def test_wrappers_the_card_runs():
    """The wrappers of E's lift, ACi, the decrypt scaling and K on troy's
    inputs, as chip_smoke.py's phase 36 runs them on the card."""
    assert tv.verify(tv.rns_composites("cpu")) == 4
