"""The key switch's digits folded into kernel A's forward transform
(troy_tpu_torch/ops/ntt.py ``rns_ntt_forward_digits``, kernel AF) against
troy_tpu, word for word (tolerance 0), on the CPU.

BFV contexts (the decompose does not depend on the scheme) at n = 64,
1024 and 4096 with q = {60,40,40,60} (60- and 40-bit data primes under a
60-bit special prime) and q = {40,40,40,40}; random words below each
limb's modulus from numpy seeds:
  * the port's ``_switch_key_decompose`` (on A's route: one
    ``rns_ntt_forward_digits`` call) against troy_tpu/evaluator.py:179
    ``_switch_key_decompose``, coefficient-form and NTT-form targets (the
    JAX package's diagonal shortcut gives the same words), at the first
    data level and one below it;
  * ``rns_ntt_forward_digits`` alone against F's digits then A's forward
    (``keyswitch_digits`` + ``rns_ntt_forward``) and its plain version, on
    any u64 words, with and without leading axes;
  * a limb shard (``limbs=``) against the matching rows of troy_tpu's
    whole decompose;
  * the wrapper's refusals (tables on J, a pointwise view, a wrong
    length).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import evaluator as jev

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch.ops import keyswitch, ntt

torch.set_num_threads(2)

SEED = 4141
BITS = {"60/40": [60, 40, 40, 60], "40": [40, 40, 40, 40]}

_CTX = {}


def _ctxs(n, bits):
    """(port context, troy_tpu context) of BFV at n over BITS[bits]."""
    key = (n, bits)
    if key not in _CTX:
        out = []
        for mod in (P, J):
            parms = mod.EncryptionParameters(
                scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, BITS[bits])),
                plain_modulus=mod.PlainModulus.batching(n, 20))
            on_cpu = {"device": "cpu"} if mod is P else {}
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on_cpu))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _words(rng, moduli, lead, n):
    return np.concatenate([rng.integers(0, q, size=lead + (1, n),
                                        dtype=np.uint64) for q in moduli],
                          axis=-2)


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


@pytest.mark.parametrize("ntt_form", [False, True])
@pytest.mark.parametrize("bits", list(BITS))
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_decompose_matches_troy_tpu(n, bits, ntt_form):
    pctx, jctx = _ctxs(n, bits)
    rng = np.random.default_rng(SEED + n + len(bits) + ntt_form)
    for level in (pctx.first_level, pctx.first_level + 1):
        pcd, jcd = pctx.chain[level], jctx.chain[level]
        target = _words(rng, pcd.coeff_values, (), n)
        got = pev._switch_key_decompose(interop.to_torch(target, "cpu"), pcd,
                                        pctx.key_context_data, ntt_form)
        assert got.shape == (pcd.limbs, pcd.limbs + 1, n)
        _equal(got, jev._switch_key_decompose(
            jnp.asarray(target), jcd, jctx.key_context_data, ntt_form))


@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("bits", list(BITS))
@pytest.mark.parametrize("n", [64, 1024])
def test_fused_forward_is_digits_then_forward(n, bits, lead):
    """Any u64 words: the fused call gives F's digits transformed by A,
    word for word."""
    pctx, _ = _ctxs(n, bits)
    cd, key_cd = pctx.first_context_data, pctx.key_context_data
    used = pev._used_tables(cd, key_cd)
    rng = np.random.default_rng(SEED + n + len(lead))
    x = interop.to_torch(rng.integers(0, 2 ** 64, lead + (cd.limbs, n),
                                      dtype=np.uint64), "cpu")
    got = ntt.rns_ntt_forward_digits(x, used)
    assert got.shape == lead + (cd.limbs, used.k, n)
    want = ntt.rns_ntt_forward(keyswitch.keyswitch_digits(x, used), used)
    assert torch.equal(got, want)
    assert torch.equal(got, ntt.ntt_forward_digits_plain(x, used))


@pytest.mark.parametrize("ntt_form", [False, True])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_limb_shard_matches_troy_tpu_rows(shard, ntt_form):
    """A shard of the limb axis makes only its limbs' digits: the rows of
    troy_tpu's whole decompose."""
    n = 1024
    pctx, jctx = _ctxs(n, "60/40")
    pcd, jcd = pctx.first_context_data, jctx.first_context_data
    rng = np.random.default_rng(SEED + shard[0] + 7 * ntt_form)
    target = _words(rng, pcd.coeff_values, (), n)
    limbs = range(*shard)
    got = pev._switch_key_decompose(
        interop.to_torch(target[limbs.start:limbs.stop], "cpu"), pcd,
        pctx.key_context_data, ntt_form, limbs=limbs)
    want = np.asarray(jev._switch_key_decompose(
        jnp.asarray(target), jcd, jctx.key_context_data, ntt_form))
    _equal(got, want[limbs.start:limbs.stop])


def test_fused_forward_refuses_what_a_cannot_take():
    n = 2048
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40, 40])]
    on_j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    on_a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu")
    x = torch.zeros((2, n), dtype=torch.int64)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_forward_digits(x, on_j)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_forward_digits(x, on_a.pointwise(n))
    with pytest.raises(ValueError, match="expected"):
        ntt.rns_ntt_forward_digits(x[:, :64], on_a)
    with pytest.raises(TypeError):
        ntt.rns_ntt_forward_digits(x.to(torch.int32), on_a)
