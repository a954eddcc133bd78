"""Large rings: contexts on kernel J, the grouped key-switch decompose and
the limb caps, against troy_tpu.

* ``HeContext(use_mxu=True)`` at n = 2048 and 4096 runs every NTT on J
  (its plain version here); BFV, CKKS and BGV keygen, encryption,
  multiply, relinearize, a rotation and the mod switch (CKKS: rescale)
  must give troy_tpu's words, whose default route at those n is its MXU
  transform (as tests/test_bfv_mxu_path.py drives it).
* The key switch's decompose on J groups the digit rows by the width of
  their data prime (x_bound_bits) and gives the ungrouped words.
* A context at SEAL's bfv_default(32768) builds, on A by default (J
  above ops/ntt.py's MAX_KERNEL_N), with every base inside the kernels'
  limb caps; kernels C and E's plain
  versions at 16 and 17 limbs give troy_tpu's fast_convert and BEHZ
  words.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu.ops import ntt as jntt
from troy_tpu.ops import poly as jpoly
from troy_tpu.ops import rns as jrns
from troy_tpu.utils.rns import make_rns_tool as j_make_rns_tool

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import embedding, keyswitch, ntt, rns
from troy_tpu_torch.utils.rns import make_rns_tool as t_make_rns_tool

torch.set_num_threads(1)

SEED = 3131
SCALE = 2.0 ** 40
BITS = {2048: [60, 40, 40, 60], 4096: [60, 40, 40, 40, 60]}


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _ctx(mod, scheme, n):
    extra = {"device": "cpu", "use_mxu": True} if mod is P else {}
    t = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(n, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, BITS[n])), **t)
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **extra)


def _chain(mod, scheme, n, plains):
    """Keys, two encryptions, multiply, relinearize, rotate by one and
    the mod switch (CKKS: rescale), as numpy words; and the last result
    decrypted."""
    prng = tprng if mod is P else jprng
    ctx = _ctx(mod, scheme, n)
    if mod is P:
        assert ctx.key_context_data.ntt.mxu is not None
    else:
        assert ctx.key_context_data.ntt.mxu is not None, "troy_tpu's route"
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(SEED + 1),
                        host_sampling=True)
    ev = mod.Evaluator(ctx)
    if mod is P:
        plains = [interop.plaintext(_np(p.data), "cpu", p.level,
                                    p.is_ntt_form, p.scale) for p in plains]
    a, b = (enc.encrypt_symmetric(p) for p in plains)
    out = {"rlk": rlk.keys[2], "gk": next(iter(gk.keys.values())),
           "a": a.data, "b": b.data}
    prod = ev.multiply(a, b)
    rel = ev.relinearize(prod, rlk)
    rot = ev.rotate_vector(rel, 1, gk) if scheme == "ckks" \
        else ev.rotate_rows(rel, 1, gk)
    last = ev.rescale_to_next(rot) if scheme == "ckks" \
        else ev.mod_switch_to_next(rot)
    out.update(prod=prod.data, rel=rel.data, rot=rot.data, last=last.data)
    return {k: _np(v) for k, v in out.items()}, \
        mod.Decryptor(ctx, kg.secret_key).decrypt(last), ctx


@pytest.fixture(scope="module",
                params=[(s, n) for s in ("bfv", "ckks", "bgv")
                        for n in (2048, 4096)],
                ids=lambda p: f"{p[0]}-n{p[1]}")
def runs(request):
    scheme, n = request.param
    jctx = _ctx(J, scheme, n)
    rng = np.random.default_rng(SEED)
    if scheme == "ckks":
        enc = J.CKKSEncoder(jctx, host=True)
        vals = [rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
                for _ in range(2)]
        plains = [enc.encode(v, SCALE) for v in vals]
    else:
        t = int(jctx.first_context_data.plain_modulus)
        vals = [rng.integers(0, t, n, dtype=np.uint64) for _ in range(2)]
        plains = [J.BatchEncoder(jctx).encode(v) for v in vals]
    want, _, _ = _chain(J, scheme, n, plains)
    got, dec, pctx = _chain(P, scheme, n, plains)
    return scheme, n, vals, want, got, dec, pctx


@pytest.mark.parametrize("stage", ["rlk", "gk", "a", "b", "prod", "rel",
                                   "rot", "last"])
def test_words_are_troy_tpus(runs, stage):
    _, _, _, want, got, _, _ = runs
    np.testing.assert_array_equal(got[stage], want[stage])


def test_result_decrypts(runs):
    scheme, n, vals, _, _, dec, ctx = runs
    if scheme == "ckks":
        out = P.CKKSEncoder(ctx).decode(dec)
        want = np.roll(vals[0] * vals[1], -1)
        assert np.abs(out - want).max() < 1e-4
    else:
        t = int(ctx.first_context_data.plain_modulus)
        prod = (vals[0].astype(object) * vals[1] % t).astype(np.uint64)
        rows = prod.reshape(2, n // 2)
        np.testing.assert_array_equal(P.BatchEncoder(ctx).decode(dec),
                                      np.roll(rows, -1, axis=1).reshape(-1))


@pytest.mark.parametrize("ntt_form", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_grouped_decompose_keeps_the_words(ntt_form, lead):
    """Rows of 60- and 40-bit data primes go through J in two groups,
    each with its width as the bound; the words are the ungrouped
    transform's and the A route's."""
    n = 2048
    ctx_j = _ctx(P, "bfv", n)
    parms = ctx_j.key_context_data.parms
    ctx_a = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu",
                        use_mxu=False)
    rng = np.random.default_rng(7)
    for level in (1, 2):
        cd_j, cd_a = ctx_j.chain[level], ctx_a.chain[level]
        target = interop.to_torch(np.concatenate(
            [rng.integers(0, q, lead + (1, n), dtype=np.uint64)
             for q in cd_j.coeff_values], axis=-2), "cpu")
        got = pev._switch_key_decompose(target, cd_j, ctx_j.key_context_data,
                                        ntt_form)
        used = pev._used_tables(cd_j, ctx_j.key_context_data)
        coeff = ntt.rns_ntt_inverse(target, cd_j.ntt) if ntt_form else target
        plain = ntt.rns_ntt_forward(keyswitch.keyswitch_digits(coeff, used),
                                    used)
        assert torch.equal(got, plain)
        assert torch.equal(got, pev._switch_key_decompose(
            target, cd_a, ctx_a.key_context_data, ntt_form))


def test_seal_n32768_context_builds_within_the_caps():
    """bfv_default(32768): 16 primes, 881 bits. Every level's NTTs run on
    A (n <= MAX_KERNEL_N), and every base fits kernels C, E, F and O3."""
    n = 32768
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.bfv_default(n)),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, device="cpu")
    key = ctx.key_context_data
    assert key.limbs == 16 and key.total_coeff_modulus.bit_length() == 881
    assert n <= ntt.MAX_KERNEL_N and ctx.plain_ntt.rns.mxu is None
    for cd in ctx.chain:
        assert cd.ntt.mxu is None and cd.bsk_ntt.mxu is None
        tool = cd.rns
        assert max(tool.k, tool.nb + 1) <= rns.MAX_KERNEL_LIMBS
        assert len(keyswitch.used_limbs(cd.limbs, key.limbs)) <= \
            keyswitch.MAX_KERNEL_LIMBS
    assert key.rns.nb + 1 == 18
    rt = embedding.make_rns_round_tables(key.ntt)
    assert rt.words <= embedding.MAX_KERNEL_WORDS
    assert key.limbs <= embedding.MAX_KERNEL_LIMBS


@pytest.fixture(scope="module", params=[16, 17], ids=lambda k: f"k{k}")
def wide(request):
    """A BEHZ tool of k primes at n = 64: |Bsk| = k + 1, k + 2 with m~."""
    n, k = 64, request.param
    q = tuple(int(m) for m in J.CoeffModulus.create(n, [60] + [40] * (k - 1)))
    t = int(J.PlainModulus.batching(n, 17))
    jtool, ttool = j_make_rns_tool(n, q, t), t_make_rns_tool(n, q, t)
    tq = ntt.RnsNttTables.from_moduli(n, q, "cpu")
    tb = ntt.RnsNttTables.from_moduli(n, ttool.base_Bsk.values, "cpu")
    dev = rns.DeviceRnsTool.build(ttool, tq, tb)
    assert dev.nb == k + 1 and dev.nb + 1 <= rns.MAX_KERNEL_LIMBS
    return n, q, t, jtool, dev


def _rows_eq(port, jax_fn, xs):
    got = _np(port)
    for b in range(xs.shape[0]):
        np.testing.assert_array_equal(got[b],
                                      np.asarray(jax_fn(jnp.asarray(xs[b]))))


def test_fast_convert_at_the_caps(wide):
    n, q, t, jtool, dev = wide
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 64, size=(2, len(q), n), dtype=np.uint64)
    tx = interop.to_torch(x, "cpu")
    _rows_eq(rns.fast_convert(tx, dev.q_to_bsk),
             lambda r: jrns.fast_convert(r, jtool.conv_q_to_Bsk), x)
    _rows_eq(rns.fast_convert(tx, dev.q_to_bsk_m_tilde),
             lambda r: jnp.concatenate(
                 [jrns.fast_convert(r, jtool.conv_q_to_Bsk),
                  jrns.fast_convert(r, jtool.conv_q_to_m_tilde)]), x)
    xb = rng.integers(0, 1 << 64, size=(2, jtool.base_B.size, n),
                      dtype=np.uint64)
    _rows_eq(rns.fast_convert(interop.to_torch(xb, "cpu"), dev.b_to_q_m_sk),
             lambda r: jnp.concatenate(
                 [jrns.fast_convert(r, jtool.conv_B_to_q),
                  jrns.fast_convert(r, jtool.conv_B_to_m_sk)]), xb)


def test_behz_at_the_caps(wide):
    n, q, t, jtool, dev = wide
    rng = np.random.default_rng(2)
    res = lambda moduli: np.concatenate(
        [rng.integers(0, m, size=(2, 1, n), dtype=np.uint64)
         for m in moduli], axis=-2)
    x = res(q)
    _rows_eq(rns.behz_lift(interop.to_torch(x, "cpu"), dev),
             lambda r: jrns.sm_mrq(jrns.fastbconv_m_tilde(r, jtool), jtool),
             x)
    bsk = jtool.base_Bsk.values
    y = res(q + bsk)
    jq_bsk = jntt.RnsNttTables.from_moduli(n, q + bsk, use_mxu=False)
    _rows_eq(rns.behz_tail(interop.to_torch(y, "cpu"), dev),
             lambda r: jrns.fastbconv_sk(jrns.fast_floor(
                 jpoly.rns_broadcast_scalar_mul(r, t, jq_bsk), jtool), jtool),
             y)
    _rows_eq(rns.decrypt_scale_and_round(interop.to_torch(x, "cpu"), dev),
             lambda r: jrns.decrypt_scale_and_round(r, jtool), x)
