"""Galois keys and rotations of troy_tpu_torch against troy_tpu, word for word.

The Galois tables (utils/galois.py, copied into the port) at n = 64 and
1024; kernel M's plain version on edge words; and, at n = 1024
(SecurityLevel.none) and at the n = 4096 default chain, seeded host-sampling
Galois keys for steps {1, -1, 4} and the row swap, then rotate_rows by 1,
-1 and 3 (3 has no key: the NAF splits it into -1 + 4) and rotate_columns
of a relinearized product. Both packages run on the CPU, the JAX package as
its own tests run it; the port's wrappers run the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import evaluator as jev
from troy_tpu import prng as jprng
from troy_tpu.utils import galois as jgalois

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import galois as tgalois
from troy_tpu_torch.ops import ntt as tntt
from troy_tpu_torch.utils import galois as tgalois_util

torch.set_num_threads(1)

SEED = 2024
STEPS = [1, -1, 4, 0]                  # step 0: the row swap, elt 2n - 1
ROTATIONS = {"rot1": 1, "rot-1": -1, "rot3": 3}


@pytest.mark.parametrize("n", [64, 1024])
def test_galois_tables(n):
    assert tgalois_util.get_elts_all(n) == jgalois.get_elts_all(n)
    steps = [1, -1, 2, -2, n // 2 - 1, -(n // 2 - 1), 0]
    elts = tgalois_util.get_elts_from_steps(n, steps)
    assert elts == jgalois.get_elts_from_steps(n, steps)
    for elt in sorted(set(elts + jgalois.get_elts_all(n))):
        for port, ref in zip(tgalois_util.coeff_permutation(n, elt),
                             jgalois.coeff_permutation(n, elt)):
            np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(tgalois_util.ntt_permutation(n, elt),
                                      jgalois.ntt_permutation(n, elt))
    with pytest.raises(ValueError):
        tgalois_util.get_elt_from_step(n, n // 2)
    with pytest.raises(ValueError):
        tgalois_util.coeff_permutation(n, 4)


@pytest.mark.parametrize("n", [64, 256, 1024, 4096])
def test_packed_tables_hold_the_index_tables(n):
    """Kernel M's packed int32 tables (ops/galois.pack_table: the source
    index in bits 0-30, bit 31 where the word is negated) unpack to the
    JAX package's coefficient and NTT-domain tables, word for word, for
    every element of the default Galois set and conjugation; the inverse
    NTT-domain table undoes the gather."""
    cpu = torch.device("cpu")
    elts = jgalois.get_elts_all(n)
    assert 2 * n - 1 in elts
    for elt in elts:
        src, keep = jgalois.coeff_permutation(n, elt)
        table = tgalois.coeff_table(n, elt, cpu)
        assert table.dtype == torch.int32 and table.shape == (n,)
        words = table.numpy()
        np.testing.assert_array_equal(words & 0x7FFFFFFF, src)
        np.testing.assert_array_equal(words < 0, ~keep)
        got_src, got_keep = tgalois.unpack_table(table)
        np.testing.assert_array_equal(got_src.numpy(), src)
        np.testing.assert_array_equal(got_keep.numpy(), keep)
        perm = jgalois.ntt_permutation(n, elt)
        words = tgalois.ntt_table(n, elt, cpu).numpy()
        np.testing.assert_array_equal(words, perm)
        inverse = tgalois.ntt_inverse_table(n, elt, cpu).numpy()
        np.testing.assert_array_equal(perm[inverse], np.arange(n))
    both = tgalois.batched_tables(n, tuple(elts[:3]), cpu, True)
    np.testing.assert_array_equal(
        both.numpy(), np.stack([tgalois.coeff_table(n, e, cpu).numpy()
                                for e in elts[:3]]))


def test_index_tables_packed_once():
    """apply_permutation(_signed) pack an index table once and keep it
    while neither it nor its sign table changes; the wrappers refuse a
    table that is not dense (the kernel reads it as dense words)."""
    n, cpu = 64, torch.device("cpu")
    src, keep = tgalois.coeff_permutation(n, 3, cpu)
    first = tgalois.packed(src, keep)
    assert tgalois.packed(src, keep) is first
    assert torch.equal(first, tgalois.coeff_table(n, 3, cpu))
    assert tgalois.packed(src, keep.clone()) is not first
    perm = tgalois.ntt_permutation(n, 3, cpu).clone()
    table = tgalois.packed(perm)
    assert tgalois.packed(perm) is table
    perm[0], perm[1] = perm[1].item(), perm[0].item()
    moved = tgalois.packed(perm)
    assert moved is not table and moved[0] == table[1]
    x = torch.arange(2 * n, dtype=torch.int64).reshape(2, 1, n)
    with pytest.raises(ValueError, match="contiguous"):
        tgalois.permute(x, torch.cat([table, table])[::2])
    tables = tgalois.batched_tables(n, (3, 5), cpu, False)
    with pytest.raises(ValueError, match="contiguous"):
        tgalois.permute_batched(x, tables[:1].expand(2, n), tntt.RnsNttTables
                                .from_moduli(n, [257], cpu))


def _parms(mod, name):
    if name == "n1024":
        n, q = 1024, mod.CoeffModulus.create(1024, [30, 30, 30])
    else:
        n, q = 4096, mod.CoeffModulus.bfv_default(4096)
    return mod.EncryptionParameters(
        scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(q), plain_modulus=mod.PlainModulus.batching(n, 20))


def _context(mod, name):
    sec = mod.SecurityLevel.none if name == "n1024" \
        else mod.SecurityLevel.tc128
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(_parms(mod, name), sec_level=sec, **on_cpu)


def _run(mod, prng, name, vals):
    """keygen (relin and Galois keys) -> encrypt x2 -> multiply ->
    relinearize -> the rotations, as numpy words and decoded slots."""
    ctx = _context(mod, name)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=STEPS)
    be = mod.BatchEncoder(ctx)
    cts = [mod.Encryptor(ctx, secret_key=kg.secret_key,
                         seed=prng.seed_from_uint64(SEED + i),
                         host_sampling=True).encrypt_symmetric(be.encode(v))
           for i, v in enumerate(vals)]
    ev = mod.Evaluator(ctx)
    dec = mod.Decryptor(ctx, kg.secret_key)
    rel = ev.relinearize(ev.multiply(*cts), rlk)
    w = (lambda x: np.asarray(x)) if mod is J else P.to_numpy
    results = {tag: ev.rotate_rows(rel, s, gk)
               for tag, s in ROTATIONS.items()}
    results["col"] = ev.rotate_columns(rel, gk)
    out = {"gk": {e: w(k) for e, k in gk.keys.items()}, "rel": w(rel.data)}
    out.update({tag: w(ct.data) for tag, ct in results.items()})
    out["slots"] = {tag: be.decode(dec.decrypt(ct))
                    for tag, ct in results.items()}
    return out, (ctx, ev, rel, gk)


@pytest.fixture(scope="module", params=["n1024", "n4096"])
def runs(request):
    name = request.param
    n = 1024 if name == "n1024" else 4096
    rng = np.random.default_rng(11)
    t = int(J.PlainModulus.batching(n, 20))
    vals = [rng.integers(0, t, n, dtype=np.uint64) for _ in range(2)]
    jax_out, _ = _run(J, jprng, name, vals)
    port_out, port = _run(P, tprng, name, vals)
    want = (vals[0].astype(object) * vals[1].astype(object) % t)
    return n, want.astype(np.uint64), jax_out, port_out, port


def test_galois_key_words(runs):
    _, _, jax_out, port_out, _ = runs
    assert sorted(port_out["gk"]) == sorted(jax_out["gk"])
    for elt, words in jax_out["gk"].items():
        np.testing.assert_array_equal(port_out["gk"][elt], words,
                                      err_msg=f"elt {elt}")


@pytest.mark.parametrize("stage", ["rel", *ROTATIONS, "col"])
def test_rotation_words(runs, stage):
    _, _, jax_out, port_out, _ = runs
    np.testing.assert_array_equal(port_out[stage], jax_out[stage])


def test_rotations_decrypt_to_rotated_slots(runs):
    """Each n/2 row of the slot matrix rotates left by the step; the row
    swap exchanges the rows."""
    n, want, _, port_out, _ = runs
    rows = want.reshape(2, n // 2)
    slots = port_out["slots"]
    for tag, step in ROTATIONS.items():
        np.testing.assert_array_equal(
            slots[tag], np.roll(rows, -step, axis=1).reshape(-1), err_msg=tag)
    np.testing.assert_array_equal(slots["col"], rows[::-1].reshape(-1))


def test_missing_key_raises(runs):
    """Step 2 has no key and its NAF is itself: a ValueError, not an
    endless recursion."""
    _, _, _, _, (ctx, ev, rel, gk) = runs
    with pytest.raises(ValueError, match="not present"):
        ev.rotate_rows(rel, 2, gk)
    with pytest.raises(ValueError, match="not present"):
        ev.apply_galois(rel, 5, gk)


def test_jax_keys_through_interop(runs):
    """The JAX package's Galois keys and ciphertext, fed into the port."""
    _, _, jax_out, _, (ctx, ev, _, _) = runs
    gk = interop.galois_keys(jax_out["gk"], "cpu")
    rel = interop.ciphertext(jax_out["rel"], ctx.first_level, False, "cpu")
    np.testing.assert_array_equal(
        interop.words(ev.rotate_rows(rel, 1, gk)), jax_out["rot1"])
    np.testing.assert_array_equal(interop.words(gk)[3], jax_out["gk"][3])


@pytest.mark.parametrize("elt", [3, 2 * 1024 - 1, 2 * 1024 - 3])
def test_permutation_plain_edge_words(elt):
    """Kernel M's plain version against the JAX package's gathers on words
    0, 1, q - 1 and random residues: 0 stays 0 under the sign flip."""
    n = 1024
    jctx = J.HeContext(_parms(J, "n1024"), sec_level=J.SecurityLevel.none)
    cd = jctx.first_context_data
    q = [int(v) for v in cd.coeff_values]
    rng = np.random.default_rng(elt)
    x = np.stack([rng.integers(0, qi, size=(2, n), dtype=np.uint64)
                  for qi in q], axis=1)                       # (2, k, n)
    for i, qi in enumerate(q):
        x[:, i, 0:n:3] = 0
        x[:, i, 1:n:7] = qi - 1
        x[:, i, 2:n:11] = 1
    pctx = _context(P, "n1024")
    src, keep = tgalois.coeff_permutation(n, elt, torch.device("cpu"))
    got = tgalois.apply_permutation_signed(
        interop.to_torch(x, "cpu"), src, keep, pctx.first_context_data.ntt)
    jsrc, jkeep = jgalois.coeff_permutation_dev(n, elt)
    want = jev._apply_permutation_signed(jnp.asarray(x), jsrc, jkeep, cd)
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))
    perm = tgalois.ntt_permutation(n, elt, torch.device("cpu"))
    got = tgalois.apply_permutation(interop.to_torch(x, "cpu"), perm)
    want = jev._apply_permutation(jnp.asarray(x),
                                  jgalois.ntt_permutation_dev(n, elt))
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))
