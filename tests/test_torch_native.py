"""The port's native host runtime against its pure-Python versions and
against troy_tpu.native, word for word.

troy_tpu_torch/native keeps its own copy of troy_tpu's C++ source; each
entry point must give the bytes and words of the Python code it replaces
(the BLAKE2Xb stream, the CRT composition, the NTT root tables, J's factor
matrices, the signed digit planes) and of the JAX package's library, and
host keygen from a fixed seed must give the same key words with the
library and without it.
"""

import numpy as np
import pytest
import torch

from troy_tpu import native as jnative
from troy_tpu.ops import ntt_mxu as jmxu

import troy_tpu_torch as P
from troy_tpu_torch import native, prng
from troy_tpu_torch.modulus import Modulus
from troy_tpu_torch.ops import ntt_mxu
from troy_tpu_torch.utils import numth
from troy_tpu_torch.utils.rns import RnsBase

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), f"the native runtime did not build: " \
        f"{native.build_error}"
    assert jnative.available()


def test_xof_stream_matches_python():
    seed = prng.seed_from_uint64(1, 2, 3)
    gen = prng.UniformRandomGenerator(seed)
    py = b"".join(gen._refill_block(c) for c in range(3))
    nat = native.xof_fill(seed, 0, 3 * 4096)
    assert nat == py
    assert nat == jnative.xof_fill(seed, 0, 3 * 4096)
    # from a later block on, and a part of a block
    assert native.xof_fill(seed, 1, 5000) == py[4096:9096]


def test_generator_bulk_path_matches_blockwise():
    seed = prng.seed_from_uint64(9)
    g1 = prng.UniformRandomGenerator(seed)
    g2 = prng.UniformRandomGenerator(seed)
    a = g1.generate(5)
    b = g1.generate(9000)        # crosses blocks
    c = g1.generate(4096 * 2)    # whole blocks
    ref = b"".join(g2._refill_block(i) for i in range(5))
    whole = a + b + c
    assert whole == ref[:len(whole)]


def test_crt_compose_matches_object_math():
    n = 64
    qs = [numth.get_prime(2 * n, b) for b in (40, 41, 42, 43)]
    base = RnsBase(tuple(Modulus(q) for q in qs))
    rng = np.random.default_rng(3)
    residues = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qs])
    Q = base.base_prod
    k = len(qs)
    w = (Q.bit_length() + 63) // 64
    words = lambda v: [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(w)]
    invp = [base.inv_punctured(i) for i in range(k)]
    args = (residues, qs, invp, [(x << 64) // q for x, q in zip(invp, qs)],
            np.array([words(base.punctured_prod(i)) for i in range(k)],
                     dtype=np.uint64),
            np.array(words(Q), dtype=np.uint64), 1.0)
    got = native.crt_compose_centered_double(*args)
    acc = np.zeros(n, dtype=object)
    for i in range(k):
        acc += residues[i].astype(object) * invp[i] % qs[i] \
            * base.punctured_prod(i)
    acc %= Q
    acc = np.where(acc > Q // 2, acc - Q, acc)
    np.testing.assert_allclose(got, acc.astype(np.float64), rtol=1e-12)
    np.testing.assert_array_equal(got,
                                  jnative.crt_compose_centered_double(*args))


def test_ntt_tables_fill_matches_python_loop():
    for n, bits in ((256, 60), (64, 30)):
        q = numth.get_prime(2 * n, bits)
        root = numth.minimal_primitive_root(2 * n, q)
        inv_root = numth.invert_mod(root, q)
        log_n = numth.get_power_of_two(n)
        powers = [0] * n
        inv_powers = [0] * n
        acc = inv_acc = 1
        for k in range(n):
            b = numth.reverse_bits(k, log_n)
            powers[b] = acc
            inv_powers[b] = inv_acc
            acc = (acc * root) % q
            inv_acc = (inv_acc * inv_root) % q
        shoup = lambda w: (w << 64) // q
        got = native.ntt_tables_fill(n, q, root, inv_root)
        to64 = lambda vals: np.array(
            [v & 0xFFFFFFFFFFFFFFFF for v in vals], dtype=np.uint64)
        for arr, want in zip(got, (powers, [shoup(p) for p in powers],
                                   inv_powers,
                                   [shoup(p) for p in inv_powers])):
            np.testing.assert_array_equal(arr, to64(want))
        for arr, ref in zip(got, jnative.ntt_tables_fill(n, q, root,
                                                         inv_root)):
            np.testing.assert_array_equal(arr, ref)


def test_mxu_tables_fill_matches_python_oracle():
    # an odd log2(n), where A = 2B, tells the row and column roles apart
    for n, bits in ((256, 60), (1024, 40), (512, 50)):
        q = numth.get_prime(2 * n, bits)
        A, B, w1, tw, w2, v1, itw, v2 = ntt_mxu.make_mxu_tables_host(n, q)
        psi = numth.minimal_primitive_root(2 * n, q)
        nat = native.mxu_tables_fill(n, A, B, q, psi)
        shoup = np.vectorize(lambda w: ((int(w) << 64) // q)
                             & 0xFFFFFFFFFFFFFFFF, otypes=[object])
        to64 = lambda m: np.array(
            [[int(x) & 0xFFFFFFFFFFFFFFFF for x in row] for row in m],
            dtype=np.uint64)
        names = ["w1", "tw", "w2", "v1", "itw", "v2"]
        for name, py, got in zip(names, (w1, tw, w2, v1, itw, v2), nat[:6]):
            np.testing.assert_array_equal(got, to64(py), err_msg=name)
        np.testing.assert_array_equal(nat[6], to64(shoup(tw)))
        np.testing.assert_array_equal(nat[7], to64(shoup(itw)))
        for got, ref in zip(nat, jnative.mxu_tables_fill(n, A, B, q, psi)):
            np.testing.assert_array_equal(got, ref)


def test_signed_digits_fill_matches_python():
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 1 << 61, (17, 23), dtype=np.uint64)
    py = ntt_mxu._signed_digits_host(mat)
    nat = native.signed_digits_fill(mat)
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, jnative.signed_digits_fill(mat))
    np.testing.assert_array_equal(py, jmxu._signed_digits_host(mat))
    rec = sum(nat[d].astype(object) * (1 << (8 * d)) for d in range(8))
    np.testing.assert_array_equal(rec.astype(np.uint64), mat)


def test_signed_digits_fill_rejects_overflow():
    # 2^63 - 1 needs a 9th digit: the Python version asserts, the native
    # one raises
    bad = np.array([[np.uint64(2**63 - 1)]], dtype=np.uint64)
    with pytest.raises(ValueError):
        native.signed_digits_fill(bad)
    with pytest.raises(AssertionError):
        ntt_mxu._signed_digits_host(bad)


def _keys(n: int):
    """Host keygen from a fixed seed: the secret, public and relin key and
    one Galois key, as numpy words."""
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(77),
                        host_sampling=True)
    pk = kg.create_public_key()
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    return [P.to_numpy(x) for x in (kg.secret_key.data, pk.data,
                                    rlk.keys[2], *gk.keys.values())]


@pytest.mark.parametrize("n", [256, 2048])
def test_keygen_same_words_with_and_without_the_library(n, monkeypatch):
    with_lib = _keys(n)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.xof_fill(b"\0" * 64, 0, 8) is None
    without = _keys(n)
    assert len(with_lib) == len(without) == 4
    for a, b in zip(with_lib, without):
        np.testing.assert_array_equal(a, b)
