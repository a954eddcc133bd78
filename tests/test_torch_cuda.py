"""The CUDA kernels of troy_tpu_torch against their plain versions, on a card.

Marked ``cuda``: the kernels have no CPU mode, so without a CUDA device
every test here skips. On a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel must give the same words as its plain PyTorch version on the
same inputs (tolerance 0: the values are integers), at small and at the
headline sizes, and the whole BFV slice on the card must give the CPU run's
words. The kernels' build happens at the first launch.
"""

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import _kernels, interop, prng
from troy_tpu_torch.ops import ntt, poly, rns
from troy_tpu_torch.utils.rns import make_rns_tool

pytestmark = pytest.mark.cuda

BITS = {1: [50], 6: [60, 40, 40, 40, 40, 60]}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _uniform(rng, bounds, lead, n, device):
    cols = [rng.integers(0, b, size=lead + (1, n), dtype=np.uint64)
            for b in bounds]
    return interop.to_torch(np.concatenate(cols, axis=-2), device)


def _same(got, want):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  interop.to_numpy(want))


@pytest.mark.parametrize("n", [64, 1024, 16384])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("lazy", [False, True])
def test_ntt_kernel(dev, n, k, lazy):
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[k])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n + k)
    x = _uniform(rng, [4 * q for q in moduli], (3,), n, dev)
    _same(ntt.rns_ntt_forward(x, tables, lazy),
          ntt.ntt_forward_plain(x, tables, lazy))
    y = _uniform(rng, [2 * q for q in moduli], (3,), n, dev)
    _same(ntt.rns_ntt_inverse(y, tables, lazy),
          ntt.ntt_inverse_plain(y, tables, lazy))


@pytest.mark.parametrize("terms", [1, 2, 5])
def test_dyadic_mac_kernel(dev, terms):
    n = 1024
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(terms)
    bound = [4 * q for q in moduli] if terms <= 4 else moduli
    a = _uniform(rng, bound, (terms,), n, dev)
    b = _uniform(rng, bound, (terms, 2), n, dev)
    _same(ntt.dyadic_mac(a, b, tables),
          ntt.dyadic_mac_plain(a.unsqueeze(1), b, tables))


@pytest.fixture(scope="module")
def tool(dev):
    n = 1024
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [60, 40, 40, 40, 40]))
    t = int(P.PlainModulus.batching(n, 20))
    host = make_rns_tool(n, q, t)
    tq = ntt.RnsNttTables.from_moduli(n, q, dev)
    tb = ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, dev)
    return n, rns.DeviceRnsTool.build(host, tq, tb)


@pytest.mark.parametrize("conv", ["q_to_bsk", "q_to_bsk_m_tilde",
                                  "b_to_q_m_sk", "q_to_t_gamma"])
def test_base_convert_kernel(dev, tool, conv):
    n, dt = tool
    c = getattr(dt, conv)
    rng = np.random.default_rng(len(conv))
    x = interop.to_torch(rng.integers(0, 1 << 64, size=(3, c.k_in, n),
                                      dtype=np.uint64), dev)
    _same(rns.fast_convert(x, c), rns.fast_convert_plain(x, c))


def test_rns_elementwise_kernel(dev, tool):
    n, dt = tool
    t = dt.q
    rng = np.random.default_rng(3)
    a, b = (_uniform(rng, t.values, (2,), n, dev) for _ in range(2))
    _same(poly.rns_add(a, b, t), poly.rns_elementwise_plain(poly.ADD, a, b, t))
    _same(poly.rns_sub(a, b, t), poly.rns_elementwise_plain(poly.SUB, a, b, t))
    _same(poly.rns_neg(a, t), poly.rns_elementwise_plain(poly.NEG, a, None, t))
    x = interop.to_torch(rng.integers(0, 1 << 64, size=(2, t.k, n),
                                      dtype=np.uint64), dev)
    w, wq = t.scalar_operand([786433] * t.k)
    _same(poly.rns_scalar_mul(x, [786433] * t.k, t),
          poly.rns_elementwise_plain(poly.SCALAR_MUL, x, None, t, w, wq))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    n = 64
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    on_card = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    on_host = ntt.RnsNttTables.from_moduli(n, moduli, "cpu")
    x = torch.zeros((6, n), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        ntt.rns_ntt_forward(x, on_host)
    with pytest.raises(TypeError, match="int64"):
        ntt.rns_ntt_forward(x.to(torch.int32), on_card)
    with pytest.raises(ValueError, match="expected"):
        ntt.rns_ntt_forward(x[:, :32], on_card)


def _slice(device):
    """keygen -> encrypt x2 -> multiply -> relinearize -> decrypt at
    n = 1024, as numpy words per stage."""
    n = 1024
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [30, 30, 30])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(5), host_sampling=True)
    rlk = kg.create_relin_keys()
    be = P.BatchEncoder(ctx)
    rng = np.random.default_rng(5)
    cts = []
    for i in range(2):
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(6 + i),
                          host_sampling=True)
        cts.append(enc.encrypt_symmetric(be.encode(
            rng.integers(0, be.plain_modulus, n, dtype=np.uint64))))
    ev = P.Evaluator(ctx)
    prod = ev.multiply(*cts)
    rel = ev.relinearize(prod, rlk)
    plain = P.Decryptor(ctx, kg.secret_key).decrypt(rel)
    return {"c1": interop.words(cts[0]), "c2": interop.words(cts[1]),
            "add": interop.words(ev.add(*cts)),
            "prod": interop.words(prod), "rel": interop.words(rel),
            "decode": be.decode(plain)}


def test_slice_on_the_card_gives_the_cpu_words(dev):
    _kernels.reset_launch_counts()
    on_card = _slice(dev)
    counts = _kernels.launch_counts()
    assert all(c > 0 for c in counts.values()), counts
    on_host = _slice("cpu")
    for stage, want in on_host.items():
        np.testing.assert_array_equal(on_card[stage], want, err_msg=stage)
