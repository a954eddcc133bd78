"""The CUDA kernels of troy_tpu_torch against their plain versions, on a card.

Marked ``cuda``: the kernels have no CPU mode, so without a CUDA device
every test here skips. On a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel must give the same words as its plain PyTorch version on the
same inputs (tolerance 0: the values are integers; the FP64 transform O1
within 2^-44 max|x|, two orders of summation), at small and at the
headline sizes, and the whole BFV, CKKS and BGV slices on the card must
give the CPU run's words. The kernels' build happens at the first launch.
"""

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import _kernels, interop, prng, rlwe
from troy_tpu_torch.ops import (embedding, galois, keyswitch, ntt, ntt_mxu,
                                poly, rns, sampling, shard, tiles)
from troy_tpu_torch.utils import galois as galois_util
from troy_tpu_torch.utils.rns import make_rns_tool

pytestmark = pytest.mark.cuda

BITS = {1: [50], 6: [60, 40, 40, 40, 40, 60]}
# on A's route the key switch's digits run in A's first pass (AF) and
# BFV's divide in A's last inverse pass (AFi), so F's own kernel does not
# run; K''s temps and finish run in A's forward passes (AKp), K''s own
# kernels (Kp) only on J's route; the decrypt's conversions run in A's
# last inverse pass (ACi: C and E's rounding; AXi: X); the plain lift in
# A's first forward pass (AGp: G'), and the CKKS encodes' rounding there
# too (AO2p: O2)
BFV_KERNELS = {"A_ntt", "AF_ntt_digits", "AFi_keyswitch_intt", "B_dyadic_mac",
               "ACi_decrypt_intt", "D_rns_elementwise", "E_behz",
               "K_divide_round", "G_plain_embed", "M_galois"}
CKKS_KERNELS = {"A_ntt", "AF_ntt_digits", "B_dyadic_mac", "D_rns_elementwise",
                "M_galois", "O1_ckks_fft", "AO2p_ntt_round", "O3_ckks_compose",
                "AKp_rescale_ntt", "AKp_keyswitch_ntt"}
BGV_KERNELS = {"A_ntt", "AF_ntt_digits", "B_dyadic_mac", "D_rns_elementwise",
               "M_galois", "AKp_bgv_ntt",
               "AXi_decrypt_intt", "AGp_ntt_lift"}
# K''s own kernels: on A's route no window launches them
KP_KERNELS = ("Kp_rescale_ntt", "Kp_keyswitch_ntt", "Kp_bgv_ntt")


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
                                  "b_to_q_m_sk", "q_to_t_gamma",
                                  "q_to_t_gamma_scaled"])
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


def _words(rng, shape, dev):
    return interop.to_torch(rng.integers(0, 1 << 64, size=shape,
                                         dtype=np.uint64), dev)


def test_behz_kernels(dev, tool):
    """Kernel E's lift, tail and decrypt rounding at the BFV multiply's
    and decryption's shapes."""
    n, dt = tool
    rng = np.random.default_rng(4)
    x = _uniform(rng, dt.q.values, (4,), n, dev)
    _same(rns.behz_lift(x, dt), rns.behz_lift_plain(x, dt))
    y = _uniform(rng, dt.q_bsk.values, (3,), n, dev)
    _same(rns.behz_tail(y, dt), rns.behz_tail_plain(y, dt))
    z = _words(rng, (3, dt.k + dt.nb, n), dev)         # any u64 words
    _same(rns.behz_tail(z, dt), rns.behz_tail_plain(z, dt))
    p = _uniform(rng, dt.q.values, (5,), n, dev)
    _same(rns.decrypt_scale_and_round(p, dt),
          rns.decrypt_scale_and_round_plain(p, dt))
    tg = _uniform(rng, [dt.host.t, dt.host.gamma], (5,), n, dev)
    _same(rns.behz_decrypt_round(tg, dt), rns.behz_decrypt_round_plain(tg, dt))


def test_keyswitch_kernels(dev, tool):
    """Kernel F's digits and divide-round, with every accumulator width,
    and kernel K's mod switch."""
    n, dt = tool
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    key = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    used = key.select(keyswitch.used_limbs(5, 6))
    rng = np.random.default_rng(5)
    target = _uniform(rng, moduli[:5], (), n, dev)
    _same(keyswitch.keyswitch_digits(target, used),
          keyswitch.keyswitch_digits_plain(target, used))
    x = _uniform(rng, used.values, (2,), n, dev)
    consts = keyswitch.divide_round_consts(key.slice(0, 5), moduli[-1])
    for comps in (0, 1, 2):
        acc = _uniform(rng, moduli[:5], (comps,), n, dev) if comps else None
        _same(keyswitch.divide_round_last(x, consts, acc),
              keyswitch.divide_round_last_plain(x, consts, acc))
    level = key.slice(0, 5)
    y = _uniform(rng, level.values, (2,), n, dev)
    consts = keyswitch.divide_round_consts(key.slice(0, 4), moduli[4])
    _kernels.reset_launch_counts()
    got = keyswitch.divide_and_round_q_last(y, level)
    assert _kernels.launch_counts()["K_divide_round"] == 1
    _same(got, keyswitch.divide_round_last_plain(y, consts))


@pytest.mark.parametrize("t", [786433, 6 * 65537, 1 << 41])
@pytest.mark.parametrize("subtract", [False, True])
def test_plain_embed_kernel(dev, tool, t, subtract):
    """Kernel G with a prime t, a composite even t and a power of two."""
    n, dt = tool
    Q = 1
    for v in dt.q.values:
        Q *= v
    coeff_div = tuple((Q // t) % v for v in dt.q.values)
    rng = np.random.default_rng(t % 1000)
    m = interop.to_torch(rng.integers(0, t, size=(2, n), dtype=np.uint64),
                         dev)
    c0 = _uniform(rng, dt.q.values, (2,), n, dev)
    args = (t, Q % t, coeff_div, dt.q, subtract)
    _same(poly.bfv_plain_embed(m, c0, *args),
          poly.bfv_multiply_add_plain(m, c0, *args))


@pytest.mark.parametrize("elt", [3, 2047, 5 ** 3 % 2048])
def test_galois_kernel(dev, tool, elt):
    """Kernel M, signed (with words 0 and q - 1) and unsigned."""
    n, dt = tool
    rng = np.random.default_rng(elt)
    x = _uniform(rng, dt.q.values, (2,), n, dev)
    x[:, :, ::5] = 0
    src, keep = galois.coeff_permutation(n, elt, dev)
    _same(galois.apply_permutation_signed(x, src, keep, dt.q),
          galois.apply_permutation_signed_plain(x, src, keep, dt.q))
    perm = galois.ntt_permutation(n, elt, dev)
    _same(galois.apply_permutation(x, perm),
          galois.apply_permutation_plain(x, perm))


NTT_ROWS = {"1 mod t": (1, 1), "3 mod t": (1, 3), "(5, 6)": (6, 5),
            "q u Bsk (4, 11)": (11, 4)}


@pytest.mark.parametrize("n", [1 << e for e in range(6, 15)])
@pytest.mark.parametrize("rows", sorted(NTT_ROWS))
def test_ntt_kernel_every_shape(dev, n, rows):
    """Kernel A against its plain version, word for word, forward and
    inverse, lazy and not, at every n it runs by default and at the row
    counts of the paths (one and three rows mod t, the headline's (5, 6, n)
    and q u Bsk's (4, 11, n)): one pass over whole rows below n = 1024, the
    two passes (strided, contiguous) from it up."""
    k, lead = NTT_ROWS[rows]
    if k == 1:
        moduli = [int(P.PlainModulus.batching(n, 20))]
    else:
        moduli = [int(m) for m in P.CoeffModulus.create(n, [60] * k)]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n * 7 + k)
    x = _uniform(rng, [4 * q for q in moduli], (lead,), n, dev)
    y = _uniform(rng, [2 * q for q in moduli], (lead,), n, dev)
    for lazy in (False, True):
        _same(ntt.rns_ntt_forward(x, tables, lazy),
              ntt.ntt_forward_plain(x, tables, lazy))
        _same(ntt.rns_ntt_inverse(y, tables, lazy),
              ntt.ntt_inverse_plain(y, tables, lazy))
    assert len(ntt.launch_blocks(lead * k, n)) == (1 if n < 1024 else 2)


@pytest.mark.parametrize("n", [64, 4096, 16384])
def test_galois_packed_tables(dev, n):
    """Kernel M on its packed tables at every element of the default Galois
    set and conjugation: signed and unsigned, one table and batched, and
    component-major, word for word against the plain versions on the
    index tables; the batch encoder's slot gather."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60, 40, 40, 40, 40])]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n)
    x = _uniform(rng, moduli, (2,), n, dev)
    x[..., ::7] = 0
    elts = tuple(galois_util.get_elts_all(n))
    for elt in elts:
        src, keep = galois.coeff_permutation(n, elt, dev)
        _same(galois.permute(x, galois.coeff_table(n, elt, dev), t),
              galois.apply_permutation_signed_plain(x, src, keep, t))
        perm = galois.ntt_permutation(n, elt, dev)
        _same(galois.permute(x, galois.ntt_table(n, elt, dev)),
              galois.apply_permutation_plain(x, perm))
    batch = _uniform(rng, moduli, (len(elts), 2), n, dev)
    for signed in (True, False):
        tables = galois.batched_tables(n, elts, dev, signed)
        srcs, keeps = galois.unpack_table(tables)
        _same(galois.permute_batched(batch, tables, t),
              galois.permute_batched_plain(batch, srcs, keeps, t))
        one = tables[:1]
        srcs, keeps = galois.unpack_table(one.expand(len(elts), n))
        _same(galois.permute_batched(batch, one, t, comps_first=True),
              galois.permute_batched_plain(batch, srcs, keeps, t, True))
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    be = P.BatchEncoder(P.HeContext(parms, sec_level=P.SecurityLevel.none,
                                    device=dev))
    slots = interop.to_torch(rng.integers(0, be.plain_modulus, n,
                                          dtype=np.uint64), dev)
    _same(galois.permute(slots, be._index_map),
          slots.index_select(-1, be._index_map.long()))


def test_galois_refuses_a_strided_table(dev):
    """Kernel M reads a table as dense words: a table of the right shape
    and dtype that is not contiguous (one row expanded over the batch, a
    strided slice) is refused, not read past its rows."""
    n, m = 64, 4
    moduli = [int(q) for q in P.CoeffModulus.create(n, BITS[6])]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    x = torch.zeros((m, 2, 6, n), dtype=torch.int64, device=dev)
    tables = galois.batched_tables(n, (3, 5, 7, 9), dev, False)
    with pytest.raises(ValueError, match="contiguous"):
        galois.permute_batched(x, tables[:1].expand(m, n), t)
    with pytest.raises(ValueError, match="contiguous"):
        galois.permute(x[0], torch.cat([tables[0], tables[0]])[::2])


def test_launches_go_to_the_current_stream(dev):
    """A and M launch on the caller's current stream: queued behind a long
    sleep and a fill on a side stream, they read the filled words, and the
    default stream stays idle meanwhile."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    x = torch.zeros((2, 6, n), dtype=torch.int64, device=dev)
    table = galois.ntt_table(n, 3, dev)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        x.fill_(12345)
        permuted = galois.permute(x, table)
        forward = ntt.rns_ntt_forward(x, t)
        assert not side.query()
        assert torch.cuda.default_stream(dev).query()
    side.synchronize()
    want = torch.full_like(x, 12345)
    _same(permuted, want)
    _same(forward, ntt.ntt_forward_plain(want, t))


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
    """keygen -> encrypt x2 -> multiply -> relinearize -> rotate_rows,
    rotate_columns, mod_switch_to_next -> decrypt at n = 1024, as numpy
    words per stage."""
    n = 1024
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [30, 30, 30])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(5), host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, 0])
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
    dec = P.Decryptor(ctx, kg.secret_key)
    rot = ev.rotate_rows(rel, 1, gk)
    ms = ev.mod_switch_to_next(rel)
    return {"c1": interop.words(cts[0]), "c2": interop.words(cts[1]),
            "add": interop.words(ev.add(*cts)),
            "prod": interop.words(prod), "rel": interop.words(rel),
            "rot": interop.words(rot),
            "col": interop.words(ev.rotate_columns(rel, gk)),
            "ms": interop.words(ms),
            "decode": be.decode(dec.decrypt(rel)),
            "decode_ms": be.decode(dec.decrypt(ms)),
            "budget": np.array([dec.invariant_noise_budget(rel)])}


def test_slice_on_the_card_gives_the_cpu_words(dev):
    _kernels.reset_launch_counts()
    on_card = _slice(dev)
    counts = _kernels.launch_counts()
    assert BFV_KERNELS <= set(counts)
    assert all(counts[k] > 0 for k in BFV_KERNELS), counts
    on_host = _slice("cpu")
    for stage, want in on_host.items():
        np.testing.assert_array_equal(on_card[stage], want, err_msg=stage)


@pytest.mark.parametrize("n", [2, 8, 64, 1024, 2048, 16384, 32768, 262144])
def test_embedding_kernels(dev, n):
    """O1 (both directions, every slot count; every geometry of its FFT
    passes: lines of 1-512 words, one and two columns a block, A = B and
    A = 2B), O2 (magnitudes up to 2^200, ties) and O3 (every level's
    width) against their plain versions."""
    rng = np.random.default_rng(n)
    t = embedding.make_embed_tables(n, dev)
    close = lambda got, want: float((got - want).abs().max()) <= \
        2.0 ** -44 * float(want.abs().max())
    for count in (n // 2, min(3, n // 2)):
        vals = torch.from_numpy(rng.uniform(-1, 1, count)
                                + 1j * rng.uniform(-1, 1, count)).to(dev)
        got = embedding.embed_inverse_fft(vals, t)
        torch.cuda.synchronize()
        assert close(got, embedding.embed_inverse_fft_plain(vals, t))
    coeffs = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 30).to(dev)
    assert close(embedding.embed_forward(coeffs, t),
                 embedding.embed_forward_plain(coeffs, t))
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60, 50, 50, 50, 50,
                                                        60])]
    level = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rt = embedding.make_rns_round_tables(level)
    for log_mag in (20, 62, 100, 200):
        u = torch.from_numpy((rng.uniform(-1, 1, n)
                              + 1j * rng.uniform(-1, 1, n))
                             * 2.0 ** log_mag).to(dev)
        u[:4] = torch.tensor([0.5, -2.5, 3.5, 0.0],
                             dtype=torch.complex128)[:min(4, n)]
        for scale in (1.0, 2.0 ** 7):
            _same(embedding.untwist_round_to_rns(u, scale, t, rt),
                  embedding.untwist_round_to_rns_plain(u, t.untwist, scale,
                                                       rt))
    for k in (2, 5, 6):
        sub = level.slice(0, k)
        srt = embedding.make_rns_round_tables(sub)
        res = _uniform(rng, sub.values, (), n, dev)
        got = embedding.compose_centered(res, srt, 2.0 ** -40)
        want = embedding.compose_centered_plain(res, srt, 2.0 ** -40)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_embedding_refuses_rings_past_its_lines(dev):
    """O1 and O5 take lines of up to 512 words (n <= 2^18): at n = 2^19
    (A = 1024) each entry point refuses the launch (cudaErrorInvalidValue)
    and the wrapper raises."""
    n = 2 ** 19
    t = embedding.make_embed_tables(n, dev)
    assert embedding.launch_geometry(t) == ()
    vals = torch.zeros(n // 2, dtype=torch.complex128, device=dev)
    coeffs = torch.zeros(n, dtype=torch.float64, device=dev)
    for call in (lambda: embedding.embed_inverse_fft(vals, t),
                 lambda: embedding.embed_forward(coeffs, t),
                 lambda: embedding.embed_forward_stats(coeffs, t)):
        with pytest.raises(RuntimeError, match="failed with error 1$"):
            call()


def test_kprime_kernels(dev):
    """K' for the rescale (p the level's last prime) and for the key switch
    (p the special prime, every accumulator width), each on its own launch
    count, against the plain versions: on A's tables A's inverse and the
    fused forward (AKp), on J's K''s own temps and finish."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    key = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    key_j = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
    data, data_j = key.slice(0, 5), key_j.slice(0, 5)
    rng = np.random.default_rng(11)
    x = _uniform(rng, data.values, (2,), n, dev)
    consts = keyswitch.divide_round_consts(data.slice(0, 4), moduli[4])
    _kernels.reset_launch_counts()
    got = rns.divide_and_round_q_last_ntt(x, data, consts)
    counts = _kernels.launch_counts()
    assert (counts["A_ntt"], counts["AKp_rescale_ntt"],
            counts["Kp_rescale_ntt"]) == (1, 1, 0)
    _same(got, rns.divide_and_round_q_last_ntt_plain(x, data, consts))
    _kernels.reset_launch_counts()
    got_j = rns.divide_and_round_q_last_ntt(x, data_j, consts)
    counts = _kernels.launch_counts()
    assert (counts["Kp_rescale_ntt"], counts["AKp_rescale_ntt"]) == (2, 0)
    _same(got_j, got)
    used = key.select(keyswitch.used_limbs(5, 6))
    y = _uniform(rng, used.values, (2,), n, dev)
    ks = keyswitch.divide_round_consts(data, moduli[-1])
    last = _uniform(rng, [moduli[-1]], (2,), n, dev)[:, 0]
    _same(rns._ntt_temps(rns.KEYSWITCH[0], last, ks),
          rns.divide_round_ntt_temps_plain(last, ks))
    temps = _uniform(rng, [4 * q for q in data.values], (2,), n, dev)
    for comps in (0, 1, 2):
        acc = _uniform(rng, data.values, (comps,), n, dev) if comps else None
        _same(rns._ntt_finish(rns.KEYSWITCH[1], y, temps, ks, acc),
              rns.divide_round_ntt_finish_plain(y, temps, ks, acc))
    _kernels.reset_launch_counts()
    got = rns.divide_round_last_ntt(y, data, used.slice(5, 6), ks)
    counts = _kernels.launch_counts()
    assert (counts["A_ntt"], counts["AKp_keyswitch_ntt"]) == (1, 1)
    assert not any(counts[k] for k in KP_KERNELS), counts
    used_j = key_j.select(keyswitch.used_limbs(5, 6))
    _kernels.reset_launch_counts()
    got_j = rns.divide_round_last_ntt(y, data_j, used_j.slice(5, 6), ks)
    counts = _kernels.launch_counts()
    assert (counts["Kp_keyswitch_ntt"], counts["Kp_rescale_ntt"],
            counts["AKp_keyswitch_ntt"]) == (2, 0, 0)
    _same(got_j, got)


def _ckks_slice(device):
    """keygen -> encode -> encrypt x2 -> multiply -> relinearize -> rescale,
    rotate_vector, complex_conjugate -> decrypt -> decode at n = 1024, as
    numpy words (and decoded slots) per stage. The chain starts from the
    host oracle's plaintext words, the same on both devices; the device
    encode of the same slots is returned beside them."""
    n = 1024
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(5), host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, 0])
    rng = np.random.default_rng(5)
    vals = [rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
            for _ in range(2)]
    host = P.CKKSEncoder(ctx, host=True)
    cts = [P.Encryptor(ctx, secret_key=kg.secret_key,
                       seed=prng.seed_from_uint64(6 + i), host_sampling=True)
           .encrypt_symmetric(host.encode(v, 2.0 ** 40))
           for i, v in enumerate(vals)]
    ev = P.Evaluator(ctx)
    rel = ev.relinearize(ev.multiply(*cts), rlk)
    rs = ev.rescale_to_next(rel)
    dec = P.Decryptor(ctx, kg.secret_key)
    ce = P.CKKSEncoder(ctx)
    return {"c1": interop.words(cts[0]), "rel": interop.words(rel),
            "rs": interop.words(rs),
            "rot": interop.words(ev.rotate_vector(rs, 1, gk)),
            "conj": interop.words(ev.complex_conjugate(rs, gk)),
            "decode": ce.decode(dec.decrypt(rs)),
            "encode": interop.words(ce.encode(vals[0], 2.0 ** 40)),
            "moduli": ctx.first_context_data.coeff_values}


@pytest.mark.parametrize("n", [64, 1024, 2048, 16384, 32768, 131072])
def test_ckks_statistics_kernels(dev, n):
    """O4: O2's words and the statistic bit-equal to the plain version's,
    at scales 2^40 and 2^55 and at magnitudes up to 2^100; O5: the slots
    bit-equal to O1's (embed_forward), slots and partners within 2^-44
    max|v| of the plain version's, the statistic bit-equal to the residual
    of its own slots and partners (a maximum is exact), nonzero and within
    2^-44 max|v| of the plain version's, on four inputs (so that a
    reduction over part of the slots shows), and in (0, 1e-8] for slots
    below 1."""
    rng = np.random.default_rng(n + 1)
    t = embedding.make_embed_tables(n, dev)
    bits = [60] + [40] * 14 + [60] if n == 32768 else [60, 40, 40, 40, 40,
                                                       60]
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    rt = embedding.make_rns_round_tables(
        ntt.RnsNttTables.from_moduli(n, moduli[:-1], dev))
    vals = torch.from_numpy(rng.uniform(-1, 1, n // 2)
                            + 1j * rng.uniform(-1, 1, n // 2)).to(dev)
    u = embedding.embed_inverse_fft(vals, t)
    for scale in (2.0 ** 40, 2.0 ** 55, 2.0 ** 100 if n == 64 else 1.0):
        words, stat = embedding.untwist_round_to_rns_stats(u, scale, t, rt)
        _same(words, embedding.untwist_round_to_rns(u, scale, t, rt))
        _same(words, embedding.untwist_round_to_rns_plain(u, t.untwist,
                                                          scale, rt))
        assert stat.dim() == 0 and stat.device.type == "cuda"
        assert float(stat) == float(embedding.round_stats_plain(
            u, t.untwist, scale))
    for coeffs in [torch.from_numpy(rng.uniform(-1, 1, n)).to(dev)
                   for _ in range(3)] + [
            torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 30).to(dev)]:
        slots, partners, err = embedding.embed_forward_stats(coeffs, t)
        torch.cuda.synchronize()
        assert torch.equal(slots, embedding.embed_forward(coeffs, t))
        assert torch.equal(err, embedding.conj_residual(slots, partners))
        pslots, ppartners, perr = embedding.embed_forward_stats_plain(
            coeffs, t)
        bound = 2.0 ** -44 * float(pslots.abs().max())
        assert float((slots - pslots).abs().max()) <= bound
        assert float((partners - ppartners).abs().max()) <= bound
        assert float(err) > 0 and float(perr) > 0
        assert abs(float(err) - float(perr)) <= bound
    # a decode's residual, in slot units: the real coefficients of the
    # slots' encoding
    slots, _, err = embedding.embed_forward_stats((u * t.untwist).real, t)
    assert float((slots - vals).abs().max()) <= 1e-12
    assert 0.0 < float(err) <= 1e-8


def test_ckks_device_surface_on_the_card(dev):
    """encode_with_stats, the borderline encode, encode_device,
    decode_device_with_stats and decode_max_error on the card: AO4p (O4's
    statistic in A's forward passes) and O5 launched; on each device encode_with_stats and encode_device give
    encode's words; across devices the statistic's bit count and the
    decoded values agree (O1's two summation orders can move a tie, so the
    words are not compared across devices)."""
    out = {}
    for where in (dev, "cpu"):
        n = 1024
        parms = P.EncryptionParameters(
            scheme=P.SchemeType.ckks, poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])))
        ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                          device=where)
        ce = P.CKKSEncoder(ctx)
        rng = np.random.default_rng(9)
        vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
        _kernels.reset_launch_counts()
        plain, stats = ce.encode_with_stats(vals, 2.0 ** 40)
        dplain = ce.encode_device(torch.from_numpy(vals.real).to(ctx.device),
                                  torch.from_numpy(vals.imag).to(ctx.device),
                                  2.0 ** 40, 1.5)
        Q = ctx.first_context_data.total_coeff_modulus
        one = np.zeros(n // 2, dtype=np.complex128)
        one[0] = 4.0 * Q / 2.0 ** 45
        border = ce.encode(one, 2.0 ** 45)
        re, im, err = ce.decode_device_with_stats(plain)
        counts = _kernels.launch_counts()
        if where is dev:
            # on A's route the statistic comes from AO4p, O4 off it
            assert (counts["AO4p_ntt_round_stats"],
                    counts["O4_ckks_encode_stats"]) == (2, 0), counts
            assert counts["O5_ckks_decode_stats"] == 1, counts
        assert ce.decode_max_error(plain) == float(err) <= 1e-8
        words = interop.words(ce.encode(vals, 2.0 ** 40))
        np.testing.assert_array_equal(interop.words(plain), words)
        np.testing.assert_array_equal(interop.words(dplain), words)
        np.testing.assert_allclose(ce.decode(border)[0].real, one[0].real,
                                   rtol=1e-10)
        out[str(where)] = (stats.max_coeff_bit_count,
                           (re.cpu() + 1j * im.cpu()).numpy())
    card, host = out[str(dev)], out["cpu"]
    assert card[0] == host[0]
    np.testing.assert_allclose(card[1], host[1], rtol=0, atol=1e-9)


def test_ckks_slice_on_the_card_gives_the_cpu_words(dev):
    """Word for word after encode; the encode itself within the tie bound
    of the records test (|diff| <= 1 at <= 4 coefficients), the decode to
    1e-9."""
    _kernels.reset_launch_counts()
    on_card = _ckks_slice(dev)
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in CKKS_KERNELS), counts
    assert not any(counts[k] for k in KP_KERNELS), counts
    assert counts["O2_ckks_round"] == 0, counts
    on_host = _ckks_slice("cpu")
    for stage in ("c1", "rel", "rs", "rot", "conj"):
        np.testing.assert_array_equal(on_card[stage], on_host[stage],
                                      err_msg=stage)
    np.testing.assert_allclose(on_card["decode"], on_host["decode"],
                               rtol=0, atol=1e-9)
    tables = ntt.RnsNttTables.from_moduli(1024, on_host["moduli"], "cpu")
    a, b = (interop.to_numpy(ntt.rns_ntt_inverse(
        interop.to_torch(x, "cpu"), tables)).astype(object)
        for x in (on_card["encode"], on_host["encode"]))
    q = np.array(on_host["moduli"], dtype=object).reshape(-1, 1)
    d = (a - b) % q
    d = np.where(d > q // 2, d - q, d)
    assert int(np.max(np.abs(d))) <= 1
    assert int(np.sum(d != 0, axis=1).max()) <= 4


@pytest.mark.parametrize("n", [1024, 16384])
@pytest.mark.parametrize("t_bits", [20, 59])
def test_exact_convert_kernel(dev, n, t_bits):
    """Kernel X (q -> t, Q.64 alpha) with the inverse correction factor 1
    and another, t below and above the 40-bit primes."""
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [60, 40, 40, 40, 40]))
    t = int(P.PlainModulus.batching(n, t_bits))
    conv = rns.ExactConverter.build(make_rns_tool(n, q, t).conv_q_to_t, dev)
    rng = np.random.default_rng(n + t_bits)
    x = _uniform(rng, q, (2,), n, dev)
    for inv_cf in (1, 12345 % t, t - 1):
        _same(rns.exact_convert(x, conv, inv_cf),
              rns.exact_convert_plain(x, conv, inv_cf))
    _same(rns.decrypt_mod_t(x[0], conv, 7), rns.exact_convert_plain(
        x[0], conv, 7)[0])


@pytest.mark.parametrize("t_bits", [20, 59])
def test_bgv_divide_kernels(dev, t_bits):
    """K'-BGV: the mod switch's temps and own finish (with A between, and
    alone), the key switch's temps with K''s finish at every accumulator
    width, each entry on its launch count."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    t = int(P.PlainModulus.batching(n, t_bits))
    key = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    data = key.slice(0, 5)
    rng = np.random.default_rng(t_bits)
    x = _uniform(rng, data.values, (2,), n, dev)
    ms = keyswitch.bgv_divide_consts(data.slice(0, 4), moduli[4], t)
    _kernels.reset_launch_counts()
    got = rns.mod_t_and_divide_q_last_ntt(x, data, ms)
    counts = _kernels.launch_counts()
    assert (counts["A_ntt"], counts["AKp_bgv_ntt"]) == (1, 1)
    assert not any(counts[k] for k in KP_KERNELS), counts
    _same(got, rns.mod_t_and_divide_q_last_ntt_plain(x, data, ms))
    key_j = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
    data_j = key_j.slice(0, 5)
    _kernels.reset_launch_counts()
    got_j = rns.mod_t_and_divide_q_last_ntt(x, data_j, ms)
    counts = _kernels.launch_counts()
    assert (counts["Kp_bgv_ntt"], counts["Kp_rescale_ntt"],
            counts["AKp_bgv_ntt"]) == (2, 0, 0)
    _same(got_j, got)
    last = _uniform(rng, [moduli[4]], (2,), n, dev)[:, 0]
    _same(rns._ntt_temps(rns.BGV_MOD_SWITCH[0], last, ms),
          rns.bgv_divide_ntt_temps_plain(last, ms))
    temps = _uniform(rng, [4 * q for q in moduli[:4]], (2,), n, dev)
    _same(rns._ntt_finish(rns.BGV_MOD_SWITCH[1], x, temps, ms[:22], None),
          rns.divide_round_ntt_finish_plain(x, temps, ms[:22]))
    used = key.select(keyswitch.used_limbs(5, 6))
    ks = keyswitch.bgv_divide_consts(data, moduli[-1], t)
    sp = _uniform(rng, [moduli[-1]], (2,), n, dev)[:, 0]
    _same(rns._ntt_temps(rns.BGV_KEYSWITCH[0], sp, ks),
          rns.bgv_divide_ntt_temps_plain(sp, ks))
    y = _uniform(rng, used.values, (2,), n, dev)
    for comps in (0, 1, 2):
        acc = _uniform(rng, data.values, (comps,), n, dev) if comps else None
        _kernels.reset_launch_counts()
        got = rns.divide_round_last_ntt(y, data, used.slice(5, 6), ks, acc,
                                        rns.BGV_KEYSWITCH)
        counts = _kernels.launch_counts()
        assert (counts["A_ntt"], counts["AKp_bgv_ntt"]) == (1, 1)
        assert not any(counts[k] for k in KP_KERNELS), counts
        used_j = key_j.select(keyswitch.used_limbs(5, 6))
        _kernels.reset_launch_counts()
        got_j = rns.divide_round_last_ntt(y, data_j, used_j.slice(5, 6), ks,
                                          acc, rns.BGV_KEYSWITCH)
        counts = _kernels.launch_counts()
        assert (counts["Kp_bgv_ntt"], counts["Kp_keyswitch_ntt"],
                counts["AKp_bgv_ntt"]) == (1, 1, 0)
        _same(got_j, got)
        k = 5
        lst = ntt.ntt_inverse_plain(y[:, k:], used.slice(5, 6))[:, 0]
        tp = ntt.ntt_forward_plain(rns.bgv_divide_ntt_temps_plain(lst, ks),
                                   data, lazy=True)
        _same(got, rns.divide_round_ntt_finish_plain(y, tp, ks[:5 * k + 2],
                                                     acc))


@pytest.mark.parametrize("t_bits", [20, 59])
def test_plain_lift_kernel(dev, t_bits):
    """Kernel G' with the centred threshold, with threshold t (the BGV
    encrypt's raw residues) and with a correction factor."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])][:5]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    t = int(P.PlainModulus.batching(n, t_bits))
    Q = 1
    for v in moduli:
        Q *= v
    rng = np.random.default_rng(t_bits + 1)
    m = interop.to_torch(rng.integers(0, t, size=(2, n), dtype=np.uint64),
                         dev)
    for threshold, cf in (((t + 1) >> 1, 1), (t, 1), ((t + 1) >> 1, 4321)):
        _same(poly.plain_lift(m, tables, t, threshold, Q, cf),
              poly.plain_lift_plain(m, tables, t, threshold, Q, cf))


def _bgv_slice(device):
    """keygen -> encrypt x2 -> multiply -> relinearize -> mod switch,
    rotate_rows, rotate_columns, add with unequal correction factors, the
    plain ops -> decrypt at n = 1024, as numpy words per stage."""
    n = 1024
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(7), host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1, 0])
    be = P.BatchEncoder(ctx)
    rng = np.random.default_rng(7)
    vals = [rng.integers(0, be.plain_modulus, n, dtype=np.uint64)
            for _ in range(3)]
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(8), host_sampling=True)
    cts = [enc.encrypt_symmetric(be.encode(v)) for v in vals[:2]]
    ev = P.Evaluator(ctx)
    rel = ev.relinearize(ev.multiply(*cts), rlk)
    ms = ev.mod_switch_to_next(rel)
    c3 = ev.mod_switch_to_next(cts[0])
    pt = be.encode(vals[2])
    dec = P.Decryptor(ctx, kg.secret_key)
    out = {"c1": cts[0], "rel": rel, "ms": ms,
           "rot": ev.rotate_rows(rel, 1, gk),
           "col": ev.rotate_columns(ms, gk),
           "sum": ev.add(ms, c3),
           "mulp": ev.multiply_plain(ms, pt),
           "addp": ev.add_plain(ms, pt), "subp": ev.sub_plain(c3, pt)}
    words = {k: interop.words(v) for k, v in out.items()}
    words["decode"] = be.decode(dec.decrypt(out["sum"]))
    words["budget"] = np.array([dec.invariant_noise_budget(ms)])
    return words


def test_bgv_slice_on_the_card_gives_the_cpu_words(dev):
    _kernels.reset_launch_counts()
    on_card = _bgv_slice(dev)
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in BGV_KERNELS), counts
    assert not any(counts[k] for k in KP_KERNELS), counts
    assert counts["Gp_plain_lift"] == 0, counts
    on_host = _bgv_slice("cpu")
    for stage, words in on_host.items():
        np.testing.assert_array_equal(on_card[stage], words, err_msg=stage)


@pytest.mark.parametrize("limbs", [6, 5])
@pytest.mark.parametrize("batch", [None, 5])
@pytest.mark.parametrize("kind", ["uniform", "cbd", "cbd_t", "ternary"])
def test_sampling_kernel(dev, limbs, batch, kind):
    """Kernel I at n = 16384 over the key base (6 limbs) and the first data
    level (5), for one seed and for a device array of seeds."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])][:limbs]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    seeds = (2 ** 64 - 3 if batch is None else interop.to_torch(
        np.random.default_rng(limbs).integers(0, 2 ** 64, batch,
                                              dtype=np.uint64), dev))
    t = 786433
    if kind == "uniform":
        got = sampling.sample_uniform_rns(seeds, tables)
        want = sampling.sample_uniform_rns_plain(seeds, tables)
    elif kind == "ternary":
        got = sampling.sample_ternary_rns(seeds, tables)
        want = sampling.sample_ternary_rns_plain(seeds, tables)
    else:
        scale = t if kind == "cbd_t" else None
        got = sampling.sample_cbd_rns(seeds, tables, scale)
        want = sampling.sample_cbd_rns_plain(seeds, tables, scale)
    assert got.shape == ((limbs, n) if batch is None else (batch, limbs, n))
    _same(got, want)


@pytest.mark.parametrize("limbs", [6, 5])
@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("scale", [None, 786433])
def test_sampling_zero_sym_kernel(dev, limbs, batch, scale):
    """Kernel I's one launch for a symmetric zero encryption (e, then a)
    against its plain version, at n = 16384, one seed pair and 8."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])][:limbs]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    if batch is None:
        a_seeds, e_seeds, lead = 2 ** 64 - 1, 5, ()
    else:
        rng = np.random.default_rng(limbs)
        a_seeds, e_seeds = (interop.to_torch(rng.integers(
            0, 2 ** 64, batch, dtype=np.uint64), dev) for _ in range(2))
        lead = (batch,)
    buf = torch.empty((2,) + lead + (limbs, n), dtype=torch.int64,
                      device=dev)
    sampling.sample_zero_sym_rns(a_seeds, e_seeds, tables, scale, buf[0],
                                 buf[1])
    e, a = sampling.sample_zero_sym_plain(a_seeds, e_seeds, tables, scale)
    _same(buf[0], e)
    _same(buf[1], a)


@pytest.mark.parametrize("limbs", [6, 5])
@pytest.mark.parametrize("scale", [None, 786433])
def test_sampling_zero_asym_kernel(dev, limbs, scale):
    """Kernel I's one launch for a public-key zero encryption (u, e_0,
    e_1) against its plain version at n = 16384."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])][:limbs]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    seeds = [2 ** 63 + 3, 0, 2 ** 64 - 1]
    _same(sampling.sample_zero_asym_rns(seeds[0], seeds[1:], tables, scale),
          sampling.sample_zero_asym_plain(seeds[0], seeds[1:], tables,
                                          scale))


def _edge(rng, moduli, lead, n, dev):
    """Words 0 or q - 1 only."""
    cols = [np.where(rng.integers(0, 2, lead + (1, n)), q - 1, 0).astype(
        np.uint64) for q in moduli]
    return interop.to_torch(np.concatenate(cols, axis=-2), dev)


@pytest.mark.parametrize("edge", [False, True])
def test_rns_fused_forms_kernel(dev, edge):
    """Kernel D's fused forms against their plain versions at n = 16384
    over six limbs: the zero encryptions' finishes (one ciphertext in
    place, a batch of 8 into c0 with c1 copied), the switching-key rows of
    5 and the balanced add and sub."""
    n = 16384
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(7 + int(edge))
    words = (lambda lead: _edge(rng, moduli, lead, n, dev)) if edge else \
        (lambda lead: _uniform(rng, moduli, lead, n, dev))
    x, y, m = words(()), words(()), words(())
    for mm in (None, m):
        ct = torch.stack([words(()), words(())])
        c1 = ct[1].clone()
        poly.zero_sym_finish(x, y, t, mm, out=ct[0])
        _same(ct[0], poly.zero_sym_finish_plain(x, y, t, mm))
        _same(ct[1], c1)
    xb, yb, mb, cb = (words((8,)) for _ in range(4))
    ct = torch.empty((8, 2, 6, n), dtype=torch.int64, device=dev)
    poly.zero_sym_finish(xb, yb, t, mb, out=ct[:, 0], c1=cb)
    _same(ct[:, 0], poly.zero_sym_finish_plain(xb, yb, t, mb))
    _same(ct[:, 1], cb)
    # in place over x, as the coefficient form's finish runs
    want = poly.zero_sym_finish_plain(xb, yb, t)
    poly.zero_sym_finish(xb, yb, t, out=xb)
    _same(xb, want)
    xa, ya = words((2,)), words((2,))
    for mm in (None, m):
        _same(poly.zero_asym_finish(xa, ya, t, mm),
              poly.zero_asym_finish_plain(xa, ya, t, mm))
    xk, yk, ak = words((5,)), words((5,)), words((5,))
    w = words(())
    got = poly.switching_key_rows(xk, yk, ak, w, moduli[-1], t)
    _same(got[:, 0], poly.key_rows_finish_plain(xk, yk, w, moduli[-1], t))
    _same(got[:, 1], ak)
    for subtract in (False, True):
        _same(poly.balanced_add(xa, ya, 3, 786431, t, subtract),
              poly.balanced_add_plain(xa, ya, 3, 786431, t, subtract))


def _default_path(device, scheme):
    """Default (device-sampled) encryption at n = 1024: the public key in
    both forms, encrypt, encrypt_symmetric, save_seed and expand_seed,
    encrypt_symmetric_many, encrypt_zero, the relin key of an external
    secret key and a key-switching key; numpy words per stage."""
    n = 1024
    extra = {} if scheme == "ckks" else {
        "plain_modulus": P.PlainModulus.batching(n, 20)}
    parms = P.EncryptionParameters(
        scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
        **extra)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(17))
    pk = kg.create_public_key()
    enc = P.Encryptor(ctx, pk, kg.secret_key, seed=prng.seed_from_uint64(18))
    rng = np.random.default_rng(17)
    if scheme == "ckks":
        pt = P.CKKSEncoder(ctx).encode(rng.uniform(-1, 1, n // 2), 2.0 ** 40)
    else:
        pt = P.BatchEncoder(ctx).encode(
            rng.integers(0, int(parms.plain_modulus), n, dtype=np.uint64))
    ss = enc.encrypt_symmetric(pt, save_seed=True)
    dropped = ss.replace(data=torch.stack([ss.data[0], ss.data[1] * 0]),
                         seed=ss.seed)
    ext = P.KeyGenerator(ctx, kg.secret_key, prng.seed_from_uint64(19))
    out = {"pk": pk, "pk_seed": kg.create_public_key(save_seed=True),
           "encrypt": enc.encrypt(pt), "sym": enc.encrypt_symmetric(pt),
           "ss": ss,
           "expand": rlwe.expand_seed(dropped, ctx.first_context_data),
           "zero": enc.encrypt_zero(),
           "zero_sym": enc.encrypt_zero(asymmetric=False),
           "rlk": ext.create_relin_keys(),
           "ksk": P.KeyGenerator(ctx, seed=prng.seed_from_uint64(20))
           .create_keyswitch_key(kg.secret_key)}
    words = {k: interop.words(v) for k, v in out.items()}
    for i, ct in enumerate(enc.encrypt_symmetric_many([pt] * 3)):
        words[f"many{i}"] = interop.words(ct)
    words["rlk"] = words["rlk"][2]
    words["ksk"] = words["ksk"][1]
    return words


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_default_encryption_on_the_card_gives_the_cpu_words(dev, scheme):
    _kernels.reset_launch_counts()
    on_card = _default_path(dev, scheme)
    assert _kernels.launch_counts()["I_sampling"] > 0
    on_host = _default_path("cpu", scheme)
    for stage, words in on_host.items():
        np.testing.assert_array_equal(on_card[stage], words, err_msg=stage)


# --------------------------------------------------------------------------
# N1, N2, the batched forms of M and B, K'' and the LWE slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 16384])
def test_negacyclic_kernels(dev, n):
    """Kernel N1: one shift, a shift per row, the extract at terms 0, 1, n-1 and shift exactly n, the assemble; then
    N2 at the pack tree's shifts."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])][:5]
    q = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n + 21)
    x = _uniform(rng, moduli, (2,), n, dev)
    x[:, :, ::7] = 0
    for s in (0, 1, n - 1, n, n + 3, 2 * n - 1, 5 * n + 2, -3):
        _same(poly.negacyclic_shift(x, s, q),
              poly.negacyclic_shift_plain(x, s, q))
    rows = interop.to_torch(np.array([0, 1, n - 1, n, n + 3, 2 * n - 1]),
                            dev)
    xs = _uniform(rng, moduli, (6,), n, dev)
    _same(poly.negacyclic_shift(xs, rows, q),
          poly.negacyclic_shift_plain(xs, rows, q))
    terms = np.array([0, 1, n - 1, n // 2, 5])
    shifts = interop.to_torch(np.where(terms == 0, 0, 2 * n - terms), dev)
    for got, want in zip(poly.extract_lwe_many(x, shifts, q),
                         poly.extract_lwe_many_plain(x, shifts, q)):
        _same(got, want)
    c0s = _uniform(rng, moduli, (6,), 1, dev)[..., 0]
    inv_n = [pow(n, -1, m) for m in moduli]
    _same(poly.assemble_lwe(xs, c0s, 0, q, inv_n),
          poly.assemble_lwe_plain(xs, c0s, 0, q, inv_n))
    t6 = interop.to_torch(np.array([0, 1, 2, n - 1, 9, 3]), dev)
    _same(poly.assemble_lwe(xs, c0s, t6, q),
          poly.assemble_lwe_plain(xs, c0s, t6, q))
    cur = _uniform(rng, moduli, (8, 2), n, dev)
    for s in (n // 2, n // 4, n // 8):
        for got, want in zip(poly.pack_fold_prepare(cur, s, q),
                             poly.pack_fold_prepare_plain(cur, s, q)):
            _same(got, want)


def test_batched_galois_and_dyadic_kernels(dev, tool):
    """Kernel M with one table per element, signed and unsigned, and one
    table written component-major; kernel B's batched key-switch
    product."""
    n, dt = tool
    rng = np.random.default_rng(22)
    x = _uniform(rng, dt.q.values, (6, 2), n, dev)
    x[..., ::5] = 0
    elts = (3, 9, 2 * n - 1, 27, 81, 5)
    for signed in (True, False):
        tables = galois.batched_tables(n, elts, dev, signed)
        srcs, keeps = galois.unpack_table(tables)
        _same(galois.permute_batched(x, tables, dt.q),
              galois.permute_batched_plain(x, srcs, keeps if signed else None,
                                           dt.q))
        one = galois.batched_tables(n, (5,), dev, signed)
        src, keep = galois.unpack_table(one.expand(6, n))
        _same(galois.permute_batched(x, one, dt.q, True),
              galois.permute_batched_plain(x, src, keep if signed else None,
                                           dt.q, True))
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    used = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    key = _uniform(rng, moduli, (5, 2), n, dev)
    targets = _uniform(rng, moduli, (7, 5), n, dev)
    _same(ntt.dyadic_mac_batched(key, targets, used),
          ntt.dyadic_mac_plain(targets.transpose(0, 1).unsqueeze(2),
                               key.unsqueeze(1), used))


@pytest.mark.parametrize("t_bits", [20, 59])
def test_bgv_coeff_divide_kernel(dev, t_bits):
    """Kernel K'': divisor the special prime, with every accumulator
    layout, and divisor q_last (mod_t_and_divide_q_last), words 0 and
    q - 1 included."""
    n = 1024
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    key = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    t = int(P.PlainModulus.batching(n, t_bits))
    level = key.slice(0, 5)
    ks = keyswitch.bgv_divide_consts(level, moduli[-1], t)
    rng = np.random.default_rng(t_bits)
    x = _uniform(rng, moduli, (8,), n, dev)
    x[0, :, :3] = 0
    x[1, :, :3] = interop.to_torch(np.array(moduli, dtype=np.uint64)[:, None]
                                   - 1, dev)
    accs = [(None, None), (_uniform(rng, moduli[:5], (2,), n, dev), None),
            (_uniform(rng, moduli[:5], (4, 1), n, dev), 2),
            (_uniform(rng, moduli[:5], (1, 1), n, dev), 2)]
    for acc, group in accs:
        _same(keyswitch.bgv_divide_last(x, ks, acc, group),
              keyswitch.bgv_divide_last_plain(x, ks, acc, group))
    ms = keyswitch.bgv_divide_consts(level.slice(0, 4), moduli[4], t)
    y = _uniform(rng, moduli[:5], (3,), n, dev)
    _kernels.reset_launch_counts()
    got = rns.mod_t_and_divide_q_last(y, level, ms)
    assert _kernels.launch_counts()["Kpp_bgv_coeff"] == 1
    _same(got, keyswitch.bgv_divide_last_plain(y, ms))


def _lwe_slice(device, scheme):
    """Hoisted Galois, the shift, extract, pack and trace at n = 1024 on
    one device, as numpy words per stage."""
    n = 1024
    extra = {} if scheme == "ckks" else {
        "plain_modulus": P.PlainModulus.batching(n, 20)}
    parms = P.EncryptionParameters(
        scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40, 40])),
        **extra)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(23),
                        host_sampling=True)
    gk = kg.create_galois_keys(
        elts=sorted({(1 << i) + 1 for i in range(1, 11)} | {2 * n - 1}))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(24), host_sampling=True)
    rng = np.random.default_rng(23)
    if scheme == "ckks":
        pt = P.CKKSEncoder(ctx).encode(rng.uniform(-1, 1, n // 2), 2.0 ** 30)
    else:
        pt = P.BatchEncoder(ctx).encode(
            rng.integers(0, int(parms.plain_modulus), n, dtype=np.uint64))
    ct = enc.encrypt_symmetric(pt)
    ev = P.Evaluator(ctx)
    coeff = ev.transform_from_ntt(ct) if ct.is_ntt_form else ct
    lwes = ev.extract_lwe_many(ct, [0, 1, 7, n - 1, 300])
    out = {"hoist": [interop.words(c) for c in ev.apply_galois_many(
               ct, [3, 5, 9, 2 * n - 1], gk)],
           "shift": interop.words(ev.negacyclic_shift(coeff, n + 5)),
           "pack": interop.words(ev.pack_lwe_ciphertexts(lwes, gk)),
           "trace": interop.words(ev.field_trace(ct, gk, 1))}
    if scheme == "bgv":
        out["coeff_hoist"] = [interop.words(c) for c in ev.apply_galois_many(
            coeff, [3, 5], gk)]
    return out


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_lwe_slice_on_the_card_gives_the_cpu_words(dev, scheme):
    _kernels.reset_launch_counts()
    on_card = _lwe_slice(dev, scheme)
    counts = _kernels.launch_counts()
    assert counts["N1_negacyclic"] > 0 and counts["N2_pack_prepare"] > 0
    if scheme == "bgv":
        assert counts["Kpp_bgv_coeff"] > 0
    on_host = _lwe_slice("cpu", scheme)
    for stage, words in on_host.items():
        np.testing.assert_array_equal(np.asarray(on_card[stage]),
                                      np.asarray(words), err_msg=stage)


@pytest.mark.parametrize("n", [64, 16384])
def test_tile_kernels(dev, n):
    """P1 (I = 70: past the 64-term reduction; and the matmul's 8 x 16),
    P2 over q u Bsk with lazy inputs (sizes 2 x 2 and 3 x 2) and over q,
    P3 at m = 16 and a ragged m = 20 with P = 16, and P = 1."""
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=P.Modulus(1 << 41))
    cd = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                     device=dev).first_context_data
    q, bsk = cd.ntt, cd.rns.q_bsk
    moduli = q.values
    rng = np.random.default_rng(n + 7)
    for X, I, Y in ((1, 70, 3), (1, 8, 16)):
        a = _uniform(rng, moduli, (X, I, 2), n, dev)
        w = _uniform(rng, moduli, (I, Y), n, dev)
        _kernels.reset_launch_counts()
        got = tiles.tile_contract(a, w, q)
        assert _kernels.launch_counts()["P1_tile_contract"] == 1
        _same(got, tiles.tile_contract_plain(a, w, q))
    for tables in (bsk, q):
        lazy = [4 * v for v in tables.values]
        for s1 in (2, 3):
            a = _uniform(rng, lazy, (2, s1), n, dev)
            w = _uniform(rng, lazy, (5, 2), n, dev)
            _same(tiles.tile_pair_convolve(a, w, tables),
                  tiles.tile_pair_convolve_plain(a, w, tables))
    for m, slots in ((16, 16), (20, 16), (3, 1)):
        d = _uniform(rng, moduli, (m, 2), n, dev)
        _same(tiles.pack_group_fold(d, slots, q),
              tiles.pack_group_fold_plain(d, slots, q))


def test_decrypt_many_launches_do_not_grow_with_the_batch(dev):
    """One launch per step for 2 or 8 ciphertexts, and the CPU's words."""
    n = 1024
    counts, words = {}, {}
    for device in (dev, "cpu"):
        parms = P.EncryptionParameters(
            scheme=P.SchemeType.bfv, poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40])),
            plain_modulus=P.PlainModulus.batching(n, 20))
        ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                          device=device)
        kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(31),
                            host_sampling=True)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(32))
        be = P.BatchEncoder(ctx)
        cts = enc.encrypt_symmetric_many(
            [be.encode(np.arange(n, dtype=np.uint64) * i % be.plain_modulus)
             for i in range(8)])
        dec = P.Decryptor(ctx, kg.secret_key)
        for b in (2, 8):
            _kernels.reset_launch_counts()
            out = dec.decrypt_many(cts[:b])
            counts[(str(device), b)] = _kernels.launch_counts()
            words[(str(device), b)] = [interop.words(p) for p in out]
    assert counts[(str(dev), 2)] == counts[(str(dev), 8)]
    assert sum(counts[(str(dev), 8)].values()) == 3   # A, B (c0 too), ACi
    for b in (2, 8):
        np.testing.assert_array_equal(np.asarray(words[(str(dev), b)]),
                                      np.asarray(words[("cpu", b)]))


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_decode_of_decrypt_many_plaintexts(dev, scheme):
    """decrypt_many returns plaintexts on the host; the encoders of a
    context on the card decode them as they decode decrypt's (they raised
    on the two devices before; chip_smoke.py's phase 36c decodes them)."""
    n = 64
    ckks = scheme == "ckks"
    extra = {} if ckks else {"plain_modulus": P.PlainModulus.batching(n, 17)}
    parms = P.EncryptionParameters(
        scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [50, 40, 50])), **extra)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=dev)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(33))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(34))
    dec = P.Decryptor(ctx, kg.secret_key)
    coder = P.CKKSEncoder(ctx) if ckks else P.BatchEncoder(ctx)
    values = [np.linspace(-1, 1, n // 2) * (i + 1) for i in range(2)] \
        if ckks else [np.arange(n, dtype=np.uint64) * (i + 1) for i in
                      range(2)]
    cts = [enc.encrypt_symmetric(coder.encode(v, 2.0 ** 30) if ckks
                                 else coder.encode(v)) for v in values]
    many = dec.decrypt_many(cts)
    assert all(not p.data.is_cuda for p in many)
    for ct, p in zip(cts, many):
        one = dec.decrypt(ct)
        np.testing.assert_array_equal(coder.decode(p), coder.decode(one))
        if ckks:
            for a, b in zip(coder.decode_device(p), coder.decode_device(one)):
                assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(coder.decode_signed(p),
                                          coder.decode_signed(one))


def _app_slice(device, scheme):
    """The app protocol at n = 4096 on one device: words, bytes and the
    decrypted results per stage."""
    from troy_tpu_torch.app.linear import Cipher2d, Conv2dHelper, MatmulHelper
    n = 4096
    bits = [60, 40, 40, 60] if scheme == "ckks" else [60, 60, 60]
    extra = {} if scheme == "ckks" else {"plain_modulus": P.Modulus(1 << 41)}
    parms = P.EncryptionParameters(
        scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, bits)), **extra)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(41))
    dk = P.KeyGenerator(ctx, kg.secret_key, prng.seed_from_uint64(42))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(43))
    dec, ev = P.Decryptor(ctx, kg.secret_key), P.Evaluator(ctx)
    rng = np.random.default_rng(41)
    out = {}
    grid = lambda g: [interop.words(c) for row in g.data for c in row]
    if scheme == "ckks":
        ce = P.CKKSEncoder(ctx)
        ep = lambda v: ce.encode_polynomial(v, 2.0 ** 40)
        x, w = rng.uniform(-1, 1, (8, 24)), rng.uniform(-1, 1, (24, 40))
        h = MatmulHelper(8, 24, 40, n, objective=0, pack_lwe=False)
        y = h.matmul(ev, h.encrypt_inputs(enc, ep, x), h.encode_weights(ep, w))
        out["matmul"] = grid(y)
        out["blob"] = h.serialize_outputs(ev, ctx, y)
        got = h.decrypt_outputs(ce.decode_polynomial, dec,
                                h.deserialize_outputs(ev, ctx, out["blob"]))
        assert np.abs(got.astype(np.float64) - x @ w).max() < 1e-6
        return out
    be = P.BatchEncoder(ctx)
    t = be.plain_modulus
    ep, dp = be.encode_polynomial, be.decode_polynomial
    x = rng.integers(0, 256, (16, 24), dtype=np.uint64)
    w = rng.integers(0, 256, (24, 40), dtype=np.uint64)
    want = (x.astype(object) @ w.astype(object)) % t
    h = MatmulHelper(16, 24, 40, n, objective=0, pack_lwe=True)
    logn = (n // h.input_block).bit_length() - 1
    steps = n.bit_length() - 1 - logn            # the trace's folds
    gk = dk.create_galois_keys(elts=[(n >> i) + 1 for i in range(steps)])
    xc = h.encrypt_inputs(enc, ep, x)
    if scheme == "bgv":
        xc = Cipher2d([[ev.transform_from_ntt(c) for c in row]
                       for row in xc.data])
    y = h.matmul(ev, xc, h.encode_weights(ep, w))
    out["matmul"] = grid(y)
    packed = h.pack_outputs(ev, gk, y)
    out["packed"] = grid(packed)
    out["blob"] = h.serialize_outputs(ev, ctx, packed)
    got = h.decrypt_outputs(dp, dec, h.deserialize_outputs(ev, ctx,
                                                           out["blob"]))
    np.testing.assert_array_equal(got.astype(object) % t, want)
    if scheme == "bgv":
        return out
    hc = MatmulHelper(16, 24, 40, n, objective=0, pack_lwe=False)
    yc = hc.matmul_cipher(ev, hc.encrypt_inputs(enc, ep, x),
                          hc.encode_weights(ep, w).encrypt_symmetric(enc))
    out["cipher"] = grid(yc)
    yc = yc.relinearize(ev, dk.create_relin_keys())
    got = hc.decrypt_outputs(dp, dec, yc)
    np.testing.assert_array_equal(got.astype(object) % t, want)
    img = rng.integers(0, 256, (1, 4, 10, 10), dtype=np.uint64)
    ker = rng.integers(0, 256, (6, 4, 3, 3), dtype=np.uint64)
    ch = Conv2dHelper(1, 10, 10, 3, 3, 4, 6, n, objective=0)
    yv = ch.conv2d(ev, ch.encrypt_inputs(enc, ep, img),
                   ch.encode_weights(ep, ker))
    out["conv"] = grid(yv)
    out["conv_blob"] = ch.serialize_outputs(ev, ctx, yv)
    return out


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_app_slice_on_the_card_gives_the_cpu_words(dev, scheme):
    _kernels.reset_launch_counts()
    on_card = _app_slice(dev, scheme)
    counts = _kernels.launch_counts()
    assert counts["P1_tile_contract"] > 0
    if scheme != "ckks":
        assert counts["P3_group_fold"] > 0
    if scheme == "bfv":
        # the pair grid's convolution in A's first inverse pass (AP2i)
        assert counts["AP2i_pair_intt"] > 0
        assert counts["P2_pair_convolve"] == 0
    on_host = _app_slice("cpu", scheme)
    for stage, words in on_host.items():
        if isinstance(words, bytes):
            assert on_card[stage] == words, stage
        else:
            np.testing.assert_array_equal(np.asarray(on_card[stage]),
                                          np.asarray(words), err_msg=stage)


def test_reused_plain2d_conv2d_lifts_and_stacks_its_weights_once(
        dev, monkeypatch):
    """The second conv2d of one Plain2d on the card launches no AGp
    (``troy_ntt_forward_lift``, the weights' lift and transform) and
    stacks no weight tile: the first call's prepared grid serves it; every
    other launch is the first call's, and so are the words."""
    from troy_tpu_torch.app import linear
    n = 4096
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=P.Modulus(1 << 41))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=dev)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(51))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(52))
    ev, ep = P.Evaluator(ctx), P.BatchEncoder(ctx).encode_polynomial
    rng = np.random.default_rng(51)
    h = linear.Conv2dHelper(1, 10, 10, 3, 3, 4, 6, n, objective=0)
    x = h.encrypt_inputs(enc, ep, rng.integers(0, 256, (1, 4, 10, 10),
                                               dtype=np.uint64))
    w = h.encode_weights(ep, rng.integers(0, 256, (6, 4, 3, 3),
                                          dtype=np.uint64))
    weight_tiles = {id(p.data) for row in w.data for p in row}
    stacks, stack = [], torch.stack

    def counted_stack(tensors, *args, **kwargs):
        stacks.append(any(id(t) in weight_tiles for t in tensors))
        return stack(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "stack", counted_stack)
    calls = []
    for _ in range(2):
        stacks.clear()
        _kernels.reset_launch_counts()
        linear.reset_prepared_counts()
        y = h.conv2d(ev, x, w)
        torch.cuda.synchronize()
        calls.append((_kernels.entry_launch_counts(), sum(stacks),
                      linear.prepared_counts(),
                      [interop.words(c) for row in y.data for c in row]))
    (first, first_stacks, first_use, first_words), \
        (second, second_stacks, second_use, second_words) = calls
    assert first["troy_ntt_forward_lift"] == 1 and first_stacks == 1
    assert second["troy_ntt_forward_lift"] == 0 and second_stacks == 0
    assert first_use == {"builds": 1, "hits": 0}
    assert second_use == {"builds": 0, "hits": 1}
    assert dict(first, troy_ntt_forward_lift=0) == second
    assert second["troy_tile_contract"] == 1
    np.testing.assert_array_equal(np.asarray(second_words),
                                  np.asarray(first_words))


# --------------------------------------------------------------------------
# kernel J (the int8 tensor-core 4-step NTT) and the large-ring caps
# --------------------------------------------------------------------------

MXU_SHAPES = {"n2048": (2048, [60, 40, 30]),
              "n16384": (16384, [60, 40, 40, 40, 40, 60]),
              "n32768": (32768, [60, 55]),
              "n262144": (262144, [55])}


@pytest.mark.parametrize("shape", sorted(MXU_SHAPES))
def test_ntt_mxu_kernel(dev, shape):
    """J against its plain version, forward (also with a 40-bit X bound)
    and inverse, on any u64 words."""
    n, bits = MXU_SHAPES[shape]
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
    rng = np.random.default_rng(n)
    x = _words(rng, (2, len(moduli), n), dev)
    _kernels.reset_launch_counts()
    _same(ntt.rns_ntt_forward(x, tables),
          ntt_mxu.rns_ntt_mxu_plain(x, tables.mxu, False))
    _same(ntt.rns_ntt_inverse(x, tables),
          ntt_mxu.rns_ntt_mxu_plain(x, tables.mxu, True))
    small = _words(rng, (2, len(moduli), n), dev) & ((1 << 40) - 1)
    _same(ntt.rns_ntt_forward(small, tables, x_bound_bits=40),
          ntt_mxu.rns_ntt_mxu_plain(small, tables.mxu, False, 5))
    assert _kernels.launch_counts()["J_ntt_mxu"] == 6


@pytest.mark.parametrize("n", [4096, 16384])
def test_ntt_mxu_gives_the_words_of_a(dev, n):
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    a = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
    j = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
    rng = np.random.default_rng(n + 1)
    x = _uniform(rng, [4 * q for q in moduli], (3,), n, dev)
    _same(ntt.rns_ntt_forward(x, j), ntt.rns_ntt_forward(x, a))
    y = _uniform(rng, [2 * q for q in moduli], (3,), n, dev)
    _same(ntt.rns_ntt_inverse(y, j), ntt.rns_ntt_inverse(y, a))


@pytest.mark.parametrize("k", [16, 17])
def test_base_convert_and_behz_at_the_limb_caps(dev, k):
    """Kernels C and E at SEAL's n = 32768 bases: k primes of q, |Bsk| =
    k + 1 and m~ (here at n = 1024)."""
    n = 1024
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [60] + [40] * (k - 1)))
    t = int(P.PlainModulus.batching(n, 20))
    host = make_rns_tool(n, q, t)
    dt = rns.DeviceRnsTool.build(host, ntt.RnsNttTables.from_moduli(n, q, dev),
                                 ntt.RnsNttTables.from_moduli(
                                     n, host.base_Bsk.values, dev))
    assert dt.nb + 1 == k + 2 <= rns.MAX_KERNEL_LIMBS
    rng = np.random.default_rng(k)
    for conv in (dt.q_to_bsk_m_tilde, dt.b_to_q_m_sk, dt.q_to_t_gamma):
        x = _words(rng, (2, conv.k_in, n), dev)
        _same(rns.fast_convert(x, conv), rns.fast_convert_plain(x, conv))
    x = _uniform(rng, dt.q.values, (2,), n, dev)
    _same(rns.behz_lift(x, dt), rns.behz_lift_plain(x, dt))
    y = _uniform(rng, dt.q_bsk.values, (2,), n, dev)
    _same(rns.behz_tail(y, dt), rns.behz_tail_plain(y, dt))
    _same(rns.decrypt_scale_and_round(x, dt),
          rns.decrypt_scale_and_round_plain(x, dt))


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_behz_tiles(dev, k, batch):
    """Kernel E's limb-tiled lift and tail against their plain versions
    at k = 1, 5 and 16 primes of q (|Bsk| = k + 1), n = 4096 (64 tiles a
    polynomial) and at n = 32 (one tile narrower than 64)."""
    bits = [50] if k == 1 else [60] + [40] * (k - 1)
    rng = np.random.default_rng(100 * k + batch)
    for n in (4096, 32):
        q = tuple(int(m) for m in P.CoeffModulus.create(
            max(n, 1024), bits))
        host = make_rns_tool(n, q, int(P.PlainModulus.batching(
            max(n, 1024), 20)))
        dt = rns.DeviceRnsTool.build(
            host, ntt.RnsNttTables.from_moduli(n, q, dev),
            ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, dev))
        x = _uniform(rng, dt.q.values, (batch,), n, dev)
        _same(rns.behz_lift(x, dt), rns.behz_lift_plain(x, dt))
        y = _uniform(rng, dt.q_bsk.values, (batch,), n, dev)
        _same(rns.behz_tail(y, dt), rns.behz_tail_plain(y, dt))
        z = _words(rng, (batch, dt.k + dt.nb, n), dev)     # any u64 words
        _same(rns.behz_tail(z, dt), rns.behz_tail_plain(z, dt))


def test_ntt_mxu_one_limb_at_n65536(dev):
    """J's butterfly stages at A = B = 256 on one 60-bit limb: every stage
    and both transforms against the plain version, and A's words."""
    n = 65536
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
    t0 = tables.mxu[0]
    rng = np.random.default_rng(n + 7)
    x = _words(rng, (1, 1, t0.a, t0.b), dev)
    r = _uniform(rng, moduli, (1,), n, dev).reshape(1, 1, t0.a, t0.b)
    for stage in ntt_mxu.STAGES:
        v = x if ntt_mxu.STAGES[stage][3] else r
        _same(ntt_mxu.rns_mxu_stage(v, tables.mxu, tables.mxu_pointers,
                                    stage),
              ntt_mxu.mxu_stage_plain(v, tables.mxu, stage))
    flat = r.reshape(1, 1, n)
    a = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
    _same(ntt.rns_ntt_forward(flat, tables), ntt.rns_ntt_forward(flat, a))
    _same(ntt.rns_ntt_inverse(flat, tables), ntt.rns_ntt_inverse(flat, a))


def test_mxu_context_on_the_card_gives_the_cpu_words(dev):
    """BFV at n = 4096 on J (use_mxu=True): the card's words are the CPU
    run's, and J ran."""
    def run(device):
        n = 4096
        parms = P.EncryptionParameters(
            scheme=P.SchemeType.bfv, poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
            plain_modulus=P.PlainModulus.batching(n, 20))
        ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                          device=device, use_mxu=True)
        kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(9),
                            host_sampling=True)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(10), host_sampling=True)
        be = P.BatchEncoder(ctx)
        ev = P.Evaluator(ctx)
        a = np.arange(n, dtype=np.uint64) % be.plain_modulus
        c = enc.encrypt_symmetric(be.encode(a))
        rel = ev.relinearize(ev.multiply(c, c), kg.create_relin_keys())
        rot = ev.rotate_rows(rel, 1, kg.create_galois_keys(steps=[1]))
        return [interop.words(x) for x in (rel, rot,
                                           ev.mod_switch_to_next(rot))]
    _kernels.reset_launch_counts()
    got = run(dev)
    assert _kernels.launch_counts()["J_ntt_mxu"] > 0
    assert _kernels.launch_counts()["A_ntt"] == 0
    for g, w in zip(got, run("cpu")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("w", [1, 2, 4])
def test_shard_modsum_kernel(dev, w):
    """Kernel R1 (the cross-shard modular sum) against its plain version
    at the key switch's partials of n = 16384, and on a coefficient
    shard's rows."""
    rng = np.random.default_rng(w)
    for n in (16384, 4096):
        t = ntt.RnsNttTables.from_moduli(16384, [int(m) for m in (
            P.CoeffModulus.create(16384, BITS[6]))], dev)
        parts = _uniform(rng, t.values, (w, 2, 2), n, dev)
        _same(shard.shard_modsum(parts, t), shard.shard_modsum_plain(parts,
                                                                    t))


@pytest.mark.parametrize("n,w", [(4096, 2), (16384, 2), (16384, 4),
                                 (131072, 2), (262144, 8)])
def test_mxu_shard_stages_on_the_card(dev, n, w):
    """Kernel J's stages on a rank's per-shard tables (column blocks
    (A, B/w) and row blocks (A/w, B)) against their plain version, down
    to the smallest blocks its tiles take (32 a side: n = 4096 over 2,
    16384 over 4); any words into the stages that reduce them."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [55, 60])]
    rng = np.random.default_rng(n + w)
    for i in range(w):
        mxu = [ntt_mxu.make_shard_tables(n, q, dev, w, i) for q in moduli]
        ptrs = ntt_mxu.pointer_table(mxu, dev)
        a, b = mxu[0].a, mxu[0].b
        for stage, shape in (("forward_left", (a, b // w)),
                             ("forward_right", (a // w, b)),
                             ("inverse_right", (a // w, b)),
                             ("inverse_left", (a, b // w))):
            if ntt_mxu.STAGES[stage][3]:
                x = _words(rng, (1, len(moduli)) + shape, dev)
            else:
                x = _uniform(rng, moduli, (1,), shape[0] * shape[1], dev) \
                    .reshape((1, len(moduli)) + shape)
            _same(ntt_mxu.rns_mxu_stage(x, mxu, ptrs, stage),
                  ntt_mxu.mxu_stage_plain(x, mxu, stage))


def test_sharded_regimes_on_the_card(dev):
    """The limb- and coefficient-sharded BFV mult+relin at n = 4096 in two
    gloo ranks sharing the card (parallel/sharding.py): the gathered words
    are the CPU evaluator's, and R1 and J ran."""
    from troy_tpu_torch.parallel import sharding, spmd
    n = 4096
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(13),
                        host_sampling=True)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(14), host_sampling=True)
    be = P.BatchEncoder(ctx)
    c = enc.encrypt_symmetric(be.encode(np.arange(n, dtype=np.uint64)
                                        % be.plain_modulus))
    rlk = kg.create_relin_keys()
    ev = P.Evaluator(ctx)
    want = interop.words(ev.relinearize(ev.multiply(c, c), rlk))
    spec = {"contexts": {"bfv": {"scheme": "bfv", "n": n,
                                 "q": list(ctx.key_context_data.coeff_values),
                                 "t": int(be.plain_modulus)}},
            "keys": {"rlk": interop.words(rlk)},
            "jobs": [{"name": regime, "regime": f"{regime}_multiply_relin",
                      "context": "bfv", "key": "rlk",
                      "inputs": [interop.words(c)] * 2}
                     for regime in ("limb", "coeff")]}
    ranks = sharding.spawn(spmd.run_jobs, 2, "gloo", "cuda", (spec,),
                           timeout_s=300)
    for regime in ("limb", "coeff"):
        np.testing.assert_array_equal(ranks[0]["results"][regime]["out"],
                                      want)
    assert all(r["launches"]["R1_shard_modsum"] > 0 for r in ranks)
    assert all(r["launches"]["J_ntt_mxu"] > 0 for r in ranks)


@pytest.mark.parametrize("X,I,Y,C", [(1, 64, 52, 2), (1, 8, 16, 2),
                                     (3, 5, 13, 2), (2, 127, 5, 4),
                                     (1, 63, 6, 3), (1, 1, 1, 1)])
@pytest.mark.parametrize("n", [64, 4096])
def test_tiled_tile_contract_kernel(dev, n, X, I, Y, C):
    """P1's tiled kernel at ragged y tiles (Y not a multiple of 4), every
    component count, I across the 63-term fold, and a ring shorter than a
    block of coefficients (n = 64): the plain version's words, one
    launch."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60, 60, 60])][:2]
    q = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n + X + I + Y + C)
    a = _uniform(rng, moduli, (X, I, C), n, dev)
    w = _uniform(rng, moduli, (I, Y), n, dev)
    _kernels.reset_launch_counts()
    got = tiles.tile_contract(a, w, q)
    assert _kernels.launch_counts()["P1_tile_contract"] == 1
    _same(got, tiles.tile_contract_plain(a, w, q))


@pytest.mark.parametrize("n", [64, 512, 1024, 4096, 16384])
@pytest.mark.parametrize("bits", [[60, 40, 40, 40, 40, 60], [40, 40, 40]])
def test_ntt_forward_digits_kernel(dev, n, bits):
    """AF (F's digits in A's first pass) against F's digits then A's
    forward and against its plain version, on the target's words and on
    any u64 words: one AF launch and no F launch."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    used = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n + len(bits))
    target = _uniform(rng, moduli[:-1], (2,), n, dev)
    words = interop.to_torch(rng.integers(0, 2 ** 64, (3, n),
                                          dtype=np.uint64), dev)
    for x in (target, words):
        _kernels.reset_launch_counts()
        got = ntt.rns_ntt_forward_digits(x, used)
        counts = _kernels.launch_counts()
        assert (counts["AF_ntt_digits"], counts["F_keyswitch"]) == (1, 0)
        _same(got, ntt.rns_ntt_forward(keyswitch.keyswitch_digits(x, used),
                                       used))
        _same(got, ntt.ntt_forward_digits_plain(x, used))


DIVIDE_USES = {"rescale": rns.RESCALE, "keyswitch": rns.KEYSWITCH,
               "bgv_mod_switch": rns.BGV_MOD_SWITCH,
               "bgv_keyswitch": rns.BGV_KEYSWITCH}


@pytest.mark.parametrize("use", list(DIVIDE_USES))
@pytest.mark.parametrize("n", [64, 1024, 16384, 32768, 131072, 262144])
def test_ntt_forward_divide_kernel(dev, n, use):
    """K' (K'-BGV) in A's forward passes against its plain version (K''s
    temps, A's lazy forward, K''s finish) with no accumulator, onto (c0,
    c1) and onto the c0 of each pair of a batch: one launch of its own
    counter and none of K''s. n = 64: one pass; 1024-32768: both passes on
    compiled geometries; 131072: a run-time last pass; 262144: both
    run-time."""
    entries = DIVIDE_USES[use]
    bgv = use.startswith("bgv")
    bits = BITS[6] if n <= 32768 else [55, 55, 60]
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    key = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
    k = key.k - 1
    t, p = key.slice(0, k), moduli[k]
    tt = int(P.PlainModulus.batching(n, 20 if n <= 32768 else 30))
    consts = (keyswitch.bgv_divide_consts(t, p, tt) if bgv
              else keyswitch.divide_round_consts(t, p))
    rng = np.random.default_rng(n + len(use))
    s = 4
    x = _uniform(rng, moduli, (s,), n, dev)
    last = _uniform(rng, [p], (s,), n, dev)[:, 0]
    counter = _kernels.KERNELS[entries[2]]
    for acc, group in ((None, None),
                       (_uniform(rng, t.values, (2,), n, dev), None),
                       (_uniform(rng, t.values, (2, 1), n, dev), 2)):
        _kernels.reset_launch_counts()
        got = rns.ntt_forward_divide(entries[2], x, last, t, consts, acc,
                                     group)
        counts = _kernels.launch_counts()
        assert counts[counter] == 1, counts
        assert not any(counts[kp] for kp in KP_KERNELS), counts
        _same(got, rns.ntt_forward_divide_plain(x, last, t, consts, acc,
                                                group, bgv))


def _crt_values(Q, rng):
    """CRT values around 0 and Q/2, and ones whose S = sum_j x_j / q_j
    lies within 2^-40 of a half-integer (frac(S) = (v mod Q) / Q)."""
    h = (Q - 1) // 2
    near = [h - int(rng.integers(0, 1 << 30)) * (Q >> 72) for _ in range(6)]
    near += [h + 1 + int(rng.integers(0, 1 << 30)) * (Q >> 72)
             for _ in range(6)]
    return [0, 1, -1, 2, -2, 12345, -12345, 1 << 40, -(1 << 40), h, -h,
            h + 1, Q - 1, Q - 2] + near


@pytest.mark.parametrize("n", [2, 8, 64, 1024, 2048, 16384, 32768, 262144])
def test_compose_kernel_every_width(dev, n):
    """O3 bit-equal to its plain version at k = 1, 2, 5, 9 and 16 limbs (W
    = 2 to 16 words), on random residues with the values around 0 and Q/2
    and next to S's half-integers in the first coefficients (as many as n
    holds)."""
    for bits in ([60], [60, 40], [60, 40, 40, 40, 40], [50] * 9, [60] * 16):
        q = [int(m) for m in P.CoeffModulus.create(n, bits)]
        level = ntt.RnsNttTables.from_moduli(n, q, dev)
        rt = embedding.make_rns_round_tables(level)
        rng = np.random.default_rng(n + len(bits))
        res = np.stack([rng.integers(0, qi, n, dtype=np.uint64) for qi in q])
        for i, v in enumerate(_crt_values(rt.total, rng)[:n]):
            res[:, i] = [v % qi for qi in q]
        x = interop.to_torch(res, dev)
        for inv_scale in (1.0, 2.0 ** -40):
            got = embedding.compose_centered(x, rt, inv_scale)
            torch.cuda.synchronize()
            assert torch.equal(got, embedding.compose_centered_plain(
                x, rt, inv_scale)), (bits, inv_scale)


@pytest.mark.parametrize("s,n", [(2, 64), (2, 512), (2, 1024), (2, 16384),
                                 (8, 16384), (16, 16384), (2, 32768),
                                 (2, 131072), (2, 262144)])
def test_ntt_inverse_divide_kernel(dev, s, n):
    """AFi (F's divide in A's last inverse pass) against its plain version
    and against A's inverse then F's divide, with no accumulator, onto (c0,
    c1), onto c0, onto the c0 of each pair and onto one c0 for all pairs:
    one AFi launch, none of A's or F's. n = 64, 512: the fused pass alone
    over whole rows; 1024-131072: a compiled fused pass; 262144: run
    time."""
    bits = BITS[6] if n <= 32768 else [55, 55, 60]
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    rows = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
    k = rows.k - 1
    consts = keyswitch.divide_round_consts(rows.slice(0, k), moduli[k])
    rng = np.random.default_rng(n + s)
    x = _uniform(rng, moduli, (s,), n, dev)
    data = moduli[:k]
    for acc, group in ((None, None), (_uniform(rng, data, (2,), n, dev), None),
                       (_uniform(rng, data, (1,), n, dev), None),
                       (_uniform(rng, data, (s // 2, 1), n, dev), 2),
                       (_uniform(rng, data, (1, 1), n, dev), 2)):
        if acc is not None and group is None and acc.shape[0] > s:
            continue
        _kernels.reset_launch_counts()
        got = keyswitch.ntt_inverse_divide_round(x, rows, consts, acc, group)
        counts = _kernels.launch_counts()
        assert (counts["AFi_keyswitch_intt"], counts["A_ntt"],
                counts["F_keyswitch"]) == (1, 0, 0), counts
        _same(got, keyswitch.ntt_inverse_divide_round_plain(
            x, rows, consts, acc, group))
        _same(got, keyswitch.divide_round_last(
            ntt.rns_ntt_inverse(x, rows), consts, acc, group))


def test_bfv_key_switch_launches_afi_not_f(dev):
    """A BFV mult+relin and rotate_rows on A's route: one AFi launch a key
    switch, no launch of F's divide (troy_keyswitch_divide_round)."""
    n = 4096
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, BITS[6])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=dev)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(9), host_sampling=True)
    rlk, gk = kg.create_relin_keys(), kg.create_galois_keys(steps=[1])
    be, ev = P.BatchEncoder(ctx), P.Evaluator(ctx)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(10))
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, be.plain_modulus, n, dtype=np.uint64)
            for _ in range(2))
    ca, cb = enc.encrypt_symmetric(be.encode(a)), enc.encrypt_symmetric(
        be.encode(b))
    for op, want in (
            (lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
             a.astype(object) * b % be.plain_modulus),
            (lambda: ev.rotate_rows(ca, 1, gk), None)):
        _kernels.reset_launch_counts()
        out = op()
        torch.cuda.synchronize()
        counts = _kernels.entry_launch_counts()
        assert counts["troy_ntt_inverse_keyswitch"] == 1, counts
        assert counts["troy_keyswitch_divide_round"] == 0, counts
        if want is not None:
            got = be.decode(P.Decryptor(ctx, kg.secret_key).decrypt(out))
            np.testing.assert_array_equal(got.astype(object), want)


# the fused decrypt's shapes (comps, k, n): a decrypt and a batch of three
# at n = 1024 and 16384, the app's decrypt_many of 52 conv outputs, SEAL's
# data level at n = 32768, and the caps: the most limbs a block holds at
# n = 512 (whole rows), 16384 and 131072, and C's 20 at n = 64 (whole
# rows)
DECRYPT_SHAPES = [(1, 5, 1024), (3, 5, 1024), (52, 2, 1024), (1, 5, 16384),
                  (3, 5, 16384), (52, 2, 16384), (1, 15, 32768), (2, 20, 64),
                  (1, 5, 512), (1, 20, 16384), (1, 10, 131072)]


def _decrypt_level(n, k, dev):
    """The tables of k primes at n, X's converter to a 20-bit t (30-bit
    above n = 16384) and the BFV tool with that t."""
    bits = [60] + [40] * (k - 1) if k <= 16 else [36] * k
    q = tuple(int(m) for m in P.CoeffModulus.create(n, bits))
    t = int(P.PlainModulus.batching(n, 20 if n <= 16384 else 30))
    host = make_rns_tool(n, q, t)
    tables = ntt.RnsNttTables.from_moduli(n, q, dev, use_mxu=False)
    bsk = ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, dev,
                                       use_mxu=False)
    return (tables, rns.ExactConverter.build(host.conv_q_to_t, dev),
            rns.DeviceRnsTool.build(host, tables, bsk), t)


@pytest.mark.parametrize("s,k,n", DECRYPT_SHAPES)
def test_ntt_inverse_decrypt_kernels(dev, s, k, n):
    """AXi and ACi (the decrypt's conversions in A's last inverse pass)
    against their plain versions and against A's inverse then X, or C and
    E's rounding (where their kernels take the level: past 17 limbs E's
    Bsk is past its 20): one launch of the fused entry a call, none of A,
    X, C or E."""
    tables, conv, tool, t = _decrypt_level(n, k, dev)
    rng = np.random.default_rng(n + k + s)
    x = _uniform(rng, tables.values, (s,), n, dev)
    want_x = rns.decrypt_mod_t(ntt.rns_ntt_inverse(x, tables), conv, 7)
    _same(want_x, rns.ntt_inverse_decrypt_mod_t_plain(x, tables, conv, 7))
    want_c = rns.ntt_inverse_decrypt_scale_and_round_plain(x, tool)
    if tool.nb + 1 <= rns.MAX_KERNEL_LIMBS:    # E's kernel takes the level
        _same(want_c, rns.decrypt_scale_and_round(
            ntt.rns_ntt_inverse(x, tool.q), tool))
    _kernels.reset_launch_counts()
    got_x = rns.ntt_inverse_decrypt_mod_t(x, tables, conv, 7)
    got_c = rns.ntt_inverse_decrypt_scale_and_round(x, tool)
    counts = _kernels.launch_counts()
    assert (counts["AXi_decrypt_intt"], counts["ACi_decrypt_intt"],
            counts["A_ntt"], counts["X_exact_convert"],
            counts["C_base_convert"], counts["E_behz"]) == (
                1, 1, 0, 0, 0, 0), counts
    _same(got_x, want_x)
    _same(got_c, want_c)
    for inv_cf in (1, t - 1):
        _same(rns.ntt_inverse_decrypt_mod_t(x, tables, conv, inv_cf),
              rns.decrypt_mod_t(ntt.rns_ntt_inverse(x, tables), conv, inv_cf))


# (comps, k, log2 n) -> the library's plans of AXi's and ACi's pass (one
# plan: the same for both), the table that test_torch_inverse_decrypt.py
# holds its emulation of plan_inverse to: (log2 of a line's words, of a
# block's columns, rows a block holds, log2 of a tile's threads, blocks)
DECRYPT_PLANS = {(1, 5, 14): (7, 0, 5, 4, 128), (3, 5, 14): (7, 2, 5, 6, 96),
                 (52, 2, 14): (7, 2, 2, 6, 1664),
                 (1, 15, 15): (7, 1, 15, 5, 128),
                 (1, 21, 14): ((7, 0, 20, 4, 256), (7, 0, 21, 4, 128)),
                 (1, 5, 9): (9, 0, 5, 6, 1), (1, 6, 9): (9, 0, 5, 6, 2),
                 (1, 2, 18): (9, 0, 2, 6, 512)}


def test_ntt_inverse_decrypt_plans(dev):
    """troy_ntt_inverse_decrypt_plan answers the table's plans; a level
    whose k rows one block cannot hold is refused before any launch, and
    its decrypt takes the composition (rns.decrypt_fused)."""
    for (comps, k, log_n), plans in DECRYPT_PLANS.items():
        if not isinstance(plans[0], tuple):
            plans = (plans, plans)
        assert tuple(ntt.inverse_decrypt_plan(comps, k, 1 << log_n, bfv)
                     for bfv in (False, True)) == plans, (comps, k, log_n)
    tables, conv, tool, _ = _decrypt_level(512, 6, dev)
    x = torch.zeros((1, 6, 512), dtype=torch.int64, device=dev)
    _kernels.reset_launch_counts()
    for fn in (lambda: rns.ntt_inverse_decrypt_mod_t(x, tables, conv),
               lambda: rns.ntt_inverse_decrypt_scale_and_round(x, tool)):
        with pytest.raises(ValueError, match="cannot hold 6 limbs"):
            fn()
    assert sum(_kernels.launch_counts().values()) == 0
    assert not rns.decrypt_fused(tables, True)
    assert not rns.decrypt_fused(tables, False)
    assert rns.decrypt_fused(tables.slice(0, 5), False)


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_decrypt_launches_the_fused_entry(dev, scheme):
    """A decrypt and a decrypt_many of 4 on A's route at n = 4096: one
    fused call each, no X, C or E rounding launch; the CPU's words."""
    n = 4096
    words = {}
    for device in (dev, "cpu"):
        parms = P.EncryptionParameters(
            scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, BITS[6])),
            plain_modulus=P.PlainModulus.batching(n, 20))
        ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                          device=device)
        kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(41),
                            host_sampling=True)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(42))
        be = P.BatchEncoder(ctx)
        cts = enc.encrypt_symmetric_many(
            [be.encode(np.arange(n, dtype=np.uint64) * i % be.plain_modulus)
             for i in range(4)])
        dec = P.Decryptor(ctx, kg.secret_key)
        entry = ("troy_ntt_inverse_decrypt_bfv" if scheme == "bfv"
                 else "troy_ntt_inverse_decrypt_bgv")
        out = []
        for call in (lambda: [dec.decrypt(cts[0])],
                     lambda: dec.decrypt_many(cts)):
            _kernels.reset_launch_counts()
            out += call()
            if device != "cpu":
                torch.cuda.synchronize()
                counts = _kernels.entry_launch_counts()
                assert counts[entry] == 1, counts
                assert (counts["troy_exact_convert"],
                        counts["troy_base_convert"],
                        counts["troy_behz_decrypt_round"]) == (0, 0, 0)
        words[str(device)] = [interop.words(p) for p in out]
    np.testing.assert_array_equal(np.asarray(words[str(dev)]),
                                  np.asarray(words["cpu"]))


# --------------------------------------------------------------------------
# G' and P2 folded into A's passes (AGp, AP2i); P2's own kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 512, 1024, 16384])
@pytest.mark.parametrize("t_bits", [20, 59])
def test_ntt_forward_lift_kernel(dev, n, t_bits):
    """AGp (G''s lift in A's first pass) against G' then A's forward and
    against its plain version, with the centred threshold, threshold t and
    a correction factor, one and three source rows: one AGp launch and no
    G' launch a call."""
    bits = [60, 40, 40, 40, 40, 60]
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)][:5]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    t = int(P.PlainModulus.batching(max(n, 1024), t_bits))
    Q = 1
    for v in moduli:
        Q *= v
    rng = np.random.default_rng(n + t_bits)
    for lead in ((), (3,)):
        m = interop.to_torch(rng.integers(0, t, size=lead + (n,),
                                          dtype=np.uint64), dev)
        for threshold, cf in (((t + 1) >> 1, 1), (t, 1),
                              ((t + 1) >> 1, 4321)):
            _kernels.reset_launch_counts()
            got = ntt.rns_ntt_forward_lift(m, tables, t, threshold, Q, cf)
            counts = _kernels.launch_counts()
            assert (counts["AGp_ntt_lift"], counts["Gp_plain_lift"]) == (1, 0)
            _same(got, ntt.rns_ntt_forward(
                poly.plain_lift(m, tables, t, threshold, Q, cf), tables))
            _same(got, ntt.ntt_forward_lift_plain(m, tables, t, threshold, Q,
                                                  cf))


@pytest.mark.parametrize("n", [64, 1024, 16384, 32768])
@pytest.mark.parametrize("s1,s2", [(2, 2), (1, 3), (4, 4), (3, 2)])
def test_ntt_inverse_pair_convolve_kernel(dev, n, s1, s2):
    """AP2i (P2 in A's first inverse pass) against P2 then A's inverse and
    against its plain version, over q u Bsk with lazy words (4q - 1 among
    them): one AP2i launch and no P2 launch a call."""
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=P.Modulus(1 << 41))
    qb = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                     device=dev).first_context_data.rns.q_bsk
    rng = np.random.default_rng(n + 10 * s1 + s2)
    lazy = [4 * v for v in qb.values]
    a = _uniform(rng, lazy, (2, s1), n, dev)
    w = _uniform(rng, lazy, (5, s2), n, dev)
    a[..., :2] = interop.to_torch(np.array(lazy, dtype=np.uint64) - 1,
                                  dev).reshape(-1, 1)
    _kernels.reset_launch_counts()
    got = ntt.rns_ntt_inverse_pair_convolve(a, w, qb)
    counts = _kernels.launch_counts()
    assert (counts["AP2i_pair_intt"], counts["P2_pair_convolve"]) == (1, 0)
    _same(got, ntt.rns_ntt_inverse(tiles.tile_pair_convolve(a, w, qb), qb))
    _same(got, ntt.ntt_inverse_pair_convolve_plain(a, w, qb))


@pytest.mark.parametrize("n", [64, 16384])
@pytest.mark.parametrize("s1", [1, 2, 3, 4])
@pytest.mark.parametrize("s2", [1, 2, 3, 4])
def test_tile_pair_convolve_every_size(dev, n, s1, s2):
    """P2's kernel, compiled for each (s1, s2), against its plain version
    over 3 rows, with a ragged last y tile (Y = 6) and X = 2."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60, 40, 50])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n + 4 * s1 + s2)
    lazy = [4 * v for v in moduli]
    a = _uniform(rng, lazy, (2, s1), n, dev)
    w = _uniform(rng, lazy, (6, s2), n, dev)
    _same(tiles.tile_pair_convolve(a, w, tables),
          tiles.tile_pair_convolve_plain(a, w, tables))


@pytest.mark.parametrize("n", [64, 512, 1024, 16384, 32768, 131072])
@pytest.mark.parametrize("twisted", [True, False])
def test_ntt_forward_round_kernel(dev, n, twisted):
    """AO2p (O2's rounding in A's first pass) against O2 then A's forward
    and against its plain version, with the slot encode's untwist or on
    real words, at scales 2^40 and 2^100 (the exponent path) and on the
    ties and zeros: one AO2p launch and no O2 launch a call."""
    moduli = [int(m) for m in P.CoeffModulus.create(
        n, [60, 40, 40, 40, 40, 60])][:5]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rt = embedding.make_rns_round_tables(tables)
    emb = embedding.make_embed_tables(n, dev)
    rng = np.random.default_rng(n + twisted)
    if twisted:
        u = torch.from_numpy((rng.uniform(-1, 1, n)
                              + 1j * rng.uniform(-1, 1, n)) * 2.0 ** -7
                             ).to(dev)
        untwist = emb.untwist
    else:
        u = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 10).to(dev)
        u[:4] = torch.tensor([0.5, -2.5, 3.5, -0.0], dtype=torch.float64)
        untwist = None
    for scale in (2.0 ** 40, 2.0 ** 100, 1.0):
        _kernels.reset_launch_counts()
        got = embedding.rns_ntt_forward_round(u, untwist, scale, rt, tables)
        counts = _kernels.launch_counts()
        assert (counts["AO2p_ntt_round"], counts["O2_ckks_round"]) == (1, 0)
        rows = embedding.untwist_round_to_rns(u, scale, emb, rt) if twisted \
            else embedding.round_to_rns(u, scale, rt)
        _same(got, ntt.rns_ntt_forward(rows, tables))
        _same(got, embedding.ntt_forward_round_plain(u, untwist, scale, rt,
                                                     tables))


@pytest.mark.parametrize("use_mxu", [False, True])
def test_ckks_encodes_route_by_tables(dev, use_mxu):
    """The slot encode and encode_polynomial on A's route are O1 and one
    AO2p call, on J's (use_mxu=True) O2 and J; both give the CPU run's
    words."""
    n = 4096
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                      use_mxu=use_mxu, device=dev)
    cpu = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    rng = np.random.default_rng(7)
    values = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    coeffs = rng.uniform(-1, 1, n)
    for fn in (lambda e: e.encode(values, 2.0 ** 40),
               lambda e: e.encode_polynomial(coeffs, 2.0 ** 40)):
        _kernels.reset_launch_counts()
        got = fn(P.CKKSEncoder(ctx))
        counts = _kernels.launch_counts()
        want = (0, 1, 1) if use_mxu else (1, 0, 0)
        assert (counts["AO2p_ntt_round"], counts["O2_ckks_round"],
                int(counts["J_ntt_mxu"] > 0)) == want, counts
        _same(got.data, fn(P.CKKSEncoder(cpu)).data)


K_SHAPES = [(2, 5, 16384), (2, 2, 16384), (2, 15, 32768), (2, 3, 262144),
            (1, 2, 64), (3, 6, 2), (3, 17, 1024), (2, 18, 1024),
            (5, 21, 64), (1, 64, 64)]


@pytest.mark.parametrize("s,rows,n", K_SHAPES)
def test_mod_switch_divide_kernel(dev, s, rows, n):
    """K (the BFV mod switch's divide by the last prime) against its plain
    version at phase 35's shapes, at k = 1, at even and odd limb counts
    (full limb groups of two, and a last group of one) up to 20, with odd
    component counts and n = 2, with the last row
    at 0, p - 1 and p/2 +- 1: one K launch a call."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [50] * rows)] \
        if rows > 6 or n < 1024 \
        else [int(m) for m in P.CoeffModulus.create(
            n, [60, 40, 40, 40, 40, 60][:rows])]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(s * rows + n)
    x = _uniform(rng, moduli, (s,), n, dev)
    p = moduli[-1]
    turns = [0, p - 1, p // 2 - 1, p // 2, p // 2 + 1][:n]
    x[:, -1, :len(turns)] = interop.to_torch(np.array(turns, np.uint64), dev)
    consts = keyswitch.divide_round_consts(t.slice(0, rows - 1), p)
    _kernels.reset_launch_counts()
    got = keyswitch.divide_and_round_q_last(x, t)
    assert _kernels.launch_counts()["K_divide_round"] == 1
    _same(got, keyswitch.divide_round_last_plain(x, consts))


def _odd_word_view(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts one word past a 16-byte line."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() & 15 == 8
    return view


@pytest.mark.parametrize("with_acc", [False, True])
def test_divide_round_unaligned_operands(dev, with_acc):
    """K and F's divide on contiguous operands at an odd word offset (off
    the kernel's 16-byte loads): the wrapper copies them once and gives
    the plain version's words, one launch a call."""
    n, k = 4096, 5
    moduli = [int(m) for m in P.CoeffModulus.create(n, [50] * (k + 1))]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    consts = keyswitch.divide_round_consts(t.slice(0, k), moduli[-1])
    rng = np.random.default_rng(k + with_acc)
    x = _uniform(rng, moduli, (2,), n, dev)
    acc = _uniform(rng, moduli[:k], (2,), n, dev) if with_acc else None
    want = keyswitch.divide_round_last_plain(x, consts, acc)
    _kernels.reset_launch_counts()
    got = keyswitch.divide_round_last(
        _odd_word_view(x), consts,
        _odd_word_view(acc) if with_acc else None)
    assert _kernels.launch_counts()["F_keyswitch"] == 1
    _same(got, want)
    if not with_acc:
        _kernels.reset_launch_counts()
        _same(keyswitch.divide_and_round_q_last(_odd_word_view(x), t), want)
        assert _kernels.launch_counts()["K_divide_round"] == 1
    # the C entry point itself refuses them, and launches nothing
    _kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="troy_keyswitch_divide_round"):
        _kernels.launch("troy_keyswitch_divide_round", x.get_device(),
                        torch.empty_like(want), _odd_word_view(x),
                        _odd_word_view(acc) if with_acc else None, 2,
                        2 if with_acc else 0, 2, 1, k, n.bit_length() - 1,
                        consts)
    assert _kernels.launch_counts()["F_keyswitch"] == 0


@pytest.mark.parametrize("layout", ["c0c1", "c0", "pairs", "one", "none"])
@pytest.mark.parametrize("k", [5, 16, 17])
def test_divide_round_accumulator_layouts(dev, layout, k):
    """F's divide on K's kernel (J's route, the coefficient-sharded key
    switch) in the accumulator layouts its callers use, against its plain
    version: onto (c0, c1), onto c0, onto c0 of each pair with a row each
    (the batched fold) or one row for all (the hoisted path), and none."""
    n = 4096
    moduli = [int(m) for m in P.CoeffModulus.create(n, [50] * (k + 1))]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    consts = keyswitch.divide_round_consts(t.slice(0, k), moduli[-1])
    rng = np.random.default_rng(k)
    s = 2 if layout in ("c0c1", "c0") else 8
    x = _uniform(rng, moduli, (s,), n, dev)
    acc, group = {
        "c0c1": (_uniform(rng, moduli[:k], (2,), n, dev), None),
        "c0": (_uniform(rng, moduli[:k], (1,), n, dev), None),
        "pairs": (_uniform(rng, moduli[:k], (4, 1), n, dev), 2),
        "one": (_uniform(rng, moduli[:k], (1, 1), n, dev), 2),
        "none": (None, None)}[layout]
    _kernels.reset_launch_counts()
    got = keyswitch.divide_round_last(x, consts, acc, group)
    assert _kernels.launch_counts()["F_keyswitch"] == 1
    _same(got, keyswitch.divide_round_last_plain(x, consts, acc, group))


# --------------------------------------------------------------------------
# B redesigned: the convolution, strided operands, the addend; K'' on K's
# design
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 16384])
@pytest.mark.parametrize("s1,s2,lead", [(2, 2, ()), (2, 3, ()), (3, 3, ()),
                                        (1, 4, ()), (4, 4, ()), (5, 2, ()),
                                        (2, 2, (3,)), (3, 2, (2, 2))])
def test_dyadic_convolve_kernel(dev, n, s1, s2, lead):
    """The ciphertext product's convolution in one B launch (sizes 1-4 a
    side compiled, 5 on the loop), lazy words below 4q where at most four
    terms meet, with leading batch axes, against its plain version."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [60, 40, 40, 60])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(s1 * 10 + s2 + n)
    bound = [4 * q for q in moduli] if min(s1, s2) <= 4 else moduli
    a = _uniform(rng, bound, lead + (s1,), n, dev)
    b = _uniform(rng, bound, lead + (s2,), n, dev)
    _kernels.reset_launch_counts()
    got = ntt.dyadic_convolve(a, b, tables)
    assert _kernels.launch_counts()["B_dyadic_mac"] == 1
    _same(got, ntt.dyadic_convolve_plain(a, b, tables))
    if s1 == s2:
        _same(ntt.dyadic_convolve(a, a, tables),
              ntt.dyadic_convolve_plain(a, a, tables))
    if lead:
        both = torch.cat([a, b], dim=-3)                 # strided halves
        _same(ntt.dyadic_convolve(both[..., :s1, :, :], both[..., s1:, :, :],
                                  tables),
              ntt.dyadic_convolve_plain(a, b, tables))


@pytest.mark.parametrize("n", [64, 16384])
def test_dyadic_mac_strided_operands_and_addend(dev, n):
    """B's mac on the operands its callers hand it in place: a key's rows
    one level down (the level's primes and the special row), the secret
    key's powers and a public key at a level's rows, a strided addend
    (the decrypt's c0, each ciphertext's c0 of a batch); lazy one-term
    products broadcast over components and row groups."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, BITS[6])]
    full = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rng = np.random.default_rng(n)
    key = _uniform(rng, moduli, (5, 2), n, dev)
    for k in (5, 3, 1):
        used = full.select(keyswitch.used_limbs(k, 6))
        t_hat = _uniform(rng, used.values, (k,), n, dev)
        _same(ntt.dyadic_mac(t_hat, key[:k], used),
              ntt.dyadic_mac_plain(t_hat.unsqueeze(1),
                                   ntt.key_rows_plain(key[:k], k + 1), used))
        targets = _uniform(rng, used.values, (4, k), n, dev)
        _same(ntt.dyadic_mac_batched(key[:k], targets, used),
              ntt.dyadic_mac_plain(targets.transpose(0, 1).unsqueeze(2),
                                   ntt.key_rows_plain(key[:k], k + 1)
                                   .unsqueeze(1), used))
        level = full.slice(0, k)
        powers = _uniform(rng, moduli, (2,), n, dev)
        comps = _uniform(rng, level.values, (3, 3), n, dev)
        _kernels.reset_launch_counts()
        got = ntt.dyadic_mac(comps[0, 1:], powers[:, :k], level,
                             addend=comps[0, 0])
        assert _kernels.launch_counts()["B_dyadic_mac"] == 1
        _same(got, ntt.dyadic_mac_plain(comps[0, 1:], powers[:, :k], level,
                                        comps[0, 0]))
        _same(ntt.dyadic_mac_batched(powers[:, :k].unsqueeze(1),
                                     comps[:, 1:], level,
                                     addend=comps[:, :1]),
              ntt.dyadic_mac_plain(comps[:, 1:].transpose(0, 1).unsqueeze(2),
                                   powers[:, :k].unsqueeze(1).unsqueeze(1),
                                   level, comps[:, :1]))
        # one lazy term: row groups (2, k), and u over a public key's two
        # components at the level's rows
        u = _uniform(rng, [4 * q for q in level.values], (1, 2), n, dev)
        _same(ntt.dyadic_mac(u, powers[:, :k].unsqueeze(0), level),
              ntt.dyadic_mac_plain(u, powers[:, :k].unsqueeze(0), level))
        _same(ntt.dyadic_mac(u[:, 0], powers[:, :k].unsqueeze(0), level),
              ntt.dyadic_mac_plain(u[:, :1], powers[:, :k].unsqueeze(0),
                                   level))


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_mult_relin_launches_b_twice(dev, scheme):
    """A mult+relin launches B twice (the convolution, the key switch's
    inner product) and a decrypt once with no D launch (c0 in B's sum);
    the CPU run's words."""
    n = 4096
    words = {}
    for device in (dev, "cpu"):
        extra = {} if scheme == "ckks" else {
            "plain_modulus": P.PlainModulus.batching(n, 20)}
        ctx = P.HeContext(P.EncryptionParameters(
            scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, BITS[6])), **extra),
            sec_level=P.SecurityLevel.none, device=device)
        kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(51),
                            host_sampling=True)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(52), host_sampling=True)
        rlk = kg.create_relin_keys()
        ev, dec = P.Evaluator(ctx), P.Decryptor(ctx, kg.secret_key)
        if scheme == "ckks":
            encoder = P.CKKSEncoder(ctx)
            pts = [encoder.encode(np.linspace(-1, 1, n // 2) * (i + 1),
                                  2.0 ** 40) for i in range(2)]
        else:
            encoder = P.BatchEncoder(ctx)
            pts = [encoder.encode(np.arange(n, dtype=np.uint64) * (i + 1)
                                  % encoder.plain_modulus) for i in range(2)]
        ca, cb = (enc.encrypt_symmetric(p) for p in pts)
        _kernels.reset_launch_counts()
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        if device != "cpu":
            torch.cuda.synchronize()
            assert _kernels.launch_counts()["B_dyadic_mac"] == 2
        _kernels.reset_launch_counts()
        plain = dec.decrypt(rel)
        if device != "cpu":
            torch.cuda.synchronize()
            counts = _kernels.launch_counts()
            assert (counts["B_dyadic_mac"], counts["D_rns_elementwise"]) \
                == (1, 0), counts
        words[str(device)] = (interop.words(rel), interop.words(plain))
    for got, want in zip(words[str(dev)], words["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [64, 16384])
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("layout", ["none", "c0c1", "c0", "pairs", "one"])
def test_bgv_coeff_divide_kernel_layouts(dev, n, k, layout):
    """K'' on K's design (limb groups of two, 16-byte loads) in every
    accumulator layout, with the last row at 0, 1, p - 1 and p/2 +- 1, and
    on operands at an odd word offset (an aligned copy), one launch a
    call."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [50] * (k + 1))]
    t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    tt = int(P.PlainModulus.batching(max(n, 1024), 20))
    consts = keyswitch.bgv_divide_consts(t.slice(0, k), moduli[-1], tt)
    rng = np.random.default_rng(n + k)
    s = 2 if layout in ("none", "c0c1", "c0") else 8
    x = _uniform(rng, moduli, (s,), n, dev)
    p = moduli[-1]
    turns = [0, 1, p - 1, p // 2 - 1, p // 2, p // 2 + 1][:n]
    x[:, -1, :len(turns)] = interop.to_torch(np.array(turns, np.uint64), dev)
    acc, group = {
        "none": (None, None),
        "c0c1": (_uniform(rng, moduli[:k], (2,), n, dev), None),
        "c0": (_uniform(rng, moduli[:k], (1,), n, dev), None),
        "pairs": (_uniform(rng, moduli[:k], (4, 1), n, dev), 2),
        "one": (_uniform(rng, moduli[:k], (1, 1), n, dev), 2)}[layout]
    want = keyswitch.bgv_divide_last_plain(x, consts, acc, group)
    for odd in (False, True):
        xs = _odd_word_view(x) if odd else x
        accs = _odd_word_view(acc) if odd and acc is not None else acc
        _kernels.reset_launch_counts()
        got = keyswitch.bgv_divide_last(xs, consts, accs, group)
        assert _kernels.launch_counts()["Kpp_bgv_coeff"] == 1
        _same(got, want)


# --------------------------------------------------------------------------
# DG and G on D's grid, AO4p
# --------------------------------------------------------------------------

EMBED_T = {"t786433": 786433, "t20": 20, "t59": 59, "t2^41": 1 << 41}


def _embed_level(n, bits, t_name, dev):
    moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    t = EMBED_T[t_name]
    t = t if t > 64 else int(P.PlainModulus.batching(1024, t))
    Q = 1
    for q in moduli:
        Q *= q
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    return tables, (t, Q % t, tuple((Q // t) % q for q in moduli))


def _embed_plain(rng, t, lead, n, dev):
    m = rng.integers(0, t, lead + (n,), dtype=np.uint64)
    edge = [0, t - 1, (t - 1) // 2, (t + 1) // 2][:n]
    m[..., :len(edge)] = edge
    return interop.to_torch(m, dev)


@pytest.mark.parametrize("n,bits", [(2, [60]), (1024, [60]),
                                    (16384, [60, 40, 40, 40, 40, 60])])
@pytest.mark.parametrize("t_name", list(EMBED_T))
def test_zero_embed_kernel(dev, n, bits, t_name):
    """DG's symmetric finish (one encryption in place, a batch of 3 into
    c0 with c1 copied) and public-key finish, with the edge words of m and
    of the operands, against their plain versions: one DG launch, no D or
    G launch, a call."""
    tables, args = _embed_level(n, bits, t_name, dev)
    rng = np.random.default_rng(n + len(bits))
    x, y, c1 = (_edge(rng, tables.values, (3,), n, dev) for _ in range(3))
    m = _embed_plain(rng, args[0], (3,), n, dev)
    calls = {
        "one": (lambda: poly.zero_sym_embed(
            x[0].clone(), y[0], m[0], *args, tables, out=None),
                lambda: poly.zero_sym_embed_plain(x[0], y[0], m[0], *args,
                                                  tables)),
        "batch": (lambda: _into_batch(x, y, m, c1, args, tables),
                  lambda: torch.stack([poly.zero_sym_embed_plain(
                      x, y, m, *args, tables), c1], dim=1)),
        "public": (lambda: poly.zero_asym_embed(x[:2], y[:2], m[0], *args,
                                                tables),
                   lambda: poly.zero_asym_embed_plain(x[:2], y[:2], m[0],
                                                      *args, tables))}
    for name, (run, plain) in calls.items():
        _kernels.reset_launch_counts()
        got = run()
        counts = _kernels.launch_counts()
        assert (counts["DG_zero_embed"], counts["D_rns_elementwise"],
                counts["G_plain_embed"]) == (1, 0, 0), (name, counts)
        _same(got, plain())
    inplace = x[0].clone()
    poly.zero_sym_embed(inplace, y[0], m[0], *args, tables, out=inplace)
    _same(inplace, poly.zero_sym_embed_plain(x[0], y[0], m[0], *args,
                                             tables))


def _into_batch(x, y, m, c1, args, tables):
    ct = torch.empty((x.shape[0], 2) + x.shape[1:], dtype=torch.int64,
                     device=x.device)
    poly.zero_sym_embed(x, y, m, *args, tables, out=ct[:, 0], c1=c1)
    return ct


@pytest.mark.parametrize("n,bits", [(2, [60]), (1024, [60]),
                                    (16384, [60, 40, 40, 40, 40, 60])])
@pytest.mark.parametrize("t_name", list(EMBED_T))
@pytest.mark.parametrize("subtract", [False, True])
def test_plain_embed_kernel_on_d_grid(dev, n, bits, t_name, subtract):
    """G on D's grid: m (n) onto c0 (k, n), a batch of 8, and into a new
    ciphertext of 3 components with c1 and c2 copied (add_plain's form),
    with the edge words, against the plain version: one G launch a call."""
    tables, args = _embed_level(n, bits, t_name, dev)
    rng = np.random.default_rng(7 * n + len(bits))
    c0 = _edge(rng, tables.values, (8,), n, dev)
    m = _embed_plain(rng, args[0], (8,), n, dev)
    data = _edge(rng, tables.values, (3,), n, dev)
    calls = {
        "one": (lambda: poly.bfv_plain_embed(m[0], c0[0], *args, tables,
                                             subtract),
                lambda: poly.bfv_multiply_add_plain(m[0], c0[0], *args,
                                                    tables, subtract)),
        "batch": (lambda: poly.bfv_plain_embed(m, c0, *args, tables,
                                               subtract),
                  lambda: poly.bfv_multiply_add_plain(m, c0, *args, tables,
                                                      subtract)),
        "ciphertext": (lambda: poly.bfv_plain_embed_c0(data, m[0], *args,
                                                       tables, subtract),
                       lambda: torch.cat([poly.bfv_multiply_add_plain(
                           m[0], data[0], *args, tables,
                           subtract).unsqueeze(0), data[1:]]))}
    for name, (run, plain) in calls.items():
        _kernels.reset_launch_counts()
        got = run()
        counts = _kernels.launch_counts()
        assert counts["G_plain_embed"] == 1 and sum(counts.values()) == 1, \
            (name, counts)
        _same(got, plain())


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_add_plain_is_one_launch(dev, scheme):
    """add_plain and sub_plain: one G (BFV) or D (CKKS, BGV after its lift)
    launch writes c0 and copies c1, and the words are the CPU run's."""
    words = {}
    for device in (dev, "cpu"):
        n = 1024
        extra = {} if scheme == "ckks" else {
            "plain_modulus": P.PlainModulus.batching(n, 20)}
        parms = P.EncryptionParameters(
            scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
            **extra)
        ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                          device=device)
        kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(31))
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=prng.seed_from_uint64(32))
        rng = np.random.default_rng(31)
        if scheme == "ckks":
            pt = P.CKKSEncoder(ctx).encode(rng.uniform(-1, 1, n // 2),
                                           2.0 ** 40)
        else:
            pt = P.BatchEncoder(ctx).encode(rng.integers(
                0, int(parms.plain_modulus), n, dtype=np.uint64))
        ct = enc.encrypt_symmetric(pt)
        ev = P.Evaluator(ctx)
        out = []
        for subtract in (False, True):
            _kernels.reset_launch_counts()
            r = ev.sub_plain(ct, pt) if subtract else ev.add_plain(ct, pt)
            counts = {k: v for k, v in _kernels.launch_counts().items() if v}
            if device is dev:
                want = {"G_plain_embed": 1} if scheme == "bfv" else (
                    {"D_rns_elementwise": 1} if scheme == "ckks" else
                    {"D_rns_elementwise": 1, "AGp_ntt_lift": 1})
                assert counts == want, counts
            out.append(interop.words(r))
        words[str(device)] = out
    for got, want in zip(words[str(dev)], words["cpu"]):
        np.testing.assert_array_equal(got, want)


def test_bfv_encryptions_launch_dg_not_g(dev):
    """A BFV encrypt, encrypt_symmetric and encrypt_symmetric_many(3) on
    A's route: I, A, B, A's inverse and one DG each; no D and no G."""
    n = 1024
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [60, 40, 40, 60])),
        plain_modulus=P.PlainModulus.batching(n, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=dev)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(41))
    enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                      seed=prng.seed_from_uint64(42))
    pt = P.BatchEncoder(ctx).encode(np.arange(n, dtype=np.uint64))
    for op in (lambda: enc.encrypt(pt), lambda: enc.encrypt_symmetric(pt),
               lambda: enc.encrypt_symmetric_many([pt] * 3)):
        _kernels.reset_launch_counts()
        op()
        counts = _kernels.launch_counts()
        assert (counts["DG_zero_embed"], counts["D_rns_elementwise"],
                counts["G_plain_embed"], counts["I_sampling"]) == \
            (1, 0, 0, 1), counts


@pytest.mark.parametrize("n", [64, 512, 1024, 2048, 16384, 32768, 131072])
@pytest.mark.parametrize("twisted", [True, False])
def test_ntt_forward_round_stats_kernel(dev, n, twisted):
    """AO4p against AO2p's words and O4's statistic (and their plain
    versions), bit for bit, with the untwist and on real words, at scales
    2^40, 2^55 and 2^100 and on the ties and zeros: one AO4p launch a call
    and no O4, no memset."""
    moduli = [int(m) for m in P.CoeffModulus.create(
        n, [60, 40, 40, 40, 40, 60])][:5]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev)
    rt = embedding.make_rns_round_tables(tables)
    emb = embedding.make_embed_tables(n, dev)
    rng = np.random.default_rng(3 * n + twisted)
    if twisted:
        u = torch.from_numpy((rng.uniform(-1, 1, n)
                              + 1j * rng.uniform(-1, 1, n)) * 2.0 ** -7
                             ).to(dev)
        untwist = emb.untwist
    else:
        u = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 10).to(dev)
        u[:4] = torch.tensor([0.5, -2.5, 3.5, -0.0], dtype=torch.float64)
        untwist = None
    for scale in (2.0 ** 40, 2.0 ** 55, 2.0 ** 100, 1.0):
        _kernels.reset_launch_counts()
        words, stat = embedding.rns_ntt_forward_round_stats(
            u, untwist, scale, rt, tables)
        counts = _kernels.launch_counts()
        assert (counts["AO4p_ntt_round_stats"],
                counts["O4_ckks_encode_stats"]) == (1, 0), counts
        _same(words, embedding.rns_ntt_forward_round(u, untwist, scale, rt,
                                                     tables))
        want_words, want_stat = embedding.ntt_forward_round_stats_plain(
            u, untwist, scale, rt, tables)
        _same(words, want_words)
        assert int(stat.view(torch.int64)) == \
            int(want_stat.view(torch.int64))
        if twisted:
            _, o4 = embedding.untwist_round_to_rns_stats(u, scale, emb, rt)
            assert int(stat.view(torch.int64)) == int(o4.view(torch.int64))
