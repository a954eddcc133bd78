"""troy's C++ fixtures replayed through troy_tpu_torch, on either device.

The files in tests/data/ (ref_bfv_n64_seed42.txt, ref_bfv_n64_seed42_ops.txt,
ref_bgv_ckks_ops.txt, ref_bfv_n4096_config1.txt, ref_rnstool_ops.txt,
ref_ckksrot_event.txt; each generator kept beside it) hold troy's own words
for seeded keys, encryptions and evaluator ops at n = 64 and 4096. Each
case below loads troy's raw arrays into the port's types through
``troy_tpu_torch.interop``, runs the op on ``device`` ("cpu": every
kernel's plain version; "cuda": the kernels) and returns its checks, a
list of ``Check(label, got, want, atol)``: ``verify`` holds each got to its
want word for word (atol 0) or within atol. tests/test_torch_*_vectors.py
run every case on the CPU; chip_smoke.py's phase 36 runs ``CASES`` on the
card. Imports torch, numpy and troy_tpu_torch, never JAX.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as rnd
from troy_tpu_torch.ops import ntt as dntt
from troy_tpu_torch.ops import rns as drns
from troy_tpu_torch.ops import keyswitch

DATA = pathlib.Path(__file__).resolve().parent.parent / "tests" / "data"
N = 64


class Check(NamedTuple):
    label: str
    got: object
    want: object
    atol: float = 0.0


def verify(checks: List[Check]) -> int:
    """Raise AssertionError naming the first check whose got differs from
    its want (word for word, or by more than its atol); else the count."""
    for c in checks:
        if c.atol:
            assert abs(c.got - c.want) <= c.atol, \
                f"{c.label}: {c.got} is not within {c.atol} of {c.want}"
        else:
            np.testing.assert_array_equal(np.asarray(c.got),
                                          np.asarray(c.want), err_msg=c.label)
    return len(checks)


# --------------------------------------------------------------------------
# the fixture files, parsed as the JAX package's suites parse them
# --------------------------------------------------------------------------

def _words(parts) -> np.ndarray:
    return np.array(parts[2:2 + int(parts[1])], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def seed42() -> dict:
    """ref_bfv_n64_seed42.txt: seeded keygen, batch encode, symmetric
    encrypt and decrypt (tests/test_reference_vectors.py ``vec``)."""
    out = {}
    for line in (DATA / "ref_bfv_n64_seed42.txt").read_text().splitlines():
        parts = line.split()
        if parts[0] in ("sk", "pt", "ct", "dec"):
            out[parts[0]] = _words(parts)
        elif parts[0] == "plain_modulus":
            out["t"] = int(parts[1])
        elif parts[0] == "coeff_modulus":
            out["q"] = [int(x) for x in parts[1:]]
        elif parts[0] == "ct_size":
            out["ct_size"] = int(parts[1])
            out["ct_ntt"] = bool(int(parts[3]))
    return out


def _load_ops(name: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """'<tag>_meta' lines: (size, NTT flag[, correction factor, scale]);
    '<tag>_rows' lines skipped; 'cr_elt' the Galois element; every other
    line 'name count words'."""
    raw, meta = {}, {}
    for line in (DATA / name).read_text().splitlines():
        parts = line.split()
        if parts[0].endswith("_meta"):
            vals = [int(parts[1]), bool(int(parts[2]))]
            if len(parts) > 4:
                vals += [int(parts[3]), float(parts[4])]
            meta[parts[0][:-5]] = tuple(vals)
        elif parts[0].endswith("_rows"):
            pass
        elif parts[0] == "cr_elt":
            meta["elt"] = int(parts[1])
        else:
            raw[parts[0]] = _words(parts)
    return raw, meta


@functools.lru_cache(maxsize=None)
def seed42_ops():
    """ref_bfv_n64_seed42_ops.txt: BFV multiply, relinearize, apply_galois
    and mod switch on troy's own keys and ciphertexts."""
    return _load_ops("ref_bfv_n64_seed42_ops.txt")


@functools.lru_cache(maxsize=None)
def bgv_ckks_ops():
    """ref_bgv_ckks_ops.txt: BGV and CKKS ops, encodings, encryptions."""
    return _load_ops("ref_bgv_ckks_ops.txt")


@functools.lru_cache(maxsize=None)
def ckksrot():
    """ref_ckksrot_event.txt: CKKS NTT-form rotation and conjugation, and
    BFV at t = 2^41."""
    return _load_ops("ref_ckksrot_event.txt")


@functools.lru_cache(maxsize=None)
def config1() -> dict:
    """ref_bfv_n4096_config1.txt: BFV n = 4096, two primes."""
    vecs = {}
    for line in (DATA / "ref_bfv_n4096_config1.txt").read_text().splitlines():
        parts = line.split()
        if parts[0] in ("t", "q"):
            vecs[parts[0]] = [int(x) for x in parts[1:]]
        else:
            vecs[parts[0]] = _words(parts)
    return vecs


@functools.lru_cache(maxsize=None)
def rnstool() -> Tuple[dict, tuple]:
    """ref_rnstool_ops.txt: troy's RNSTool steps on deterministic inputs;
    'sizes' is (k, |Bsk|, |Bsk u {m~}|)."""
    vecs, sizes = {}, None
    for line in (DATA / "ref_rnstool_ops.txt").read_text().splitlines():
        parts = line.split()
        if parts[0] == "sizes":
            sizes = tuple(int(x) for x in parts[1:])
        else:
            vecs[parts[0]] = _words(parts)
    return vecs, sizes


# --------------------------------------------------------------------------
# contexts (one per device), as the JAX suites build them
# --------------------------------------------------------------------------

def _context(device: str, scheme, n: int, q_bits, t=None):
    kwargs = {} if t is None else {"plain_modulus": t}
    parms = P.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, list(q_bits))),
        **kwargs)
    return P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device)


@functools.lru_cache(maxsize=None)
def bfv64(device: str):
    """BFV n = 64, q = {40,40,40}, t = PlainModulus.batching(64, 17)."""
    return _context(device, P.SchemeType.bfv, N, (40, 40, 40),
                    P.PlainModulus.batching(N, 17))


@functools.lru_cache(maxsize=None)
def bgv64(device: str):
    return _context(device, P.SchemeType.bgv, N, (40, 40, 40),
                    P.PlainModulus.batching(N, 17))


@functools.lru_cache(maxsize=None)
def ckks64(device: str):
    """CKKS n = 64, q = {50,30,50}."""
    return _context(device, P.SchemeType.ckks, N, (50, 30, 50))


@functools.lru_cache(maxsize=None)
def even_t64(device: str):
    """BFV n = 64, q = {60,60,60}, t = 2^41 (the app's t)."""
    return _context(device, P.SchemeType.bfv, N, (60, 60, 60),
                    P.Modulus(1 << 41))


@functools.lru_cache(maxsize=None)
def config1_context(device: str):
    return _context(device, P.SchemeType.bfv, 4096, (40, 40),
                    P.PlainModulus.batching(4096, 20))


def _slots(mod: int) -> np.ndarray:
    return np.array([i % mod for i in range(N)], dtype=np.uint64)


def _keys(raw, prefix: str, rows: int, key_limbs: int = 3) -> np.ndarray:
    return np.stack([raw[f"{prefix}_{i}"].reshape(2, key_limbs, N)
                     for i in range(rows)])


def _ct(raw, meta, tag: str, level: int, device: str) -> P.Ciphertext:
    m = meta[tag]
    cf, scale = (m[2], m[3]) if len(m) > 2 else (1, 1.0)
    return interop.ciphertext(raw[tag].reshape(m[0], -1, N), level, m[1],
                              device, scale=scale, correction_factor=cf)


# --------------------------------------------------------------------------
# tests/test_reference_vectors.py
# --------------------------------------------------------------------------

def batch_encoder(device: str) -> List[Check]:
    """encode() gives troy's plaintext coefficients (its index map and
    inverse plain NTT)."""
    vec = seed42()
    pt = P.BatchEncoder(bfv64(device)).encode(_slots(97))
    return [Check("batch encode", interop.words(pt)[:len(vec["pt"])],
                  vec["pt"])]


def decrypt_reference(device: str) -> List[Check]:
    """troy's secret key and symmetric ciphertext, decrypted and decoded:
    the NTT layout, the ciphertext layout, the dot product and BFV's
    scale-and-round."""
    vec, ctx = seed42(), bfv64(device)
    key_limbs = len(vec["q"])
    sk = interop.secret_key(vec["sk"].reshape(key_limbs, N), device)
    assert vec["ct_size"] * (key_limbs - 1) * N == len(vec["ct"])
    ct = interop.ciphertext(vec["ct"].reshape(vec["ct_size"], -1, N),
                            ctx.first_level, vec["ct_ntt"], device)
    pt = P.Decryptor(ctx, sk).decrypt(ct)
    return [Check("decrypt", interop.words(pt)[:len(vec["dec"])],
                  vec["dec"]),
            Check("decode", P.BatchEncoder(ctx).decode(pt), _slots(97))]


@functools.lru_cache(maxsize=None)
def bfv_ops(device: str) -> dict:
    """troy's BFV n = 64 keys and ciphertexts on ``device``."""
    raw, meta = seed42_ops()
    ctx = bfv64(device)
    first = ctx.first_level
    out = {name: _ct(raw, meta, name, first, device)
           for name in ("c1", "c2", "prod", "rel", "rot")}
    out["ms"] = _ct(raw, meta, "ms", first + 1, device)
    out["sk"] = interop.secret_key(raw["sk"].reshape(3, N), device)
    out["rlk"] = interop.relin_keys({2: _keys(raw, "rlk", 2)}, device)
    out["gk3"] = interop.galois_keys({3: _keys(raw, "gk3", 2)}, device)
    return out


def behz_multiply(device: str) -> List[Check]:
    """BEHZ multiply on troy's two ciphertexts: its aux bases, m~
    Montgomery, fastFloor, fastbconvSk."""
    ops = bfv_ops(device)
    got = P.Evaluator(bfv64(device)).multiply(ops["c1"], ops["c2"])
    return [Check("multiply", interop.words(got), interop.words(ops["prod"]))]


def relinearize(device: str) -> List[Check]:
    """The key switch with troy's relin keys: lazy 128-bit sums, the
    divide by the special prime."""
    ops = bfv_ops(device)
    got = P.Evaluator(bfv64(device)).relinearize(ops["prod"], ops["rlk"])
    return [Check("relinearize", interop.words(got),
                  interop.words(ops["rel"]))]


def apply_galois(device: str) -> List[Check]:
    ops = bfv_ops(device)
    got = P.Evaluator(bfv64(device)).apply_galois(ops["c1"], 3, ops["gk3"])
    return [Check("apply_galois(3)", interop.words(got),
                  interop.words(ops["rot"]))]


def mod_switch(device: str) -> List[Check]:
    ops = bfv_ops(device)
    got = P.Evaluator(bfv64(device)).mod_switch_to_next(ops["rel"])
    return [Check("mod_switch_to_next", interop.words(got),
                  interop.words(ops["ms"]))]


def bgv_ops(device: str) -> List[Check]:
    """troy keeps BGV in coefficient form, the port in NTT form: the loads
    transform at the boundary and the words must still agree."""
    raw, meta = bgv_ckks_ops()
    ctx = bgv64(device)
    ev = P.Evaluator(ctx)
    rlk = interop.relin_keys({2: _keys(raw, "bgv_rlk", 2)}, device)

    def load(tag):
        ct = _ct(raw, meta, tag, ctx.first_level, device)
        return ct if ct.is_ntt_form else ev.transform_to_ntt(ct)

    def unload(ct):
        return interop.words(ev.transform_from_ntt(ct))

    prod = ev.multiply(load("bgv_c1"), load("bgv_c2"))
    rel = ev.relinearize(prod, rlk)
    ms = ev.mod_switch_to_next(rel)
    return [Check("bgv multiply", unload(prod),
                  raw["bgv_prod"].reshape(3, -1, N)),
            Check("bgv relinearize", unload(rel),
                  raw["bgv_rel"].reshape(2, -1, N)),
            Check("bgv mod switch correction factor", ms.correction_factor,
                  meta["bgv_ms"][2]),
            Check("bgv mod_switch_to_next", unload(ms),
                  raw["bgv_ms"].reshape(2, -1, N))]


def ckks_ops(device: str) -> List[Check]:
    raw, meta = bgv_ckks_ops()
    ctx = ckks64(device)
    ev = P.Evaluator(ctx)
    rlk = interop.relin_keys({2: _keys(raw, "ckks_rlk", 2)}, device)
    c1, c2 = (_ct(raw, meta, tag, ctx.first_level, device)
              for tag in ("ckks_c1", "ckks_c2"))
    prod = ev.multiply(c1, c2)
    rel = ev.relinearize(prod, rlk)
    rs = ev.rescale_to_next(rel)
    return [Check("ckks multiply scale", prod.scale, meta["ckks_prod"][3]),
            Check("ckks multiply", interop.words(prod),
                  raw["ckks_prod"].reshape(3, -1, N)),
            Check("ckks relinearize", interop.words(rel),
                  raw["ckks_rel"].reshape(2, -1, N)),
            Check("ckks rescale scale", rs.scale, meta["ckks_rs"][3], 1e-3),
            Check("ckks rescale_to_next", interop.words(rs),
                  raw["ckks_rs"].reshape(2, -1, N))]


def seeded_secret_key(device: str) -> List[Check]:
    """The BLAKE2Xb stream and the ternary sampler's draw order give
    troy's NTT-form secret key."""
    vec = seed42()
    kg = P.KeyGenerator(bfv64(device), seed=rnd.seed_from_uint64(42))
    return [Check("secret key", interop.words(kg.secret_key),
                  vec["sk"].reshape(len(vec["q"]), N))]


def ckks_encoder(device: str) -> List[Check]:
    """The canonical-embedding encode at scale 2^30 gives troy's words."""
    raw, _ = bgv_ckks_ops()
    v = np.array([0.1 * i - 1.5 for i in range(N // 2)])
    pt = P.CKKSEncoder(ckks64(device)).encode(v, scale=float(1 << 30))
    return [Check("ckks encode", interop.words(pt).reshape(-1),
                  raw["ckks_p1"])]


def host_encryption_bfv(device: str) -> List[Check]:
    """host_sampling=True with troy's seed and secret key gives troy's
    symmetric ciphertext."""
    vec, ctx = seed42(), bfv64(device)
    sk = interop.secret_key(vec["sk"].reshape(len(vec["q"]), N), device)
    enc = P.Encryptor(ctx, secret_key=sk, seed=rnd.seed_from_uint64(42),
                      host_sampling=True)
    ct = enc.encrypt_symmetric(P.BatchEncoder(ctx).encode(_slots(97)))
    return [Check("bfv encrypt_symmetric", interop.words(ct).reshape(-1),
                  vec["ct"])]


def host_encryption_bgv_ckks(device: str) -> List[Check]:
    """BGV (seed 43) and CKKS (seed 44). troy's seeded factory replays the
    seed for every encryption, so each ciphertext takes a fresh
    Encryptor."""
    raw, _ = bgv_ckks_ops()
    checks = []
    ctx = bgv64(device)
    sk = interop.secret_key(raw["bgv_sk"].reshape(3, N), device)
    be, ev = P.BatchEncoder(ctx), P.Evaluator(ctx)
    v1 = np.array([i % 89 for i in range(N)], dtype=np.uint64)
    v2 = np.array([(5 * i + 2) % 89 for i in range(N)], dtype=np.uint64)
    for vals, tag in ((v1, "bgv_c1"), (v2, "bgv_c2")):
        enc = P.Encryptor(ctx, secret_key=sk, seed=rnd.seed_from_uint64(43),
                          host_sampling=True)
        ct = enc.encrypt_symmetric(be.encode(vals))
        # troy's host BGV ciphertexts are in coefficient form
        checks.append(Check(f"encrypt {tag}", interop.words(
            ev.transform_from_ntt(ct)).reshape(-1), raw[tag]))
    ctx = ckks64(device)
    sk = interop.secret_key(raw["ckks_sk"].reshape(3, N), device)
    cke = P.CKKSEncoder(ctx)
    w1 = np.array([0.1 * i - 1.5 for i in range(N // 2)])
    w2 = np.array([0.05 * i + 0.25 for i in range(N // 2)])
    for vals, tag in ((w1, "ckks_c1"), (w2, "ckks_c2")):
        enc = P.Encryptor(ctx, secret_key=sk, seed=rnd.seed_from_uint64(44),
                          host_sampling=True)
        ct = enc.encrypt_symmetric(cke.encode(vals, scale=float(1 << 30)))
        checks.append(Check(f"encrypt {tag}", interop.words(ct).reshape(-1),
                            raw[tag]))
    return checks


def host_keygen(device: str) -> List[Check]:
    """KeyGenerator(host_sampling=True) with troy's seed gives troy's
    relinearization and Galois keys."""
    ops = bfv_ops(device)
    kg = P.KeyGenerator(bfv64(device), seed=rnd.seed_from_uint64(42),
                        host_sampling=True)
    return [Check("relin key", interop.words(kg.create_relin_keys())[2],
                  interop.words(ops["rlk"])[2]),
            Check("galois key 3",
                  interop.words(kg.create_galois_keys(elts=[3]))[3],
                  interop.words(ops["gk3"])[3])]


def noise_budget(device: str) -> List[Check]:
    """invariant_noise_budget is troy's on the same seeded ciphertext:
    58 bits fresh, 37 after a square."""
    ctx = bfv64(device)
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(42),
                        host_sampling=True)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(42), host_sampling=True)
    dec = P.Decryptor(ctx, kg.secret_key)
    ct = enc.encrypt_symmetric(P.BatchEncoder(ctx).encode(_slots(97)))
    return [Check("budget fresh", dec.invariant_noise_budget(ct), 58),
            Check("budget after square", dec.invariant_noise_budget(
                P.Evaluator(ctx).square(ct)), 37)]


# --------------------------------------------------------------------------
# tests/test_config1_reference_vectors.py
# --------------------------------------------------------------------------

def config1_flow(device: str) -> List[Check]:
    """BFV n = 4096, q = {40,40}: host keygen, two host-sampled encryptions
    (a fresh Encryptor each, as troy's seeded factory replays), their sum
    and its decryption."""
    vecs, ctx = config1(), config1_context(device)
    n = 4096
    checks = [Check("q", [int(m) for m in ctx.key_context_data.coeff_values],
                    vecs["q"]),
              Check("t", int(ctx.key_context_data.plain_modulus),
                    vecs["t"][0])]
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(2026),
                        host_sampling=True)
    checks.append(Check("secret key", interop.words(kg.secret_key),
                        vecs["sk"].reshape(2, n)))
    be = P.BatchEncoder(ctx)
    v1 = np.array([(i * i + 3 * i + 1) % 12289 for i in range(n)],
                  dtype=np.uint64)
    v2 = np.array([(7 * i + 2) % 12289 for i in range(n)], dtype=np.uint64)
    c1, c2 = (P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(2026),
                          host_sampling=True).encrypt_symmetric(be.encode(v))
              for v in (v1, v2))
    s12 = P.Evaluator(ctx).add(c1, c2)
    pt = P.Decryptor(ctx, kg.secret_key).decrypt(s12)
    t = vecs["t"][0]
    return checks + [
        Check("c1", interop.words(c1).reshape(-1), vecs["c1"]),
        Check("c2", interop.words(c2).reshape(-1), vecs["c2"]),
        Check("sum", interop.words(s12).reshape(-1), vecs["sum"]),
        Check("decrypt", interop.words(pt)[:len(vecs["dec"])], vecs["dec"]),
        Check("decode", be.decode(pt).astype(object),
              (v1.astype(object) + v2.astype(object)) % t)]


# --------------------------------------------------------------------------
# tests/test_ckksrot_event_vectors.py
# --------------------------------------------------------------------------

def ckks_rotation(device: str) -> List[Check]:
    """CKKS NTT-form rotate_vector(1) and complex_conjugate on troy's
    Galois keys, at q = {50,30,50}."""
    raw, meta = ckksrot()
    ctx = ckks64(device)
    ev = P.Evaluator(ctx)
    elt = meta["elt"]
    gk = interop.galois_keys({elt: _keys(raw, "cr_gk", 2)}, device)
    gkc = interop.galois_keys({2 * N - 1: _keys(raw, "cr_gkc", 2)}, device)
    c1 = _ct(raw, meta, "cr_c1", ctx.first_level, device)
    return [Check("rotate_vector(1)", interop.words(ev.rotate_vector(
                c1, 1, gk)), raw["cr_rot"].reshape(2, -1, N)),
            Check("complex_conjugate", interop.words(ev.complex_conjugate(
                c1, gkc)), raw["cr_conj"].reshape(2, -1, N))]


def even_t_multiply(device: str) -> List[Check]:
    """BEHZ multiply at t = 2^41 (even, the app's t) and the exact t/Q
    scale-and-round of its decryption."""
    raw, meta = ckksrot()
    ctx = even_t64(device)
    sk = interop.secret_key(raw["et_sk"].reshape(3, N), device)
    c1, c2 = (_ct(raw, meta, tag, ctx.first_level, device)
              for tag in ("et_c1", "et_c2"))
    prod = P.Evaluator(ctx).multiply(c1, c2)
    pt = P.Decryptor(ctx, sk).decrypt(prod)
    return [Check("multiply at t = 2^41", interop.words(prod),
                  raw["et_prod"].reshape(3, -1, N)),
            Check("decrypt at t = 2^41",
                  interop.words(pt)[:len(raw["et_dec"])], raw["et_dec"])]


# --------------------------------------------------------------------------
# tests/test_rns_reference_vectors.py: what the card runs in place of
# troy's separate RNSTool steps, on the same inputs
# --------------------------------------------------------------------------

def rns_composites(device: str) -> List[Check]:
    """Kernel E's lift (fastbconv_m_tilde then sm_mrq) on inq; the fused
    decrypt ACi (A's inverse, then C's conversion and E's rounding) on the
    NTT of inq; the decrypt scaling on inq (C, then E's rounding); K's
    divide by the last prime on inq."""
    vecs, (k, k_bsk, _) = rnstool()
    cd = bfv64(device).first_context_data
    inq = interop.to_torch(vecs["inq"].reshape(k, N), device)
    return [Check("behz_lift", interop.to_numpy(drns.behz_lift(inq, cd.rns)),
                  vecs["sm_mrq"].reshape(k_bsk, N)),
            Check("ntt_inverse_decrypt_scale_and_round", interop.to_numpy(
                drns.ntt_inverse_decrypt_scale_and_round(
                    dntt.rns_ntt_forward(inq, cd.ntt), cd.rns)),
                vecs["scale_round"]),
            Check("decrypt_scale_and_round", interop.to_numpy(
                drns.decrypt_scale_and_round(inq, cd.rns)),
                vecs["scale_round"]),
            Check("divide_and_round_q_last", interop.to_numpy(
                keyswitch.divide_and_round_q_last(inq.unsqueeze(0), cd.ntt)),
                vecs["div_round_qlast"].reshape(1, k - 1, N))]


# every case that runs ops, replayed on the card by chip_smoke.py's phase
# 36: ref_bfv_n64_seed42*.txt and ref_bgv_ckks_ops.txt, then
# ref_bfv_n4096_config1.txt, ref_ckksrot_event.txt, ref_rnstool_ops.txt
CASES = (batch_encoder, decrypt_reference, behz_multiply, relinearize,
         apply_galois, mod_switch, bgv_ops, ckks_ops, seeded_secret_key,
         ckks_encoder, host_encryption_bfv, host_encryption_bgv_ckks,
         host_keygen, noise_budget, config1_flow, ckks_rotation,
         even_t_multiply, rns_composites)
