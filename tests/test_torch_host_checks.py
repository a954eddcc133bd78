"""troy_tpu_torch's host modules against troy_tpu's on the CPU, word for
word: hexpoly (SEAL's hex-poly strings), valcheck (metadata, buffer and
data validity) and functional (the explicit-argument evaluator API).

hexpoly on fixed and seeded coefficient arrays and strings; valcheck on
the same seeded objects of both packages (BFV at n = 64, CKKS at n = 256)
and on tampered copies, comparing every verdict and message; functional
on seeded ciphertexts of BFV, CKKS and BGV at n = 64 (CKKS 256), q =
{40,40,40}, comparing the words after every function, and by decryption
through the port.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import functional as JF
from troy_tpu import hexpoly as jhex
from troy_tpu import prng as jprng
from troy_tpu import valcheck as jvc
from troy_tpu.utils import galois as jgalois

import troy_tpu_torch as P
from troy_tpu_torch import functional as PF
from troy_tpu_torch import hexpoly as phex
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch import valcheck as pvc
from troy_tpu_torch.ops import galois as dgalois
from troy_tpu_torch.utils import galois as pgalois

torch.set_num_threads(2)

SEED = 4242
SCALE = 2.0 ** 30


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# hexpoly
# ---------------------------------------------------------------------------

HEX_STRINGS = ["3Fx^3 + 2x^2 + 1", "0", "5x^1", "1x^63 + FFFFFFFFx^2 + 7",
               "Fx + 3", "ax^4 + Bx^4 + 2", "  10x^2 +  1  "]


@pytest.mark.parametrize("s", HEX_STRINGS)
def test_hex_string_to_poly(s):
    for count in (0, 8, 70):
        np.testing.assert_array_equal(phex.hex_string_to_poly(s, count),
                                      jhex.hex_string_to_poly(s, count))


def test_poly_to_hex_string_and_plaintexts():
    rng = np.random.default_rng(SEED)
    arrays = [np.array([1, 0, 2, 0x3F], dtype=np.uint64),
              np.zeros(5, dtype=np.uint64), np.array([0, 5], np.uint64),
              rng.integers(0, 2 ** 64, 16, dtype=np.uint64),
              np.where(rng.random(64) < 0.2,
                       rng.integers(1, 2 ** 20, 64), 0).astype(np.uint64)]
    for arr in arrays:
        s = phex.poly_to_hex_string(arr)
        assert s == jhex.poly_to_hex_string(arr)
        pt = phex.plaintext_from_string(s, len(arr), device="cpu")
        assert phex.plaintext_to_string(pt) == jhex.plaintext_to_string(
            jhex.plaintext_from_string(s, len(arr)))
        np.testing.assert_array_equal(_np(pt.data), arr)
    for bad in ("", "3y^2", "x^", "x + 3"):
        with pytest.raises(ValueError):
            phex.hex_string_to_poly(bad)
        with pytest.raises(ValueError):
            jhex.hex_string_to_poly(bad)
    ntt = P.Plaintext(data=torch.zeros(2, 4, dtype=torch.int64), level=1,
                      is_ntt_form=True)
    with pytest.raises(ValueError, match="NTT-form"):
        phex.plaintext_to_string(ntt)


# ---------------------------------------------------------------------------
# both packages' seeded objects
# ---------------------------------------------------------------------------

class Side:
    def __init__(self, mod, scheme):
        self.mod = mod
        n = 256 if scheme == "ckks" else 64
        self.n = n
        prng = tprng if mod is P else jprng
        extra = {} if scheme == "ckks" else {
            "plain_modulus": mod.PlainModulus.batching(n, 20)}
        parms = mod.EncryptionParameters(
            scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(mod.CoeffModulus.create(n, [40, 40, 40])),
            **extra)
        on_cpu = {"device": "cpu"} if mod is P else {}
        self.ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                 **on_cpu)
        kg = mod.KeyGenerator(self.ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        self.kg, self.sk = kg, kg.secret_key
        self.pk = kg.create_public_key()
        self.rlk = kg.create_relin_keys()
        self.gk = kg.create_galois_keys(steps=[1])
        self.elt = next(iter(self.gk.keys))
        self.enc = mod.Encryptor(self.ctx, public_key=self.pk,
                                 secret_key=self.sk,
                                 seed=prng.seed_from_uint64(SEED + 1))
        self.dec = mod.Decryptor(self.ctx, self.sk)
        rng = np.random.default_rng(SEED)
        if scheme == "ckks":
            self.encoder = mod.CKKSEncoder(self.ctx)
            self.vals = [rng.uniform(-1, 1, n) for _ in range(2)]
            self.plains = [self.encoder.encode_polynomial(v, SCALE)
                           for v in self.vals]
        else:
            self.encoder = mod.BatchEncoder(self.ctx)
            t = self.encoder.plain_modulus
            self.vals = [rng.integers(0, t, n, dtype=np.uint64)
                         for _ in range(2)]
            self.plains = [self.encoder.encode(v) for v in self.vals]
        self.cts = [self.enc.encrypt_symmetric(p) for p in self.plains]


@pytest.fixture(scope="module", params=["bfv", "ckks", "bgv"])
def sides(request):
    return {m: Side(m, request.param) for m in (P, J)}


def test_the_seeded_ciphertexts_agree(sides):
    for a, b in zip(sides[P].cts, sides[J].cts):
        np.testing.assert_array_equal(_np(a.data), _np(b.data))


# ---------------------------------------------------------------------------
# valcheck
# ---------------------------------------------------------------------------

def _verdicts(vc, obj, ctx):
    """Each tier's verdict and, where it raises, its message (ValueError)
    or the kind of error (the data tier indexes the chain by level)."""
    out = []
    for check in (lambda: vc.is_metadata_valid_for(obj, ctx, True),
                  lambda: vc.is_buffer_valid(obj, True),
                  lambda: vc.is_data_valid_for(obj, ctx, True),
                  lambda: vc.check_is_valid_for(obj, ctx)):
        try:
            out.append(check())
        except ValueError as exc:
            out.append(str(exc))
        except IndexError:
            out.append("IndexError")
    try:
        out.append(vc.is_valid_for(obj, ctx))
    except IndexError:
        out.append("IndexError")
    return out


def _objects(side):
    """The side's objects, and tampered copies of them."""
    mod, ctx = side.mod, side.ctx
    if mod is P:
        top = lambda d: torch.full_like(d, -1)           # u64 2^64 - 1
        small = lambda d: d[..., :-1]
        as_u32 = lambda d: d.to(torch.int32)
    else:
        import jax.numpy as jnp
        top = lambda d: jnp.full_like(d, np.uint64(2 ** 64 - 1))
        small = lambda d: d[..., :-1]
        as_u32 = lambda d: d.astype(jnp.uint32)
    ct = side.cts[0]
    cd_limbs = ctx.first_context_data.limbs
    bad_level = ct.replace(level=len(ctx.chain))
    out = {"ct": ct, "pt": side.plains[0], "sk": side.sk, "pk": side.pk,
           "rlk": side.rlk, "gk": side.gk,
           "ct_out_of_bounds": ct.replace(data=top(ct.data)),
           "ct_short": ct.replace(data=small(ct.data)),
           "ct_level": bad_level,
           "ct_u32": ct.replace(data=as_u32(ct.data)),
           "ct_scale": ct.replace(scale=3.0),
           "ct_cf": ct.replace(correction_factor=3),
           "ct_form": ct.replace(is_ntt_form=not ct.is_ntt_form),
           "sk_short": mod.SecretKey(data=small(side.sk.data)),
           "pk_out_of_bounds": mod.PublicKey(data=top(side.pk.data)),
           "gk_bad_elt": mod.GaloisKeys(keys={2: side.gk.keys[side.elt]}),
           "rlk_short": mod.RelinKeys(keys={2: small(side.rlk.keys[2])})}
    assert cd_limbs == ct.data.shape[1]
    return out


def test_valcheck_verdicts_match_troy_tpu(sides):
    pobjs, jobjs = _objects(sides[P]), _objects(sides[J])
    dtype_message = "HE buffers must be"      # names each package's dtype
    for name in pobjs:
        got = _verdicts(pvc, pobjs[name], sides[P].ctx)
        want = _verdicts(jvc, jobjs[name], sides[J].ctx)
        for g, w in zip(got, want):
            if isinstance(w, str) and w.startswith(dtype_message):
                assert g.startswith(dtype_message), (name, got, want)
            else:
                assert g == w, (name, got, want)
    assert _verdicts(pvc, pobjs["ct"], sides[P].ctx) == [True] * 3 + \
        [None, True]


# ---------------------------------------------------------------------------
# functional
# ---------------------------------------------------------------------------

def _functional_run(side):
    mod = side.mod
    F = PF if mod is P else JF
    ctx = side.ctx
    cd, key_cd = ctx.first_context_data, ctx.key_context_data
    a, b = side.cts
    out = {"negate": F.negate(a, cd), "add": F.add(a, b, cd),
           "sub": F.sub(a, b, cd), "multiply": F.multiply(a, b, cd),
           "square": F.square(a, cd),
           "relinearize": F.relinearize(F.multiply(a, b, cd),
                                        (side.rlk.keys[2],), cd, key_cd),
           "multiply_relinearize": F.multiply_relinearize(
               a, b, side.rlk.keys[2], cd, key_cd)}
    out["mod_switch_to_next"] = F.mod_switch_to_next(
        out["multiply_relinearize"], cd)
    if cd.scheme == mod.SchemeType.ckks:
        out["rescale_to_next"] = F.rescale_to_next(
            out["multiply_relinearize"], cd)
    key = side.gk.keys[side.elt]
    if a.is_ntt_form:
        perm = (dgalois.ntt_permutation(side.n, side.elt, "cpu")
                if mod is P else jgalois.ntt_permutation_dev(side.n,
                                                             side.elt))
        out["apply_galois"] = F.apply_galois(a, perm, key, cd, key_cd)
    else:
        src, keep = (dgalois.coeff_permutation(side.n, side.elt, "cpu")
                     if mod is P else jgalois.coeff_permutation_dev(
                         side.n, side.elt))
        out["apply_galois_coeff"] = F.apply_galois_coeff(a, src, keep, key,
                                                         cd, key_cd)
    return out


def test_functional_words_match_troy_tpu(sides):
    got, want = _functional_run(sides[P]), _functional_run(sides[J])
    assert sorted(got) == sorted(want)
    for name in got:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(_np(g.data), _np(w.data),
                                      err_msg=name)
        assert (g.level, g.is_ntt_form, g.correction_factor) == \
            (w.level, w.is_ntt_form, w.correction_factor), name
        assert g.scale == pytest.approx(w.scale, rel=1e-12), name


def test_functional_decrypts_right(sides):
    side = sides[P]
    out = _functional_run(side)
    a, b = side.vals
    dec, enc = side.dec, side.encoder
    if isinstance(enc, P.CKKSEncoder):
        n = side.n
        prod = np.zeros(n)
        for i in range(n):               # a b mod x^n + 1
            prod[i:] += a[i] * b[:n - i]
            prod[:i] -= a[i] * b[n - i:]
        got = enc.decode_polynomial(dec.decrypt(out["rescale_to_next"]))
        np.testing.assert_allclose(got, prod, atol=1e-4)
        np.testing.assert_allclose(
            enc.decode_polynomial(dec.decrypt(out["sub"])), a - b,
            atol=1e-6)
        return
    t = enc.plain_modulus
    A, B = a.astype(object), b.astype(object)
    for name, want in (("negate", (t - A) % t), ("add", (A + B) % t),
                       ("sub", (A - B) % t),
                       ("multiply_relinearize", A * B % t),
                       ("mod_switch_to_next", A * B % t),
                       ("square", A * A % t)):
        np.testing.assert_array_equal(
            enc.decode(dec.decrypt(out[name])).astype(object), want,
            err_msg=name)
    rot = out.get("apply_galois_coeff", out.get("apply_galois"))
    half = side.n // 2
    want = np.concatenate([np.roll(a[:half], -1), np.roll(a[half:], -1)])
    np.testing.assert_array_equal(enc.decode(dec.decrypt(rot)), want)
    assert side.elt == pgalois.get_elt_from_step(side.n, 1)
