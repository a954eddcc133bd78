"""Random matmul and conv2d shapes through troy_tpu_torch's client/server
protocol against the plain integer oracle, on the CPU.

The twin of tests/test_app_fuzz.py: its seeds, shapes and oracles, each
shape through encode -> encrypt -> evaluate -> [pack] -> serialize ->
decrypt (the tiling search's split boundaries, shapes that straddle block
edges, degenerate dims), with the port's app layer (troy_tpu_torch.app.
linear) at n = 64, q = {40,40,40}, a 20-bit batching t. Seeded, so a
failure replays. No JAX.
"""

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import prng as rnd
from troy_tpu_torch.app.linear import Conv2dHelper, MatmulHelper

torch.set_num_threads(1)

N = 64


@pytest.fixture(scope="module")
def bfv():
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(N, 20))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xF00D))
    enc = P.Encryptor(ctx, public_key=kg.create_public_key(),
                      secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(0xF00D))
    dec = P.Decryptor(ctx, kg.secret_key)
    ev = P.Evaluator(ctx)
    be = P.BatchEncoder(ctx)
    auto_keys = kg.create_automorphism_keys()
    return ctx, enc, dec, ev, be, auto_keys


@pytest.mark.parametrize("fuzz_seed", [0, 1, 2, 3])
def test_matmul_random_shapes(bfv, fuzz_seed):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(7100 + fuzz_seed)

    B = int(rng.integers(1, 7))
    I = int(rng.integers(1, 11))
    O = int(rng.integers(1, 11))
    objective = int(rng.integers(0, 2))
    pack = bool(rng.integers(0, 2)) and objective == 0

    x = rng.integers(0, t, (B, I), dtype=np.uint64)
    w = rng.integers(0, t, (I, O), dtype=np.uint64)
    expect = (x.astype(object) @ w.astype(object)) % t

    helper = MatmulHelper(B, I, O, N, objective=objective, pack_lwe=pack)
    if objective == 1:
        # weights encrypted, inputs plain (LinearHelper.cuh:429, reverse)
        w_ct = helper.encode_weights(be.encode_polynomial, w) \
            .encrypt_symmetric(enc)
        x_pt = helper.encode_inputs(be.encode_polynomial, x)
        y_ct = helper.matmul_reverse(ev, x_pt, w_ct)
    else:
        w_pt = helper.encode_weights(be.encode_polynomial, w)
        x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
        y_ct = helper.matmul(ev, x_ct, w_pt)
        if pack:
            y_ct = helper.pack_outputs(ev, auto_keys, y_ct)
    blob = helper.serialize_outputs(ev, ctx, y_ct)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)
    np.testing.assert_array_equal(
        y.astype(object) % t, expect,
        err_msg=f"B={B} I={I} O={O} obj={objective} pack={pack}")


@pytest.mark.parametrize("fuzz_seed", [0, 1])
def test_matmul_cipher_random_shapes(bfv, fuzz_seed):
    """ct x ct matmul at random shapes (testMatmulCipherInts)."""
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(7300 + fuzz_seed)

    B = int(rng.integers(1, 5))
    I = int(rng.integers(1, 8))
    O = int(rng.integers(1, 8))
    x = rng.integers(0, t, (B, I), dtype=np.uint64)
    w = rng.integers(0, t, (I, O), dtype=np.uint64)

    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=False)
    w_ct = helper.encode_weights(be.encode_polynomial, w).encrypt(enc)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    y_ct = helper.matmul_cipher(ev, x_ct, w_ct)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct)
    np.testing.assert_array_equal(
        y.astype(object) % t,
        (x.astype(object) @ w.astype(object)) % t,
        err_msg=f"B={B} I={I} O={O}")


def _conv_oracle(x, w, t):
    B, CI, H, W = x.shape
    CO, _, KH, KW = w.shape
    oh, ow = H - KH + 1, W - KW + 1
    out = np.zeros((B, CO, oh, ow), dtype=object)
    for b in range(B):
        for co in range(CO):
            for i in range(oh):
                for j in range(ow):
                    acc = 0
                    for ci in range(CI):
                        acc += int((x[b, ci, i:i + KH, j:j + KW]
                                    .astype(object)
                                    * w[co, ci].astype(object)).sum())
                    out[b, co, i, j] = acc % t
    return out


@pytest.mark.parametrize("fuzz_seed", [0, 1, 2])
def test_conv2d_random_shapes(bfv, fuzz_seed):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(7500 + fuzz_seed)

    B = int(rng.integers(1, 3))
    H = int(rng.integers(2, 7))
    W = int(rng.integers(2, 7))
    KH = int(rng.integers(1, H + 1))
    KW = int(rng.integers(1, W + 1))
    CI = int(rng.integers(1, 4))
    CO = int(rng.integers(1, 4))
    x = rng.integers(0, 32, (B, CI, H, W), dtype=np.uint64)
    w = rng.integers(0, 32, (CO, CI, KH, KW), dtype=np.uint64)

    reverse = bool(rng.integers(0, 2))
    objective = 1 if reverse else 0
    helper = Conv2dHelper(B, H, W, KH, KW, CI, CO, N, objective=objective)
    if reverse:
        # encrypted weights x plain inputs (conv2dReverse,
        # LinearHelper.cuh:1020-1043)
        w_ct = helper.encode_weights(be.encode_polynomial, w) \
            .encrypt_symmetric(enc)
        x_pt = helper.encode_inputs(be.encode_polynomial, x)
        y_ct = helper.conv2d_reverse(ev, x_pt, w_ct)
    else:
        w_pt = helper.encode_weights(be.encode_polynomial, w)
        x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
        y_ct = helper.conv2d(ev, x_ct, w_pt)
    blob = helper.serialize_outputs(ev, ctx, y_ct)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)
    np.testing.assert_array_equal(
        y.astype(object) % t, _conv_oracle(x, w, t),
        err_msg=f"B={B} H={H} W={W} KH={KH} KW={KW} CI={CI} CO={CO} "
                f"reverse={reverse}")
