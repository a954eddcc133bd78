"""Request kind ``matmul_cipher``: troy's ct x ct matmul
(``MatmulHelper.matmul_cipher``) of an encrypted input grid and an
encrypted weight grid, both of the pools, then ``Cipher2d.relinearize``
of the product grid and ``MatmulHelper.pack_outputs`` of it into the
packed output ciphertexts."""

from __future__ import annotations

from hebench import work
from hebench.reference.app import ceil_div

STAGES = ("matmul_cipher", "relinearize_grid", "pack_outputs")


def _counts(cfg: dict, wl: dict) -> tuple:
    """(input ciphertexts, weight ciphertexts, tile pairs, product
    ciphertexts, packed ciphertexts, trace steps) of one request at the
    workload's blocks."""
    (B, I, O), (bB, iB, oB) = wl["dims"], wl["blocks"]
    rows, inner, cols = ceil_div(B, bB), ceil_div(I, iB), ceil_div(O, oB)
    y = rows * cols
    return (rows * inner, inner * cols, rows * inner * cols, y,
            ceil_div(y, iB), iB.bit_length() - 1)


def setup(s, wl: dict, data: dict) -> dict:
    """The helper (its blocks checked against the workload's), the relin
    key, troy's automorphism keys, and the pools, encrypted."""
    from troy_tpu_torch.app import linear
    B, I, O = wl["dims"]
    helper = linear.MatmulHelper(B, I, O, s.cfg["poly_modulus_degree"],
                                 objective=0, pack_lwe=wl["pack_lwe"])
    blocks = [helper.batch_block, helper.input_block, helper.output_block]
    if blocks != list(wl["blocks"]):
        raise RuntimeError(f"the program chose matmul blocks {blocks}, the "
                           f"workload states {wl['blocks']}")
    ep = s.be.encode_polynomial
    return {"helper": helper, "rlk": s.keygen.create_relin_keys(),
            "gk": s.keygen.create_automorphism_keys(),
            "inputs": [helper.encrypt_inputs(s.enc, ep, x)
                       for x in data["inputs"]],
            "weights": [helper.encode_weights(ep, w).encrypt_symmetric(s.enc)
                        for w in data["weights"]]}


def issue(s, st: dict, req, stage):
    helper = st["helper"]
    with stage("matmul_cipher"):
        y = helper.matmul_cipher(s.ev, st["inputs"][req[0]],
                                 st["weights"][req[1]])
    with stage("relinearize_grid"):
        y = y.relinearize(s.ev, st["rlk"])
    with stage("pack_outputs"):
        return helper.pack_outputs(s.ev, st["gk"], y)


def kept(out) -> list:
    return [ct.data for row in out.data for ct in row]


def work_counts(cfg: dict, wl: dict) -> tuple:
    """Bytes: the input and weight ciphertexts, the relin key, the trace's
    automorphism keys and the packed outputs. Products: BEHZ's lift of
    every operand polynomial, the tensor of every tile pair, the finish of
    the size-3 products, and one key switch for each product ciphertext's
    relinearization and for each of them at every trace step."""
    x, w, pairs, y, packed, steps = _counts(cfg, wl)
    nbytes = ((x + w + packed) * work.ct_words(cfg)
              + (1 + steps) * work.key_words(cfg)) * work.WORD
    mulmods = (work.behz_lift(cfg, 2 * (x + w)) + work.tensor(cfg, pairs)
               + work.behz_finish(cfg, 3 * y)
               + (y + steps * y) * work.key_switch(cfg))
    return nbytes, work.mul64(mulmods)
