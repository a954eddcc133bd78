"""Request kind ``conv2d``: ``Conv2dHelper.conv2d`` of an encrypted input
image of the pool with the cell's plain weights, encoded at set-up."""

from __future__ import annotations

from hebench import work
from hebench.reference.app import ceil_div

STAGES = ("conv2d",)


def _counts(cfg: dict, wl: dict) -> tuple:
    """(input ciphertexts, weight plaintexts, output ciphertexts, input
    channel groups) of one request at the workload's blocks."""
    (B, H, W), (KH, KW), (CI, CO) = wl["image"], wl["kernel"], wl["channels"]
    bb, bh, bw, bci, bco = wl["blocks"]
    patches = (ceil_div(B, bb) * ceil_div(H - KH + 1, bh - KH + 1)
               * ceil_div(W - KW + 1, bw - KW + 1))
    groups_in, groups_out = ceil_div(CI, bci), ceil_div(CO, bco)
    return (patches * groups_in, groups_in * groups_out,
            patches * groups_out, groups_in)


def setup(s, wl: dict, data: dict) -> dict:
    from troy_tpu_torch.app import linear
    (B, H, W), (KH, KW), (CI, CO) = wl["image"], wl["kernel"], wl["channels"]
    helper = linear.Conv2dHelper(B, H, W, KH, KW, CI, CO,
                                 s.cfg["poly_modulus_degree"], objective=0)
    blocks = [helper.block_batch, helper.block_height, helper.block_width,
              helper.block_in_channels, helper.block_out_channels]
    if blocks != list(wl["blocks"]):
        raise RuntimeError(f"the program chose conv2d blocks {blocks}, the "
                           f"workload states {wl['blocks']}")
    ep = s.be.encode_polynomial
    return {"helper": helper,
            "weights": helper.encode_weights(ep, data["weights"]),
            "pool": [helper.encrypt_inputs(s.enc, ep, x)
                     for x in data["images"]]}


def issue(s, st: dict, req, stage):
    with stage("conv2d"):
        return st["helper"].conv2d(s.ev, st["pool"][req[0]], st["weights"])


def kept(out) -> list:
    return [ct.data for row in out.data for ct in row]


def work_counts(cfg: dict, wl: dict) -> tuple:
    """Bytes: the input ciphertexts, the weight plaintexts (n words each)
    and the outputs. Products: the inputs' NTTs, the weights' lift and NTT
    over q, the contraction's products and the outputs' inverse NTTs."""
    n, L = cfg["poly_modulus_degree"], len(cfg["coeff_modulus"]) - 1
    x, w, y, gin = _counts(cfg, wl)
    nbytes = ((x + y) * work.ct_words(cfg) + w * n) * work.WORD
    mulmods = (work.ntt_rows(2 * L * x + L * w + 2 * L * y, n)
               + y * gin * 2 * L * n)
    return nbytes, work.mul64(mulmods)
