"""Request kind ``mul_relin``: ``Evaluator.multiply`` of two pool
ciphertexts, then ``Evaluator.relinearize``."""

from __future__ import annotations

from hebench import work

STAGES = ("multiply", "relinearize")


def setup(s, wl: dict, data: dict) -> dict:
    """The relin key and the pool, encrypted."""
    return {"rlk": s.keygen.create_relin_keys(),
            "pool": s.encrypt_pool(data["messages"])}


def issue(s, st: dict, req, stage):
    with stage("multiply"):
        prod = s.ev.multiply(st["pool"][req[0]], st["pool"][req[1]])
    with stage("relinearize"):
        return s.ev.relinearize(prod, st["rlk"])


def kept(out) -> list:
    return [out.data]


def work_counts(cfg: dict, wl: dict) -> tuple:
    """(bytes, 64-bit products) of one request (``work.py``): two
    ciphertexts in, the relin key's rows, one ciphertext out."""
    nbytes = (3 * work.ct_words(cfg) + work.key_words(cfg)) * work.WORD
    return nbytes, work.mul64(work.bfv_multiply(cfg) + work.key_switch(cfg))
