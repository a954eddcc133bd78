"""CKKS precision against depth for troy_tpu_torch.

    python3 tools/ckks_precision_torch.py [TRIALS] [DEVICE]

Decode max-error and bits of precision along a multiply -> relinearize ->
rescale chain at the headline configuration (n = 16384,
q = {60,40,40,40,40,60}, scale 2^40): fresh encode/decode, fresh
encrypt/decrypt, then after each multiply+relin (scale 2^80) and after
each rescale. The same chain, seeds, stages and rows as the JAX package's
benchmarks/ckks_precision.py (whose record is CKKS_PRECISION_r05.json), on
the port: keys and encryptions by its default (device-sampled) path.

Error model: inputs uniform in [-1, 1]; the model is the exact slot
products in float64; max_err = max |decoded - model| over all slots and
trials; precision_bits = -log2(max_err / max|model|), the worst slot's
relative precision.

``run(..., device=)`` runs on the card by default and on the CPU when
asked (the kernels' plain versions). ``plaintexts`` replaces every
encoder output by the given words (another run's ``record``), so two
devices' chains can be held word for word from the same plaintexts;
``record`` collects each trial's plaintext words and every stage's
ciphertext words. tests/test_torch_ckks_precision.py holds the CPU rows to
CKKS_PRECISION_r05.json; chip_smoke.py's phase 36 runs the chain on the
card. Imports torch, numpy and troy_tpu_torch, never JAX.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as rnd


def run(n: int = 16384, q_bits=(60, 40, 40, 40, 40, 60),
        scale: float = 2.0 ** 40, trials: int = 2, seed: int = 2025,
        device=None, plaintexts: Optional[dict] = None,
        record: Optional[dict] = None):
    """(rows, meta): one row per chain stage with its level, scale,
    max_err, max_value and precision bits, worst case over ``trials``
    random input pairs."""
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, list(q_bits))))
    sec = P.SecurityLevel.tc128 if n >= 16384 else P.SecurityLevel.none
    ctx = P.HeContext(parms, sec_level=sec, device=device)
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
    rlk = kg.create_relin_keys()
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(seed + 1))
    dec = P.Decryptor(ctx, kg.secret_key)
    ce = P.CKKSEncoder(ctx)
    ev = P.Evaluator(ctx)

    def encode(tag, values, sc, level=None):
        """The encoder's plaintext, or the given words in its place."""
        if plaintexts is None:
            pt = ce.encode(values, scale=sc, level=level)
        else:
            pt = interop.plaintext(
                plaintexts[tag], ctx.device,
                ctx.first_level if level is None else level, True, sc)
        if record is not None:
            record[tag] = interop.words(pt)
        return pt

    def keep(tag, ct):
        if record is not None:
            record[tag] = interop.words(ct)
        return ct

    # stages: fresh, then for each depth d after mult+relin and after the
    # rescale; each multiply and rescale spends a level, and the last
    # level must still hold scale 2^40
    depth = len(q_bits) - 3          # 3 multiplies at the headline
    stats = {}

    def note(stage, got, model, level, sc):
        err = float(np.max(np.abs(got - model)))
        prev = stats.get(stage)
        if prev is None or err > prev["max_err"]:
            stats[stage] = dict(stage=stage, level=level, scale=sc,
                                max_err=err,
                                max_value=float(np.max(np.abs(model))))

    rng = np.random.default_rng(seed)
    for trial in range(trials):
        a = rng.uniform(-1.0, 1.0, n // 2)
        b = rng.uniform(-1.0, 1.0, n // 2)
        pt_a = encode(f"{trial} a", a, scale)
        note("encode/decode (fresh)", np.real(ce.decode(pt_a)), a,
             ctx.first_level, scale)
        ct = keep(f"{trial} encrypt", enc.encrypt_symmetric(pt_a))
        note("encrypt/decrypt (fresh)", np.real(ce.decode(dec.decrypt(ct))),
             a, ct.level, scale)
        model = a
        for d in range(1, depth + 1):
            ct_b = enc.encrypt_symmetric(encode(f"{trial} b{d}", b,
                                                ct.scale, ct.level))
            ct = keep(f"{trial} depth {d} multiply+relin",
                      ev.relinearize(ev.multiply(ct, ct_b), rlk))
            model = model * b
            note(f"depth {d}: multiply+relin",
                 np.real(ce.decode(dec.decrypt(ct))), model, ct.level,
                 ct.scale)
            ct = keep(f"{trial} depth {d} rescale", ev.rescale_to_next(ct))
            note(f"depth {d}: rescale",
                 np.real(ce.decode(dec.decrypt(ct))), model, ct.level,
                 ct.scale)

    rows = []
    for stage in stats:
        r = stats[stage]
        rel = r["max_err"] / max(r["max_value"], 1e-300)
        r["precision_bits"] = float(round(-np.log2(max(rel, 1e-300)), 1))
        r["max_err"] = float(f"{r['max_err']:.3e}")
        r["scale"] = float(r["scale"])
        rows.append(r)
    meta = dict(n=n, q_bits=list(q_bits), scale=float(scale),
                trials=trials, depth=depth, device=str(ctx.device))
    return rows, meta


def table(rows, meta) -> str:
    lines = [f"CKKS precision vs depth (n={meta['n']}, q={meta['q_bits']}, "
             f"scale 2^{np.log2(meta['scale']):.0f}, {meta['trials']} "
             f"trials, {meta['device']}):",
             f"  {'stage':28s} {'level':>5s} {'scale':>10s} "
             f"{'max err':>10s} {'prec bits':>9s}"]
    for r in rows:
        lines.append(f"  {r['stage']:28s} {r['level']:5d} "
                     f"2^{np.log2(r['scale']):.1f}  {r['max_err']:10.3e} "
                     f"{r['precision_bits']:9.1f}")
    return "\n".join(lines)


def main():
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    device = sys.argv[2] if len(sys.argv) > 2 else None
    print(table(*run(trials=trials, device=device)))


if __name__ == "__main__":
    main()
