#!/usr/bin/env python3
"""Drive troy_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

BFV at n = 16384, q = {60,40,40,40,40,60}, t = PlainModulus.batching(n, 20)
(troy's own timing configuration, 128-bit security). Phases, in order; any
failure raises and the script exits non-zero without a result line:

1. device: require CUDA; print the card, its power limit, torch and CUDA;
2. build the CUDA kernels from troy_tpu_torch/csrc with nvcc (sm_90a);
3. each kernel (A NTT, B dyadic MAC, C base conversion, D RNS elementwise)
   against its plain PyTorch version on the card, at the main path's
   shapes, word for word, with both times (CUDA events, median of 20);
4. the n = 16384 fixture chain from troy's C++ code, word for word:
   keygen (sk, relin key row 0), encrypt, multiply, relinearize, decrypt;
5. round trips on fresh random slot vectors, each decrypting to a*b mod t,
   and the median multiply+relinearize time (CUDA events);
6. every kernel was launched by phases 4-5 (launch counters).

The line before last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import troy_tpu_torch as P
from troy_tpu_torch import _kernels, prng as rnd, to_numpy, to_torch
from troy_tpu_torch.ops import ntt, poly, rns

N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
SEED = 2024
FIXTURE = (pathlib.Path(__file__).resolve().parent / "tests" / "data"
           / "ref_bfv_n16384_headline.bin")
REQUESTS = 3
TIMING_REPS = 20

# name -> (source, the TPU function it replaces)
KERNELS = {
    "A_ntt": ("troy_tpu_torch/csrc/ntt.cu", "troy_tpu/ops/ntt.py:318"),
    "B_dyadic_mac": ("troy_tpu_torch/csrc/dyadic_mac.cu",
                     "troy_tpu/ops/ntt.py:428"),
    "C_base_convert": ("troy_tpu_torch/csrc/base_convert.cu",
                       "troy_tpu/ops/rns.py:44"),
    "D_rns_elementwise": ("troy_tpu_torch/csrc/rns_elementwise.cu",
                          "troy_tpu/ops/poly.py:36"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs only "
                           "on a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name} (count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(line)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_kernels.build_seconds:.2f} s): {path.name}")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[2]   {line.strip()}")


def _uniform(rng, bounds, shape, device) -> torch.Tensor:
    """Words uniform in [0, bounds[l]) for limb l of a (..., k, n) shape."""
    lead = shape[:-2]
    cols = [rng.integers(0, b, size=lead + (1, shape[-1]), dtype=np.uint64)
            for b in bounds]
    return to_torch(np.concatenate(cols, axis=-2), device)


def _full(rng, shape, device) -> torch.Tensor:
    return to_torch(rng.integers(0, 2 ** 64, size=shape, dtype=np.uint64),
                    device)


def phase_kernels(ctx) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    rng = np.random.default_rng(SEED)
    dev = ctx.device
    key, data = ctx.key_context_data, ctx.first_context_data
    q6, q5, t1 = key.ntt, data.ntt, ctx.plain_ntt.rns
    used = q6.select(list(range(data.limbs)) + [key.limbs - 1])
    v6, v5 = used.values, q5.values
    tool = data.rns
    bsk_vals = data.bsk_ntt.values

    x_dec = _uniform(rng, [4 * q for q in v6], (5, 6, N), dev)
    x_inv = _uniform(rng, [2 * q for q in v6], (5, 6, N), dev)
    x_t = _uniform(rng, [4 * t1.values[0]], (1, 1, N), dev)
    x_ti = _uniform(rng, [2 * t1.values[0]], (1, 1, N), dev)
    lazy5 = [4 * q for q in v5]
    a1, b1 = (_uniform(rng, lazy5, (1, 2, 5, N), dev) for _ in range(2))
    a5 = _uniform(rng, v6, (5, 6, N), dev)
    b5 = _uniform(rng, v6, (5, 2, 6, N), dev)
    xq = _full(rng, (4, 5, N), dev)
    xb = _full(rng, (3, tool.b_to_q_m_sk.k_in, N), dev)
    ra, rb = (_uniform(rng, v5, (3, 5, N), dev) for _ in range(2))
    xs = _full(rng, (3, 5, N), dev)
    w, wq = q5.scalar_operand([int(data.plain_modulus)] * 5)

    checks = [
        # (kernel, variant, kernel call, plain call); first of each kernel
        # is the one whose time stands in the JSON line
        ("A_ntt", "forward k=6 (5,6,n)",
         lambda: ntt.rns_ntt_forward(x_dec, used),
         lambda: ntt.ntt_forward_plain(x_dec, used)),
        ("A_ntt", "forward k=6 (5,6,n) lazy",
         lambda: ntt.rns_ntt_forward(x_dec, used, lazy=True),
         lambda: ntt.ntt_forward_plain(x_dec, used, lazy=True)),
        ("A_ntt", "inverse k=6 (5,6,n)",
         lambda: ntt.rns_ntt_inverse(x_inv, used),
         lambda: ntt.ntt_inverse_plain(x_inv, used)),
        ("A_ntt", "inverse k=6 (5,6,n) lazy",
         lambda: ntt.rns_ntt_inverse(x_inv, used, lazy=True),
         lambda: ntt.ntt_inverse_plain(x_inv, used, lazy=True)),
        ("A_ntt", "forward k=1 mod t", lambda: ntt.rns_ntt_forward(x_t, t1),
         lambda: ntt.ntt_forward_plain(x_t, t1)),
        ("A_ntt", "forward k=1 mod t lazy",
         lambda: ntt.rns_ntt_forward(x_t, t1, lazy=True),
         lambda: ntt.ntt_forward_plain(x_t, t1, lazy=True)),
        ("A_ntt", "inverse k=1 mod t", lambda: ntt.rns_ntt_inverse(x_ti, t1),
         lambda: ntt.ntt_inverse_plain(x_ti, t1)),
        ("A_ntt", "inverse k=1 mod t lazy",
         lambda: ntt.rns_ntt_inverse(x_ti, t1, lazy=True),
         lambda: ntt.ntt_inverse_plain(x_ti, t1, lazy=True)),
        ("B_dyadic_mac", "J=5 key switch (5,6,n)x(5,2,6,n)",
         lambda: ntt.dyadic_mac(a5, b5, used),
         lambda: ntt.dyadic_mac_plain(a5.unsqueeze(1), b5, used)),
        ("B_dyadic_mac", "J=1 lazy (2,5,n)",
         lambda: ntt.dyadic_mac(a1, b1, q5),
         lambda: ntt.dyadic_mac_plain(a1, b1, q5)),
        ("C_base_convert", f"q->Bsk (4,5,n)->(4,{len(bsk_vals)},n)",
         lambda: rns.fast_convert(xq, tool.q_to_bsk),
         lambda: rns.fast_convert_plain(xq, tool.q_to_bsk)),
        ("C_base_convert", "q->Bsk+m~ (4,5,n)",
         lambda: rns.fast_convert(xq, tool.q_to_bsk_m_tilde),
         lambda: rns.fast_convert_plain(xq, tool.q_to_bsk_m_tilde)),
        ("C_base_convert", "B->q+m_sk (3,|B|,n)",
         lambda: rns.fast_convert(xb, tool.b_to_q_m_sk),
         lambda: rns.fast_convert_plain(xb, tool.b_to_q_m_sk)),
        ("C_base_convert", "q->{t,gamma} (3,5,n)",
         lambda: rns.fast_convert(xq[:3], tool.q_to_t_gamma),
         lambda: rns.fast_convert_plain(xq[:3], tool.q_to_t_gamma)),
        ("D_rns_elementwise", "scalar_mul (3,5,n)",
         lambda: poly._elementwise(poly.SCALAR_MUL, xs, None, q5, w, wq),
         lambda: poly.rns_elementwise_plain(poly.SCALAR_MUL, xs, None, q5,
                                            w, wq)),
        ("D_rns_elementwise", "add (3,5,n)",
         lambda: poly.rns_add(ra, rb, q5),
         lambda: poly.rns_elementwise_plain(poly.ADD, ra, rb, q5)),
        ("D_rns_elementwise", "sub (3,5,n)",
         lambda: poly.rns_sub(ra, rb, q5),
         lambda: poly.rns_elementwise_plain(poly.SUB, ra, rb, q5)),
        ("D_rns_elementwise", "neg (3,5,n)", lambda: poly.rns_neg(ra, q5),
         lambda: poly.rns_elementwise_plain(poly.NEG, ra, None, q5)),
    ]
    results = {}
    for kernel, variant, run, plain in checks:
        got, want = run(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{kernel} {variant}: shape {got.shape} "
                                 f"!= plain {want.shape}")
        # words as unsigned values; tolerance 0, they are integers
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"{kernel} {variant}: "
                                 f"{int((got != want).sum())} words differ "
                                 f"from the plain version (max |diff| {err})")
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        log(f"[3] {kernel:18s} {variant:34s} word-equal; kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms")
        entry = results.setdefault(kernel, {"max_abs_err": 0, "ms": ms,
                                            "plain_ms": plain_ms})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return results


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the words, read as unsigned 64-bit."""
    bad = got != want
    if not bool(bad.any()):
        return 0
    g = to_numpy(got[bad]).astype(object)
    w = to_numpy(want[bad]).astype(object)
    return int(max(abs(a - b) for a, b in zip(g, w)))


def phase_fixture(ctx) -> tuple:
    raw = P.interop.load_records(FIXTURE)
    if (list(ctx.key_context_data.coeff_values) != [int(x) for x in raw["q"]]
            or int(ctx.key_context_data.plain_modulus) != int(raw["t"][0])):
        raise AssertionError("moduli differ from the fixture's")

    def same(tensor, name):
        if not np.array_equal(to_numpy(tensor).reshape(-1), raw[name]):
            raise AssertionError(f"fixture record {name!r} differs")
        log(f"[4] {name}: word-equal to troy's C++ vectors")

    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED),
                        host_sampling=True)
    rlk = kg.create_relin_keys()
    log(f"[4] host keygen (sk + relin key): "
        f"{time.perf_counter() - t0:.1f} s")
    same(kg.secret_key.data, "sk")
    same(rlk.keys[2][0], "rlk_0")
    be = P.BatchEncoder(ctx)
    t = int(raw["t"][0])
    v1 = np.array([(i * i + 3 * i + 1) % t for i in range(N)], np.uint64)
    v2 = np.array([(7 * i + 2) % t for i in range(N)], np.uint64)
    cts = []
    for vals, tag in ((v1, "c1"), (v2, "c2")):
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(SEED), host_sampling=True)
        cts.append(enc.encrypt_symmetric(be.encode(vals)))
        same(cts[-1].data, tag)
    ev = P.Evaluator(ctx)
    prod = ev.multiply(*cts)
    same(prod.data, "prod")
    rel = ev.relinearize(prod, rlk)
    same(rel.data, "rel")
    dec = P.Decryptor(ctx, kg.secret_key)
    got = be.decode(dec.decrypt(rel))
    if not np.array_equal(got, raw["dec_rel"]):
        raise AssertionError("decode(decrypt(rel)) differs from dec_rel")
    log("[4] dec_rel: word-equal to troy's C++ vectors")
    return kg, rlk, be, ev, dec


def phase_requests(ctx, kg, rlk, be, ev, dec) -> float:
    rng = np.random.default_rng(SEED + 1)
    t = be.plain_modulus
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED + 1), host_sampling=True)
    for r in range(REQUESTS):
        a = rng.integers(0, t, N, dtype=np.uint64)
        b = rng.integers(0, t, N, dtype=np.uint64)
        ca = enc.encrypt_symmetric(be.encode(a))
        cb = enc.encrypt_symmetric(be.encode(b))
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        got = be.decode(dec.decrypt(rel))
        want = (a.astype(object) * b.astype(object) % t).astype(np.uint64)
        if not np.array_equal(got, want):
            raise AssertionError(f"request {r}: decrypt != a*b mod t")
        log(f"[5] request {r}: encrypt -> multiply -> relinearize -> "
            f"decrypt -> decode == a*b mod t")
    ms = cuda_ms(lambda: ev.relinearize(ev.multiply(ca, cb), rlk))
    log(f"[5] multiply+relinearize: median {ms:.4f} ms over {TIMING_REPS} "
        f"runs (CUDA events)")
    return ms


def main() -> None:
    name = phase_device()
    phase_build()
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20))
    ctx = P.HeContext(parms, device="cuda")
    kernel_results = phase_kernels(ctx)

    _kernels.reset_launch_counts()
    state = phase_fixture(ctx)
    mult_relin_ms = phase_requests(ctx, *state)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()

    log(f"[6] kernel launches in phases 4-5: {counts}")
    missing = [k for k in KERNELS if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    entries = []
    for kernel, (source, replaces) in KERNELS.items():
        r = kernel_results[kernel]
        entries.append({"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[kernel],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    log(json.dumps({"kernels": entries,
                    "mult_relin_ms": mult_relin_ms}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
