"""Compare two checkouts of troy_tpu_torch on the GPU: the headline's
ops and kernels B, K'', G and O4 timed alone, the kernels' machine code,
and a run's kernels ranked by their loss.

  python3 tools/compare_trees.py ops TAG
      Builds the kernels of the troy_tpu_torch package first on sys.path
      (PYTHONPATH naming a checkout's root selects that checkout; without
      it, this one) and times the BFV, CKKS and BGV mult+relin and the BFV
      decrypt at chip_smoke.py's headline (n = 16384, primes of 60, 40,
      40, 40, 40 and 60 bits, a 20-bit t for BFV and BGV) with
      chip_smoke.py's profiler tracing: TRACES traces an op, each giving
      the op's device us a call, kernel A's us a launch, and kernel B's
      launches and device us. Prints one line, "OPS TAG {json}". Time two
      checkouts in turns (a, b, b, a), one process each, on one card.

  python3 tools/compare_trees.py b TAG
  python3 tools/compare_trees.py kpp TAG
      The same package choice; chip_smoke.py's ``redesign_b`` (B at every
      shape of the headline's mult+relin, decrypt, encrypt and LWE pack,
      and B's launches and device us in each op) or ``standalone_kpp``
      (K'' at the LWE window's folds and the BGV mod switch). Prints "B
      TAG {json}" or "KPP TAG {json}".

  python3 tools/compare_trees.py g TAG
  python3 tools/compare_trees.py o4 TAG
      The same package choice, on the public API and the wrappers that
      both trees have. g: kernel G (ops/poly.py bfv_plain_embed) at m (n)
      onto c0 (5, n) and at a batch of 8, device us a call (a CUDA graph of
      20 calls, TRACES replays) and a launch (profiler); the three BFV
      encrypts (encrypt, encrypt_symmetric, encrypt_symmetric_many(8)) and
      BFV add_plain, device us a call (profiler, TRACES traces) and each
      one's launches of D, DG and G. o4: the CKKS encode's rounding with
      its statistic at (n) -> (5, n), AO4p where the tree has it, else O4
      (with its memset) then A's forward, device us a call (graph) and a
      launch (profiler), and encode_with_stats's device us a call
      (profiler). Prints "G TAG {json}" or "O4 TAG {json}". Time two
      checkouts in turns (a, b, b, a), one process each.

  python3 tools/compare_trees.py rank LOG
      Reads the per-kernel line of a chip_smoke.py run's output (the JSON
      line before the last in LOG) and ranks its kernels with this
      checkout's ``unredesigned_losses`` and RANKED: an earlier tree's run
      ranked as this one ranks, B included. Runs anywhere.

  python3 tools/compare_trees.py sass A.sass.gz B.sass.gz
      Compares two gzipped `cuobjdump -sass` listings kernel by kernel,
      keyed by the demangled name without its parameter list (a parameter
      added to a kernel changes its mangled name), the addresses and
      encodings dropped; prints how many kernels give the same code and
      the first lines where the others differ. Runs anywhere `c++filt`
      does.
"""

import gzip
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRACES = 8


def _chip_smoke():
    """chip_smoke.py of this checkout as a module, importing the package
    first on sys.path (this checkout's last)."""
    sys.path.append(str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _mult_relin(cs, scheme):
    """One mult+relin of two fresh encryptions at the headline, and the
    decrypt of its result, as callables."""
    P, np = cs.P, cs.np
    extra = {} if scheme == P.SchemeType.ckks else {
        "plain_modulus": P.PlainModulus.batching(cs.N, 20)}
    ctx = P.HeContext(P.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=cs.N,
        coeff_modulus=tuple(P.CoeffModulus.create(cs.N, cs.Q_BITS)), **extra))
    kg = P.KeyGenerator(ctx, seed=cs.rnd.seed_from_uint64(20))
    rlk = kg.create_relin_keys()
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=cs.rnd.seed_from_uint64(21))
    rng = np.random.default_rng(20)
    if scheme == P.SchemeType.ckks:
        ce = P.CKKSEncoder(ctx)
        pts = [ce.encode(rng.uniform(-1, 1, cs.N // 2), cs.CKKS_SCALE)
               for _ in range(2)]
    else:
        be = P.BatchEncoder(ctx)
        pts = [be.encode(rng.integers(0, 1000, cs.N)) for _ in range(2)]
    ca, cb = (enc.encrypt_symmetric(p) for p in pts)
    ev = P.Evaluator(ctx)
    mult_relin = lambda: ev.relinearize(ev.multiply(ca, cb), rlk)
    dec = P.Decryptor(ctx, kg.secret_key)
    rel = mult_relin()
    return mult_relin, lambda: dec.decrypt(rel)


def ops(tag: str) -> None:
    cs = _chip_smoke()
    cs.phase_device()
    cs.phase_build()
    out = {"package": str(pathlib.Path(cs.P.__file__).resolve().parent)}
    fns = {}
    for scheme in (cs.P.SchemeType.bfv, cs.P.SchemeType.ckks,
                   cs.P.SchemeType.bgv):
        mult_relin, decrypt = _mult_relin(cs, scheme)
        fns[f"{scheme.name}_mult_relin"] = mult_relin
        if scheme == cs.P.SchemeType.bfv:
            fns["bfv_decrypt"] = decrypt
    for name, fn in fns.items():
        rows = []
        for _ in range(TRACES):
            _, ms, each = cs.device_kernels_per_op(
                fn, expect={"ntt_pass_kernel": None}, whole=True)
            b = [v for k, v in each.items() if k in cs.B_KERNELS]
            rows.append({"device_us": ms * 1e3,
                         "a_us_per_launch": each["ntt_pass_kernel"][1],
                         "a_launches": each["ntt_pass_kernel"][0],
                         "b_launches": sum(c for c, _ in b),
                         "b_us": sum(c * us for c, us in b)})
        out[name] = {"traces": rows, **{
            f"median_{key}": statistics.median(r[key] for r in rows)
            for key in ("device_us", "a_us_per_launch", "b_us")}}
    print(f"OPS {tag} {json.dumps(out)}", flush=True)


def kernel_phase(tag: str, which: str) -> None:
    """``redesign_b`` or ``standalone_kpp`` of chip_smoke.py on the
    package first on sys.path."""
    cs = _chip_smoke()
    cs.phase_device()
    cs.phase_build()
    dev = cs.torch.device("cuda")
    out = (cs.redesign_b(dev) if which == "b" else cs.standalone_kpp(
        dev, cs.np.random.default_rng(cs.SEED + 35)))
    out["package"] = str(pathlib.Path(cs.P.__file__).resolve().parent)
    print(f"{which.upper()} {tag} {json.dumps(out)}", flush=True)


def _headline(cs, scheme):
    P = cs.P
    extra = {} if scheme == P.SchemeType.ckks else {
        "plain_modulus": P.PlainModulus.batching(cs.N, 20)}
    return P.HeContext(P.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=cs.N,
        coeff_modulus=tuple(P.CoeffModulus.create(cs.N, cs.Q_BITS)), **extra))


def _graph(cs, fn) -> list:
    return [cs.graph_us(fn) for _ in range(TRACES)]


def _profiled(cs, fn, kernels=()) -> dict:
    """Device us a call (profiler) over TRACES traces, and each of
    ``kernels``' us a launch."""
    rows = [cs.device_kernels_per_op(fn, reps=5) for _ in range(TRACES)]
    out = {"device_us": [r[1] * 1e3 for r in rows]}
    for k in kernels:
        out[f"{k}_us"] = [r[2][k][1] for r in rows if k in r[2]]
    return out


def _launches(cs, fn) -> dict:
    cs._kernels.reset_launch_counts()
    fn()
    cs.torch.cuda.synchronize()
    counts = cs._kernels.launch_counts()
    return {k: counts.get(k, 0) for k in ("D_rns_elementwise",
                                          "DG_zero_embed", "G_plain_embed",
                                          "I_sampling")}


def g_mode(tag: str) -> None:
    cs = _chip_smoke()
    cs.phase_device()
    cs.phase_build()
    P, np, torch, poly = cs.P, cs.np, cs.torch, cs.poly
    ctx = _headline(cs, P.SchemeType.bfv)
    data = ctx.first_context_data
    q5, dev = data.ntt, ctx.device
    rng = np.random.default_rng(22)
    tt = int(data.plain_modulus)
    args = (tt, data.coeff_modulus_mod_plain_modulus,
            data.coeff_div_plain_modulus, q5)
    m1, mb = (cs.to_torch(rng.integers(0, tt, lead + (cs.N,),
                                       dtype=np.uint64), dev)
              for lead in ((), (8,)))
    c0 = cs._uniform(rng, q5.values, (5, cs.N), dev)
    cb = cs._uniform(rng, q5.values, (8, 5, cs.N), dev)
    out = {"package": str(pathlib.Path(P.__file__).resolve().parent)}
    for name, fn in (("G (n)->(5,n)",
                      lambda: poly.bfv_plain_embed(m1, c0, *args)),
                     ("G (8,n)->(8,5,n)",
                      lambda: poly.bfv_plain_embed(mb, cb, *args))):
        out[name] = {"graph_us": _graph(cs, fn),
                     **_profiled(cs, fn, ("plain_embed_kernel",))}
    kg = P.KeyGenerator(ctx, seed=cs.rnd.seed_from_uint64(22))
    enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                      seed=cs.rnd.seed_from_uint64(23))
    pt = P.BatchEncoder(ctx).encode(rng.integers(0, tt, cs.N,
                                                 dtype=np.uint64))
    ct = enc.encrypt_symmetric(pt)
    ev = P.Evaluator(ctx)
    for name, fn in (("encrypt", lambda: enc.encrypt(pt)),
                     ("encrypt_symmetric", lambda: enc.encrypt_symmetric(pt)),
                     ("encrypt_symmetric_many8",
                      lambda: enc.encrypt_symmetric_many([pt] * 8)),
                     ("add_plain", lambda: ev.add_plain(ct, pt))):
        out[name] = {"launches": _launches(cs, fn),
                     **_profiled(cs, fn, ("plain_embed_kernel",
                                          "zero_embed_kernel",
                                          "rns_elementwise_kernel"))}
    print(f"G {tag} {json.dumps(out)}", flush=True)


def o4_mode(tag: str) -> None:
    cs = _chip_smoke()
    cs.phase_device()
    cs.phase_build()
    P, np, torch, emb, ntt = cs.P, cs.np, cs.torch, cs.embedding, cs.ntt
    ctx = _headline(cs, P.SchemeType.ckks)
    t = ctx.first_context_data.ntt
    tables = emb.make_embed_tables(cs.N, ctx.device)
    rt = emb.make_rns_round_tables(t)
    rng = np.random.default_rng(23)
    values = rng.uniform(-1, 1, cs.N // 2) + 1j * rng.uniform(-1, 1,
                                                             cs.N // 2)
    u = emb.embed_inverse_fft(torch.from_numpy(values).to(ctx.device),
                              tables)
    if hasattr(emb, "rns_ntt_forward_round_stats"):
        fn = lambda: emb.rns_ntt_forward_round_stats(
            u, tables.untwist, cs.CKKS_SCALE, rt, t)
    else:
        def fn():
            words, stat = emb.untwist_round_to_rns_stats(u, cs.CKKS_SCALE,
                                                         tables, rt)
            return ntt.rns_ntt_forward(words, t), stat
    words, stat = fn()
    ce = P.CKKSEncoder(ctx)
    out = {"package": str(pathlib.Path(P.__file__).resolve().parent),
           "statistic": float(stat),
           "round (n)->(5,n)": {"graph_us": _graph(cs, fn), **_profiled(
               cs, fn, ("ntt_pass_kernel", "round_kernel"))},
           "encode_with_stats": _profiled(
               cs, lambda: ce.encode_with_stats(values, cs.CKKS_SCALE))}
    print(f"O4 {tag} {json.dumps(out)}", flush=True)


def rank(log_path: str) -> None:
    cs = _chip_smoke()
    lines = [ln for ln in pathlib.Path(log_path).read_text().splitlines()
             if ln.startswith("{")]
    run = json.loads(lines[-2])
    results = {e["name"]: e for e in run["kernels"]}
    losses = cs.unredesigned_losses(run["kernels"], run["per_op"], results)
    print(f"RANK {json.dumps(losses)}", flush=True)


def _listing(path: str) -> dict:
    """{demangled name without parameters: its instructions}."""
    code, name = {}, None
    with gzip.open(path, "rt") as f:
        for line in f:
            found = re.match(r"\s+Function : (\S+)", line)
            if found:
                name = found.group(1)
                code[name] = []
                continue
            if name is None:
                continue
            text = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            text = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", text).strip()
            if text:
                code[name].append(text)
    names = list(code)
    demangled = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    out = {}
    for mangled, full in zip(names, demangled):
        depth, cut = 0, len(full)
        for i, ch in enumerate(full):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0 and i > 0 and full[i - 1] != " ":
                cut = i
                break
        out[full[:cut]] = code[mangled]
    return out


def sass(a_path: str, b_path: str) -> None:
    a, b = _listing(a_path), _listing(b_path)
    both = [f for f in a if f in b]
    same = [f for f in both if a[f] == b[f]]
    print(f"{len(a)} kernels in the first, {len(b)} in the second, "
          f"{len(both)} in both: {len(same)} give the same code")
    for f in (f for f in b if f not in a):
        print(f"only in the second: {f}")
    for f in (f for f in a if f not in b):
        print(f"only in the first: {f}")
    for f in (f for f in both if a[f] != b[f]):
        print(f"differs: {f}: {len(a[f])} against {len(b[f])} instructions")
        shown = [(x, y) for x, y in zip(a[f], b[f]) if x != y][:4]
        for x, y in shown:
            print(f"    first:  {x}\n    second: {y}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "ops":
        ops(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] in ("b", "kpp"):
        kernel_phase(sys.argv[2], sys.argv[1])
    elif len(sys.argv) == 3 and sys.argv[1] == "g":
        g_mode(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "o4":
        o4_mode(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "rank":
        rank(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "sass":
        sass(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
