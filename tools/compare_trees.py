"""Compare two checkouts of troy_tpu_torch on the GPU: the headline's
ops and kernels B and K'' timed alone, the kernels' machine code, and a
run's kernels ranked by their loss.

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
    elif len(sys.argv) == 3 and sys.argv[1] == "rank":
        rank(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "sass":
        sass(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
