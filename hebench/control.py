"""The control of the check that decides ``correct``, at a cell's own size.

    python3 hebench/control.py --workload <cell> --seeds 11,12,13

For each seed it draws the run's secret key, inputs and requests, takes
the ``sample`` requests a run would check, and puts the reference in the
program's place: each output ciphertext is a fresh encryption of the
reference's answer under the seed's key. Once at the configuration's
precision (every 64-bit word product exact) and once at the nearest lower
one, the control: the products of the encryption's 55- or 60-bit words by
the key taken in float64, as an FP64 product path would. Both go through
the run's own judge; the first has to read 0 wrong words, the control
more than 0. Prints one JSON line a seed. Runs on the host (NumPy only);
the benchmark's runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int) -> dict:
    """The judge's readings of the reference in the program's place, exact
    and in the lower precision."""
    import numpy as np
    from hebench import harness as h
    from hebench.reference import bfv
    cfg, wl = cell.cfg, cell.wl
    seeds = h.Seeds(seed)
    secret = bfv.ternary_secret(seeds.secret, cfg["poly_modulus_degree"])
    data = cell.ref.inputs(cfg, wl, seeds.inputs)
    reqs = cell.ref.draw(wl, seeds.draws, wl["warm"] + wl["sample"])
    chosen = range(wl["warm"], wl["warm"] + wl["sample"])
    ref = bfv.Bfv(cfg["coeff_modulus"][:-1], cfg["plain_modulus"], secret)
    rng = np.random.default_rng(seed % (1 << 64))
    out = {"seed": seed}
    for name, exact in (("exact", True), ("control", False)):
        kept = {}
        for i in chosen:
            cts = []
            for idx, want in cell.ref.expected(cfg, wl, data, reqs[i]):
                m = want if idx is None else np.zeros(
                    cfg["poly_modulus_degree"], np.uint64)
                if idx is not None:
                    m[idx] = want
                cts.append(ref.encrypt(m, rng, exact))
            kept[i] = cts
        t0 = time.perf_counter()
        v = h.judge(cell, data, secret, kept, reqs)
        out[name] = {"wrong_words": v["wrong"], "words": v["words"],
                     "outputs": v["outputs"],
                     "judge_s": time.perf_counter() - t0}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    from hebench import harness as h
    cell = h.Cell.load(a.workload)
    failed = 0
    for seed in (int(x) for x in a.seeds.split(",")):
        r = readings(cell, seed)
        print(json.dumps(r), flush=True)
        failed += r["exact"]["wrong_words"] != 0 or r["control"][
            "wrong_words"] == 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
