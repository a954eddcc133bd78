"""The harness: one cell's scheme, its closed request loop, the traced
sub-window and the check of the kept outputs.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file, ``workloads/<cell>.json`` its traffic and
request kind, ``requests/<kind>.py`` how the program serves a request,
``reference/<kind>.py`` the inputs and the answer, ``metrics/<metric>.py``
each per-layer reader.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import re
import statistics
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# requests drawn ahead of the window; a window of 51 s at the fastest
# cell's rate takes a fraction of them
DRAWN = 400_000
FORBIDDEN = ("jax", "jaxlib", "flax", "troy_tpu")
# the end-to-end metrics of a cell made outside BENCHMARK.json (the tests)
HOST_METRICS = ("req_per_s", "latency_ms_p50", "latency_ms_p95", "setup_s")
# fed chunks (``fed_loop``): the first spin as a multiple of the chunk's
# host enqueue time, the longest spin, and how many chunks the host may
# fail to queue in time before the run fails
FED_SPIN_FACTOR = 4.0
FED_SPIN_MIN_S = 0.005
FED_SPIN_MAX_S = 4.0
FED_MISSES = 12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(package: str, name: str):
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"{package}: no module may be named {name!r}")
    return importlib.import_module(f"hebench.{package}.{name}")


class Cell:
    """A cell of BENCHMARK.json with its configuration, its workload file
    and the end-to-end and per-layer metrics it reports."""

    def __init__(self, name: str, cfg: dict, wl: dict, chips: int = 1,
                 per_layer: Optional[list] = None,
                 end_to_end: Optional[list] = None):
        self.name, self.cfg, self.wl, self.chips = name, cfg, wl, chips
        self.per_layer = per_layer or []
        self.end_to_end = end_to_end or [{"name": m} for m in HOST_METRICS]
        self.kind = module("requests", wl["kind"])
        self.ref = module("reference", wl["kind"])

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        entry = found[0]
        config = [c for c in bench["configs"]
                  if c["name"] == entry["config"]][0]
        wl = load_json(root / "hebench" / "workloads" / f"{name}.json")
        if wl["config"] != entry["config"]:
            raise SystemExit(f"{name}: the workload file names config "
                             f"{wl['config']}, BENCHMARK.json "
                             f"{entry['config']}")
        mine = [[m for m in bench[group] if name in m.get("workloads",
                                                          [name])]
                for group in ("per_layer", "end_to_end")]
        return cls(name, load_json(root / config["file"]), wl,
                   entry["chips"], *mine)


class Seeds:
    """Independent streams drawn from the run's seed."""

    def __init__(self, seed: int):
        root = np.random.SeedSequence(seed % (1 << 64))
        kids = root.spawn(7)
        self.secret, self.inputs, self.draws, self.sample = (
            np.random.default_rng(k) for k in kids[:4])
        self.keygen, self.encrypt = (
            int(k.generate_state(1, np.uint64)[0]) for k in kids[4:6])
        self.fed = np.random.default_rng(kids[6])


class Scheme:
    """The program's BFV objects for a configuration, on ``device``: the
    context of the configuration's primes, a ternary secret key drawn from
    the seed (handed to the program in NTT form), the key generator that
    makes the switching keys from it on the device, a symmetric encryptor,
    the evaluator and the encoder."""

    def __init__(self, cfg: dict, wl: dict, seeds: Seeds, secret: np.ndarray,
                 device):
        import troy_tpu_torch as P
        from troy_tpu_torch import prng
        from troy_tpu_torch.ops import ntt
        self.cfg, self.wl, self.device = cfg, wl, torch.device(device)
        primes = [int(q) for q in cfg["coeff_modulus"]]
        parms = P.EncryptionParameters(
            scheme=P.SchemeType.bfv,
            poly_modulus_degree=cfg["poly_modulus_degree"],
            coeff_modulus=tuple(P.Modulus(q) for q in primes),
            plain_modulus=P.Modulus(cfg["plain_modulus"]))
        self.ctx = P.HeContext(parms, sec_level=P.SecurityLevel[cfg[
            "security"]], device=self.device)
        key = self.ctx.key_context_data
        if [int(q) for q in key.coeff_values] != primes:
            raise RuntimeError("the program's key base differs from the "
                               "configuration's primes")
        s = secret.astype(np.int64)
        rns = np.stack([(s % q).astype(np.uint64) for q in primes])
        sk = P.SecretKey(data=ntt.rns_ntt_forward(
            torch.from_numpy(rns.view(np.int64)).to(self.device), key.ntt))
        self.keygen = P.KeyGenerator(self.ctx, sk,
                                     prng.seed_from_uint64(seeds.keygen))
        self.enc = P.Encryptor(self.ctx, secret_key=sk,
                               seed=prng.seed_from_uint64(seeds.encrypt))
        self.ev = P.Evaluator(self.ctx)
        self.be = P.BatchEncoder(self.ctx)

    def encrypt_pool(self, messages: np.ndarray) -> list:
        """Symmetric encryptions of coefficient polynomials."""
        return [self.enc.encrypt_symmetric(self.be.encode_polynomial(m))
                for m in messages]


class HostEvent:
    """A CUDA event's stand-in where every op runs on the host (the CPU
    runs of the tests): recording reads the host clock."""

    def __init__(self, enable_timing: bool = False):
        self.at = None

    def record(self) -> None:
        self.at = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def query(self) -> bool:
        """Not yet passed: a fed chunk's span on the host times its ops."""
        return False

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.at - self.at) * 1e3


def event_type(on_card: bool):
    return torch.cuda.Event if on_card else HostEvent


def synchronize(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


class Stages:
    """The stage hook a request kind wraps each call in: nothing in an
    untraced run; in a traced run an event on each side of the call (the
    stage's device span) and a profiler range named after it."""

    def __init__(self, on: bool, event=torch.cuda.Event):
        self.on, self.event = on, event
        self.spans = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        start = self.event(enable_timing=True)
        end = self.event(enable_timing=True)
        with torch.profiler.record_function(f"hebench.{name}"):
            start.record()
            yield
            end.record()
        self.spans[name].append((start, end))

    def means_ms(self) -> dict:
        return {k: statistics.fmean(a.elapsed_time(b) for a, b in v)
                for k, v in self.spans.items()}


class Reservoir:
    """A uniform sample of ``size`` requests' outputs out of all completed,
    drawn from the seed (reservoir sampling): the window's j-th request
    replaces a kept one with probability size / (j + 1)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.kept = {}
        self.slots = [None] * size
        self.seen = 0

    def offer(self, i: int, make) -> None:
        """Request i, the window's ``seen``-th, may replace a kept one."""
        j, self.seen = self.seen, self.seen + 1
        slot = j if j < self.size else int(self.rng.integers(0, j + 1))
        if slot < self.size:
            old = self.slots[slot]
            if old is not None:
                del self.kept[old]
            self.slots[slot] = i
            self.kept[i] = make()


def closed_loop(issue, reqs, inflight: int, seconds: float, stages: Stages,
                reservoir: Optional[Reservoir] = None, keep=None,
                first: int = 0, stop: Optional[int] = None) -> dict:
    """Issue requests reqs[first:] with ``inflight`` outstanding on the
    current stream for ``seconds`` of host time, then drain; the reservoir
    holds ``keep(output)`` of its sample (no copy). Each request
    is followed by a CUDA event; the harness waits on the oldest only when
    ``inflight`` are outstanding. Returns the latencies (issue to the
    harness seeing the event done), the host enqueue times, the count and
    the window's bounds on the host clock. ``stop``: issue no request from
    that index on."""
    pending = collections.deque()
    lat, enqueue = [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    i = first

    def retire():
        _, at, event = pending.popleft()
        event.synchronize()
        lat.append(time.perf_counter() - at)

    while stop is None or i < stop:
        at = time.perf_counter()
        if at >= end:
            break
        out = issue(reqs[i], stages)
        enqueue.append(time.perf_counter() - at)
        event = stages.event()
        event.record()
        if reservoir is not None:
            reservoir.offer(i, lambda: keep(out))
        del out
        pending.append((i, at, event))
        i += 1
        if len(pending) >= inflight:
            retire()
        if stop is None and i >= len(reqs):
            raise RuntimeError("the window outran the drawn requests")
    while pending:
        retire()
    return {"latency_s": lat, "enqueue_s": enqueue, "count": i - first,
            "start": t0, "end": time.perf_counter(), "next": i}


class FedLate(RuntimeError):
    pass


def spin_clock(event=torch.cuda.Event, sleep=torch.cuda._sleep) -> float:
    """Cycles a second of the card's spin kernel, timed by CUDA events."""
    cycles = 20_000_000
    sleep(1000)
    a, b = event(enable_timing=True), event(enable_timing=True)
    a.record()
    sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) * 1e-3)


def fed_loop(issue, reqs, first: int, requests: int, chunk: int,
             enqueue_s: float, stages: Stages, keep_pos: int, keep,
             clock: float, event=torch.cuda.Event,
             sleep=torch.cuda._sleep) -> dict:
    """The card's rate with its queue filled ahead. ``requests`` requests
    from reqs[first:], in chunks of ``chunk``: each chunk is queued behind
    a spin kernel that outlasts the host's enqueue of the chunk (``clock``:
    the spin's cycles a second) and timed by CUDA events from the spin's
    end to the chunk's end, so that neither the host's pace nor its stalls
    fall inside a span. A chunk whose start the card reached before the
    host had queued all of it is not counted: its requests are issued
    again behind a spin twice as long; after ``FED_MISSES`` such chunks
    the run fails. Returns the requests counted (always ``requests``),
    their device seconds, the chunks missed, the output of request
    ``first + keep_pos`` taken with ``keep``, and the next index."""
    spin_s = max(FED_SPIN_FACTOR * chunk * enqueue_s, FED_SPIN_MIN_S)
    spans, kept, misses, pos = [], None, 0, 0
    while pos < requests:
        n = min(chunk, requests - pos)
        sleep(int(spin_s * clock))
        start = event(enable_timing=True)
        end = event(enable_timing=True)
        start.record()
        for j in range(pos, pos + n):
            out = issue(reqs[first + j], stages)
            if j == keep_pos and kept is None:
                kept = keep(out)
            del out
        end.record()
        if start.query():
            misses += 1
            if misses > FED_MISSES:
                raise FedLate(f"the host queued {misses} chunks of {n} "
                              f"too late, the last behind a spin of "
                              f"{spin_s:.3f} s")
            spin_s = min(2 * spin_s, FED_SPIN_MAX_S)
            continue
        spans.append((start, end))
        pos += n
    spans[-1][1].synchronize()
    return {"requests": requests, "misses": misses, "kept": kept,
            "device_s": sum(a.elapsed_time(b) for a, b in spans) * 1e-3,
            "next": first + requests}


def quantile(values, q: float) -> float:
    """The q-quantile by Python's ``statistics.quantiles`` (exclusive)."""
    cuts = statistics.quantiles(values, n=100)
    return cuts[round(q * 100) - 1]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: troy_tpu_torch is not troy_tpu)."""
    import sys
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(cell: Cell, data: dict, secret: np.ndarray, kept: dict,
          reqs: np.ndarray) -> dict:
    """Decrypt each kept output with the reference and compare every
    compared word with the reference's answer: words compared, words
    wrong, outputs, requests with a wrong word, the least noise budget
    in bits."""
    from hebench.reference import bfv
    cfg = cell.cfg
    ref = bfv.Bfv(cfg["coeff_modulus"][:-1], cfg["plain_modulus"], secret)
    words = wrong = outputs = failed = 0
    budget = None
    for i in sorted(kept):
        before = wrong
        answers = cell.ref.expected(cfg, cell.wl, data, reqs[i])
        cts = kept[i]
        for k, (idx, want) in enumerate(answers):
            outputs += 1
            words += want.size
            ct = cts[k] if k < len(cts) else None
            if ct is None or ct.shape != (2, len(ref.primes), ref.s.size):
                wrong += want.size    # missing, or no size-2 ciphertext
                continue
            m, bits = ref.decrypt(ct)
            got = m if idx is None else m[idx]
            wrong += int((got != want).sum())
            budget = bits if budget is None else min(budget, bits)
        failed += wrong > before
    return {"words": words, "wrong": wrong, "outputs": outputs,
            "failed_requests": failed, "noise_budget_bits": budget}


def read_metric(name: str, readings: dict):
    """A per-layer metric from ``metrics/<name>.py``; a dotted name
    ``<base>.<part>`` from ``metrics/<base>.py`` with the part as its
    argument. None where the reader finds nothing to read."""
    base, _, part = name.partition(".")
    return module("metrics", base).read(readings, part or None)


def host_words(tensors) -> list:
    """Kept device tensors as numpy u64 words."""
    return [t.cpu().numpy().view(np.uint64) for t in tensors]
