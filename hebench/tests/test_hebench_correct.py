"""The check that decides ``correct`` has to fail where the answers are
wrong: its control (the reference in the program's place, with its word
products in float64) and whole runs of the harness on the CPU with the
timed path broken underneath.

The faults, for each request kind: the step returns its input unchanged;
half of each output left out (the upper half of a ciphertext's
coefficients, or the second half of a grid's ciphertexts, zero); one
answer altered where it is produced (the plaintext's coefficient at a
compared position moved by one, Delta added to c0 there). The exchange
between chips does not exist: every cell runs on one card.
"""

import time

import numpy as np
import pytest
import torch

from hebench import control, run
from hebench.reference import app
from hebench.tests import tiny

KINDS = sorted(tiny.WORKLOADS)


@pytest.mark.parametrize("kind", KINDS)
def test_control_fails_and_reference_passes(kind):
    """At a tiny ring with the cells' prime widths (55 and 60 bits)."""
    r = control.readings(tiny.cell(kind), 2**31 + 99)
    assert r["exact"]["wrong_words"] == 0 and r["exact"]["words"] > 0
    assert r["control"]["wrong_words"] > r["control"]["words"] // 4


def _first_compared(cell) -> int:
    """A coefficient index that the check compares in the first output."""
    wl = cell.wl
    if wl["kind"] == "conv2d":
        return int(app.conv2d_layout(wl["image"], wl["kernel"],
                                     wl["channels"], wl["blocks"])[0][0][0])
    return 0


def _each_ct(out, fn):
    """out with fn applied to every ciphertext (a Ciphertext or a grid)."""
    from troy_tpu_torch.app import linear
    if isinstance(out, linear.Cipher2d):
        return linear.Cipher2d([[fn(c) for c in row] for row in out.data])
    return fn(out)


def _half_coeffs(ct):
    data = ct.data.clone()
    data[..., data.shape[-1] // 2:] = 0
    return ct.replace(data=data)


def _half(out):
    """A grid of two or more ciphertexts with its second half zero, or each
    ciphertext with its upper half of coefficients zero."""
    from troy_tpu_torch.app import linear
    flat = ([c for row in out.data for c in row]
            if isinstance(out, linear.Cipher2d) else [out])
    if len(flat) >= 2:
        keep = len(flat) // 2
        zero = [c.replace(data=torch.zeros_like(c.data)) for c in flat]
        flat = flat[:keep] + zero[keep:]
        cols = len(out.data[0])
        return linear.Cipher2d([flat[i:i + cols]
                                for i in range(0, len(flat), cols)])
    return _each_ct(out, _half_coeffs)


def _altered(cell, where: int):
    """Each call's first output ciphertext decrypts to its answer with the
    coefficient ``where`` one more."""
    cfg = cell.cfg
    primes = cfg["coeff_modulus"][:-1]
    Q = 1
    for q in primes:
        Q *= q
    delta = Q // cfg["plain_modulus"]

    def alter(ct):
        data = ct.data.clone()
        for i, q in enumerate(primes):
            w = int(data[0, i, where].numpy().view(np.uint64))
            data[0, i, where] = int(np.uint64((w + delta) % q).view(np.int64))
        return ct.replace(data=data)

    def first_only(out):
        from troy_tpu_torch.app import linear
        if isinstance(out, linear.Cipher2d):
            rows = [list(r) for r in out.data]
            rows[0][0] = alter(rows[0][0])
            return linear.Cipher2d(rows)
        return alter(out)
    return first_only


def _patch(monkeypatch, kind, make):
    """Break the timed path's last program call of each request kind:
    ``make(fn)`` wraps it."""
    import troy_tpu_torch as P
    from troy_tpu_torch.app import linear
    targets = {"mul_relin": [(P.Evaluator, "relinearize")],
               "conv2d": [(linear.Conv2dHelper, "conv2d")]}
    for owner, name in targets[kind]:
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))


def _unchanged(fn):
    def broken(self, *args, **kw):
        return next(a for a in args if not isinstance(a, (int, type(None)))
                    and type(a).__name__ in ("Ciphertext", "Cipher2d"))
    return broken


def _after(transform):
    def make(fn):
        def broken(*args, **kw):
            return transform(fn(*args, **kw))
        return broken
    return make


def _run(cell):
    out = run.run_cell(cell, 2**32 + 31, 0.3, False, device="cpu",
                       t_start=time.perf_counter())
    return run.result_line(out, 1, "cpu-test")


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(kind):
    assert _run(tiny.cell(kind))["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", KINDS)
def test_fault_is_caught(monkeypatch, kind, fault):
    cell = tiny.cell(kind)
    cell.wl["sample"] = 1 if fault == "altered" else cell.wl["sample"]
    make = {"unchanged": _unchanged, "half": _after(_half),
            "altered": lambda fn: _after(
                _altered(cell, _first_compared(cell)))(fn)}[fault]
    _patch(monkeypatch, kind, make)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checked"]["wrong_words"]["value"] > 0
    if fault == "altered":
        assert line["checked"]["wrong_words"]["value"] == 1
