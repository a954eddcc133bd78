"""troy_tpu_torch stands alone: it imports no JAX, and it never hides a
missing card behind the CPU."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import troy_tpu_torch as P

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# A tiny BFV flow in a fresh interpreter in which importing jax or flax
# raises; afterwards neither may be in sys.modules.
FLOW = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    assert "jax" not in sys.modules

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                raise ImportError(f"troy_tpu_torch imported {name}")
            return None

    sys.meta_path.insert(0, _NoJax())

    import numpy as np
    import troy_tpu_torch as P
    from troy_tpu_torch import prng

    n = 64
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none)
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(1), host_sampling=True)
    be = P.BatchEncoder(ctx)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(2), host_sampling=True)
    t = be.plain_modulus
    a = np.arange(n, dtype=np.uint64) % t
    ev = P.Evaluator(ctx)
    ct = ev.relinearize(ev.multiply(enc.encrypt_symmetric(be.encode(a)),
                                    enc.encrypt_symmetric(be.encode(a))),
                        kg.create_relin_keys())
    got = be.decode(P.Decryptor(ctx, kg.secret_key).decrypt(ct))
    assert (got == (a * a) % t).all(), "wrong product"
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not loaded, loaded
    print("no-jax flow ok")
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-I", "-c", FLOW, str(REPO)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax flow ok" in proc.stdout


def test_cuda_context_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [40, 40])),
        plain_modulus=P.PlainModulus.batching(64, 17))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cuda")


def test_wrappers_run_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU never takes the plain path: the
    wrapper launches the kernel or raises."""
    from troy_tpu_torch.ops import ntt, poly, rns
    from troy_tpu_torch.utils.rns import make_rns_tool

    n = 64
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [40, 40]))
    tables = ntt.RnsNttTables.from_moduli(n, q, "cpu")
    tool = make_rns_tool(n, q, int(P.PlainModulus.batching(n, 17)))
    conv = rns.DeviceConverter.build(tool.conv_q_to_Bsk, "cpu")
    x = torch.zeros((2, n), dtype=torch.int64, device="meta")
    for call in (lambda: ntt.rns_ntt_forward(x, tables),
                 lambda: ntt.rns_ntt_inverse(x, tables),
                 lambda: ntt.rns_dyadic_mul(x, x, tables),
                 lambda: poly.rns_add(x, x, tables),
                 lambda: rns.fast_convert(x, conv)):
        with pytest.raises(ValueError, match="expected all on the CPU"):
            call()
