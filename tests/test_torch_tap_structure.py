"""The tap-structure experiment's plain versions against its TPU kernels.

``taps_plain`` / ``big_plain`` (the plain versions of K3 and K4,
``ops/kernels/tap_structure_kernel.py``) against ``taps_kernel`` and
``big_kernel`` of ``experiments/pallas_tap_structure.py`` (TPU kernel P5),
run through ``pl.pallas_call`` in interpret mode with VMEM specs, as the
script's ``main`` calls them. The script is loaded from its file and its
shape constants shrunk with ``monkeypatch.setattr`` (the kernels read M, N,
TAPS and REPS when traced). Operands: the script's seed-0 numpy draws in
bf16. Tolerance: 2 bf16 ulps relative (2^-7): both sides sum float32
products, in other orders, and round once to bf16, so an output may land
one ulp apart where its float32 value straddles a rounding point."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pl_convlstm_gan_tpu_torch.experiments import tap_structure
from pl_convlstm_gan_tpu_torch.ops.kernels.tap_structure_kernel import (
    big_plain, tap_k1152, tap_loop, taps_plain)

SCRIPT = Path(__file__).resolve().parents[1] / "experiments" / \
    "pallas_tap_structure.py"
RTOL = 2.0 ** -7


@pytest.fixture
def p5(monkeypatch):
    """experiments/pallas_tap_structure.py as a module, shrunk to M = K =
    N = 16 and REPS = 2 (TAPS stays 9)."""
    spec = importlib.util.spec_from_file_location("pallas_tap_structure",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("M", 16), ("K", 16), ("N", 16), ("REPS", 2)):
        monkeypatch.setattr(mod, name, value)
    return mod


def _interpret(kernel, m, n, *args):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(*args)


def _bf16_pair(rng, shape):
    """One draw as the script makes it (jnp bf16) and as the port takes it
    (torch bf16 of the same values, exactly, through float32)."""
    j = jnp.asarray(rng.random(shape), dtype=jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _check(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.abs(want).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_taps_plain_matches_taps_kernel(p5):
    m, k, n, taps, reps = p5.M, p5.K, p5.N, p5.TAPS, p5.REPS
    rng = np.random.default_rng(0)
    a9_j, a9 = _bf16_pair(rng, (taps, m, k))
    w9_j, w9 = _bf16_pair(rng, (taps, k, n))
    want = _interpret(p5.taps_kernel, m, n, a9_j, w9_j)
    _check(taps_plain(a9, w9, reps), want)
    _check(tap_loop(a9, w9, reps), want)      # CPU tensors: the plain version


def test_big_plain_matches_big_kernel(p5):
    m, k, n, taps, reps = p5.M, p5.K, p5.N, p5.TAPS, p5.REPS
    rng = np.random.default_rng(0)
    abig_j, abig = _bf16_pair(rng, (m, taps * k))
    wbig_j, wbig = _bf16_pair(rng, (taps * k, n))
    want = _interpret(p5.big_kernel, m, n, abig_j, wbig_j)
    _check(big_plain(abig, wbig, reps), want)
    _check(tap_k1152(abig, wbig, reps), want)


def test_experiment_uses_the_scripts_constants_and_operands():
    """The port's experiment keeps the TPU script's shape constants, and
    its operands are the script's seed-0 draws in the same order, equal in
    bf16 to the script's own jnp.asarray(..., dtype=bfloat16) cast."""
    spec = importlib.util.spec_from_file_location("pallas_tap_structure",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("M", "K", "N", "TAPS", "REPS"):
        assert getattr(tap_structure, name) == getattr(mod, name), name
    rng = np.random.default_rng(0)
    for got, shape in zip(tap_structure.operands("cpu"), (
            (mod.TAPS, mod.M, mod.K), (mod.TAPS, mod.K, mod.N),
            (mod.M, mod.TAPS * mod.K), (mod.TAPS * mod.K, mod.N))):
        want = np.asarray(jnp.asarray(rng.random(shape), dtype=jnp.bfloat16),
                          np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert tap_structure.flops() == 2 * 1024 * 1152 * 256 * 64
