"""K3/K4's shape rules, summation order and build inputs, on the CPU.

``tap_kernel_misfit`` states once what the C entries of
``csrc/tap_structure.cu`` refuse (their ``shape_ok``): whole 64 x 64 tiles,
the contraction they are compiled for (1152, in taps of 128 for K3 or in
one segment for K4), reps >= 0. The wrapper raises with its message on a
CUDA tensor; this box has none, so the rules are held here as a pure
function. The experiment raises without a CUDA device rather than fall
back.

The kernels split each 64 x 64 tile's contraction over a pair of blocks:
rank r takes the k-blocks (of 64) r, r + 2, ..., forms a fresh float32
partial per (repetition, segment) over its k-blocks, adds it to its own
accumulator, and the pair's two accumulators are summed at the end. A plain
model of that order is held against ``taps_kernel`` / ``big_kernel`` of
``experiments/pallas_tap_structure.py`` in interpret mode at the shrunk
shape of tests/test_torch_tap_structure.py (M = K = N = 16, REPS 2), with
k-blocks of 8 so that, as at full size, a tap of K3 is one k-block for each
rank and K4's contraction is 18 k-blocks, 9 for each. Tolerance 2^-7
relative, as there: both sum float32 products in other orders and round
once to bf16.

``build.library_path`` hashes the headers of ``csrc/`` with each source, so
an edited header rebuilds every kernel."""
import shutil

import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu_torch.experiments import tap_structure
from pl_convlstm_gan_tpu_torch.ops.kernels import build
from pl_convlstm_gan_tpu_torch.ops.kernels.tap_structure_kernel import (
    TAPS, tap_k1152, tap_kernel_misfit, tap_loop)
from test_torch_tap_structure import (_bf16_pair, _check,  # noqa: F401
                                      _interpret, p5)

M, K, N, REPS = tap_structure.M, tap_structure.K, tap_structure.N, \
    tap_structure.REPS


def test_experiment_shape_fits_both_kernels():
    assert tap_kernel_misfit(M, N, TAPS * K, K, REPS) is None        # K3
    assert tap_kernel_misfit(M, N, TAPS * K, TAPS * K, REPS) is None  # K4
    assert tap_kernel_misfit(M, N, TAPS * K, K, 0) is None
    assert tap_kernel_misfit(64, 64, TAPS * K, K, 1) is None


@pytest.mark.parametrize("shape, names", [
    ((1000, N, TAPS * K, K, REPS), "tile's 64 rows"),
    ((0, N, TAPS * K, K, REPS), "tile's 64 rows"),
    ((64 * 65536, N, TAPS * K, K, REPS), "65535 row tiles"),
    ((M, 224, TAPS * K, K, REPS), "tile's 64 columns"),
    ((M, N, 9 * 64, 64, REPS), "compiled for 1152"),
    ((M, N, TAPS * K, 256, REPS), "compiled for 1152"),
    ((M, N, 2 * TAPS * K, 2 * TAPS * K, REPS), "compiled for 1152"),
    ((M, N, TAPS * K, K, -1), "negative"),
])
def test_each_rule_is_named(shape, names):
    msg = tap_kernel_misfit(*shape)
    assert msg is not None and names in msg, msg


def test_experiment_raises_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap_structure.run(reps=1, iters=1)


@pytest.mark.parametrize("kernel, shapes", [
    (tap_loop, ((TAPS, 64, K), (TAPS, K, 64))),
    (tap_k1152, ((64, TAPS * K), (TAPS * K, 64))),
])
def test_only_cpu_tensors_take_the_plain_version(kernel, shapes):
    """A tensor off the CPU (here on the meta device) goes to the kernel's
    checks, which raise; it never falls back to the plain version."""
    a, w = (torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in shapes)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel(a, w, 1)


def _pair_order(a_segs, w_segs, reps, bk):
    """bf16 of the float32 sum as the paired kernels form it. a_segs [S, M,
    seg], w_segs [S, seg, N]: S segments a repetition (K3: the 9 taps, K4:
    one); k-blocks of bk; rank r takes k-blocks r, r + 2, ... of every
    segment, a fresh partial per (repetition, segment) added to its own
    accumulator; out = acc_0 + acc_1."""
    a, w = a_segs.float(), w_segs.float()
    segs, m, seg = a.shape
    accs = []
    for rank in range(2):
        cols = torch.cat([torch.arange(j * bk, (j + 1) * bk)
                          for j in range(rank, seg // bk, 2)])
        acc = torch.zeros(m, w.shape[-1])
        for _ in range(reps):
            for s in range(segs):
                acc = acc + a[s][:, cols] @ w[s][cols]
        accs.append(acc)
    return (accs[0] + accs[1]).to(torch.bfloat16)


def test_pair_order_matches_taps_kernel(p5):
    m, k, n, taps, reps = p5.M, p5.K, p5.N, p5.TAPS, p5.REPS
    rng = np.random.default_rng(0)
    a9_j, a9 = _bf16_pair(rng, (taps, m, k))
    w9_j, w9 = _bf16_pair(rng, (taps, k, n))
    want = _interpret(p5.taps_kernel, m, n, a9_j, w9_j)
    _check(_pair_order(a9, w9, reps, k // 2), want)


def test_pair_order_matches_big_kernel(p5):
    m, k, n, taps, reps = p5.M, p5.K, p5.N, p5.TAPS, p5.REPS
    rng = np.random.default_rng(0)
    abig_j, abig = _bf16_pair(rng, (m, taps * k))
    wbig_j, wbig = _bf16_pair(rng, (taps * k, n))
    want = _interpret(p5.big_kernel, m, n, abig_j, wbig_j)
    _check(_pair_order(abig[None], wbig[None], reps, k // 2), want)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that build.library_path reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("source", build.SOURCES)
def test_editing_a_header_changes_every_library_path(csrc_copy, source):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert [h.name for h in headers] == ["cell_tile.cuh", "head_tile.cuh",
                                         "hopper.cuh"]
    for header in headers:
        before = build.library_path(source)
        assert build.library_path(source) == before      # stable
        with header.open("a") as f:
            f.write("// edited\n")
        assert build.library_path(source) != before


def test_editing_a_source_changes_only_its_library_path(csrc_copy):
    before = {name: build.library_path(name) for name in build.SOURCES}
    with (csrc_copy / "tap_structure.cu").open("a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert after["tap_structure"] != before["tap_structure"]
    assert after["convlstm_cell"] == before["convlstm_cell"]
    assert after["conv_head"] == before["conv_head"]
