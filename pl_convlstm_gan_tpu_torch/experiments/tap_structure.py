"""Experiment: the structure of the ConvLSTM cell's contraction on Hopper.

    python -m pl_convlstm_gan_tpu_torch.experiments.tap_structure   # one GPU

Counterpart of ``experiments/pallas_tap_structure.py`` (TPU kernel P5). The
question: is the 9-tap loop (9 contractions of K = 128, an implicit GEMM
over the taps of a 3x3 conv) slower than one contraction of K = 9 * 128 =
1152 (one im2col GEMM)? Same constants and the same seed-0 numpy operands
as the TPU script: a9 [9, M, K] and w9 [9, K, N], abig [M, 9K] and wbig
[9K, N], bf16, each kernel REPS repetitions with a float32 accumulator, out
[M, N] bf16. K3 (``tap_loop``) and K4 (``tap_k1152``) of
``csrc/tap_structure.cu`` stage a block's operands once in shared memory
(the TPU kernels find theirs in VMEM) and repeat the fragment loads and the
``mma.sync`` of every repetition, with one tiling for both.

Prints the TPU script's two lines, ``<name> ms <t> TFLOP/s <rate>``; the
time is the median over ``ROUNDS`` rounds of the mean of ``ITERS``
back-to-back launches between two CUDA events.
Raises without a CUDA device.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from ..ops.kernels.tap_structure_kernel import tap_k1152, tap_loop

M, K, N, TAPS, REPS = 1024, 128, 256, 9, 64
ITERS, ROUNDS = 10, 5


def operands(device):
    """(a9, w9, abig, wbig) as the TPU script makes them: numpy seed 0,
    uniform [0, 1), in this order, cast to bf16 (through float32: a
    float64 -> bf16 cast of torch rounds twice)."""
    rng = np.random.default_rng(0)
    shapes = ((TAPS, M, K), (TAPS, K, N), (M, TAPS * K), (TAPS * K, N))
    return tuple(torch.from_numpy(rng.random(s).astype(np.float32))
                 .to(device, torch.bfloat16) for s in shapes)


def flops(reps=None) -> int:
    """Operations of either kernel: 2 * M * 9K * N * reps (default REPS)."""
    return 2 * M * TAPS * K * N * (REPS if reps is None else reps)


def launch_ms(fn, iters=None, rounds=ROUNDS):
    """Median and all of ``rounds`` times (ms) of one call of fn, each the
    mean of ``iters`` (default ITERS) back-to-back calls between two CUDA
    events, after one warm-up call. Back to back, the launches queue while
    the card runs, so the host's launch cost is not timed."""
    iters = ITERS if iters is None else iters
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), times


def run(reps=None, iters=None, device="cuda"):
    """Time K3 and K4 on the experiment's operands (``reps`` default REPS,
    ``iters`` timed launches each, default ITERS); print and return
    [{"name", "ms", "ms_all", "tflops"}, ...] (9-tap-loop, one-K1152)."""
    reps = REPS if reps is None else reps
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this experiment times the "
                           "Hopper kernels K3/K4 on the GPU")
    a9, w9, abig, wbig = operands(device)
    records = []
    for name, fn in (("9-tap-loop", lambda: tap_loop(a9, w9, reps)),
                     ("one-K1152", lambda: tap_k1152(abig, wbig, reps))):
        ms, ms_all = launch_ms(fn, iters)
        rate = flops(reps) / (ms * 1e-3) / 1e12
        print(name, "ms", round(ms, 3), "TFLOP/s", round(rate, 1), flush=True)
        records.append({"name": name, "ms": ms, "ms_all": ms_all,
                        "tflops": rate})
    return records


def main():
    run()


if __name__ == "__main__":
    main()
