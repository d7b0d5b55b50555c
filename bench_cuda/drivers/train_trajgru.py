"""Training TrajGRU's encoder-forecaster (family ``trajgru``): the program's
``forecaster_train_step`` on the model's own loss (HKO-7's balanced MSE
plus MAE), on one object built once, driven from the seed.

As ``drivers.train.run``: set-up builds the model and its Adam state from
the seed's weights, runs the first three steps on batches 0-2 of the seeded
pool keeping the parameters and Adam's moments before each step and after
the third (the checked steps; they warm every shape as well), then
``warmup_steps`` more, whose time sizes the window; the window times all
its steps on the host clock with the collector's objects frozen. Once it
has closed and the program is freed, the reference
(``reference/trajgru.py``) takes each checked step from the program's own
state at that step, on the same frames, and ``checks.train_readings``
compares them.

The batch is the configuration's ``training.batch_size``; the frames are
``data.sequence_batches``' drifting fields at the configuration's
``image_size``.

Mix keys: ``pool``, ``warmup_steps``, ``trace_steps``,
``trace_host_steps``, ``ref_rows`` (as ``drivers.train``).

``train_peak_mem_gib`` is the peak of allocated device memory over the
set-up and the window: the program replays its train step as CUDA graphs
from the second step on, and a replay allocates nothing, so the step's
working set shows where the graphs were captured, in the set-up.

A traced run also records K8's launches over the device stretch
(``traj_warp.launches`` of the program's counters, where it has them) and
K8's bytes a step (``flops_trajgru.k8_step_bytes``), for
``traj_warp_roofline.train_hko``.
"""
from __future__ import annotations

import functools
import gc
import time

import torch

from .. import checks, data, flops, flops_trajgru, harness
from ..reference import convlstm as ref_convlstm
from ..reference import train as ref_train
from ..reference import trajgru as ref_trajgru
from ..trace import busy_and_window, span, traced
from .train import CHECKED_STEPS, snapshot


def param_shapes(cfg: dict):
    return ref_trajgru.param_shapes(cfg["model"])


def make_pool(cfg: dict, mix: dict, seed: int, device):
    """``pool`` items (inputs, targets) of ``data.sequence_batches``."""
    m = cfg["model"]
    return data.sequence_batches(seed, mix["pool"],
                                 cfg["training"]["batch_size"],
                                 m["input_frames"], m["output_frames"],
                                 m["image_size"], device)


def build(cfg: dict, weights, device, clock=None):
    """(the program's TrainState, step(item) -> metrics)."""
    from pl_convlstm_gan_tpu_torch.predict import build_model
    from pl_convlstm_gan_tpu_torch.train import steps
    mark = clock.mark if clock else (lambda what: None)
    mark("training modules imported, weights made")
    conf = harness.program_config(cfg)
    model = build_model(conf)
    model.load_state_dict(weights)
    model.to(device).train()
    mark("model built")
    state = steps.TrainState(model, steps.make_optimizer(model))
    mark("optimizer made")
    tc = conf.training
    step = functools.partial(steps.forecaster_train_step, lr=tc.learning_rate,
                             grad_clip_norm=tc.grad_clip_norm)
    return state, lambda item: step(state, item)


def reference_steps(cfg: dict, mix: dict, snaps, pool, q):
    """The reference's step k from the program's state ``snaps[k]`` on item
    k, for each checked step."""
    t = cfg["training"]
    out = []
    with harness.reference_numerics():
        for k in range(len(snaps) - 1):
            s = snaps[k]
            state = ref_train.TrainState(dict(s["params"]),
                                         dict(s["exp_avg"]),
                                         dict(s["exp_avg_sq"]), s["step"])
            out.append(ref_trajgru.train_step(
                cfg["model"], state, pool[k % len(pool)], t["learning_rate"],
                t["grad_clip_norm"], q, rows=mix.get("ref_rows")))
    return out


def k8_launches():
    """The program's count of K8 launches, or None (a program without
    it)."""
    from pl_convlstm_gan_tpu_torch.utils import profiling
    return profiling.counters().get("traj_warp.launches")


def run(cell, seed: int, seconds: float, trace: bool, clock,
        device: str = "cuda") -> harness.Outcome:
    cfg, mix = cell.config, cell.mix
    on_card = torch.device(device).type == "cuda"
    clock.mark("program imported")
    weights = data.weights(seed, param_shapes(cfg), device)
    state, step = build(cfg, weights, device, clock)
    pool = make_pool(cfg, mix, seed, device)
    clock.mark("batches made")

    snaps, losses, skipped = [], [], 0
    for k in range(CHECKED_STEPS):
        snaps.append(snapshot(state))
        m = step(pool[k % len(pool)])
        losses.append(m["total"])
    snaps.append(snapshot(state))
    it = CHECKED_STEPS
    t0 = time.perf_counter()
    for _ in range(mix["warmup_steps"]):
        step(pool[it % len(pool)])
        it += 1
    harness.sync(device)
    per_step = (time.perf_counter() - t0) / max(mix["warmup_steps"], 1)
    n = mix["trace_steps"] if trace else max(int(round(seconds / per_step)),
                                              1)
    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock.mark("checked and warm-up steps run")

    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    rec = None
    stretch_launches = []
    if trace:
        def run_units(units, on_unit):
            nonlocal it, skipped
            before = k8_launches()
            for _ in range(units):
                with span("step"):
                    m = step(pool[it % len(pool)])
                skipped += m["skipped"]
                it += 1
                on_unit()
            after = k8_launches()
            stretch_launches.append(None if before is None
                                    else after - before)
        rec = traced(run_units, n, mix["trace_host_steps"])
    else:
        for _ in range(n):
            m = step(pool[it % len(pool)])
            skipped += m["skipped"]
            it += 1
        harness.sync(device)
    elapsed = time.perf_counter() - start
    gc.unfreeze()
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = max(peak_setup, peak_window)
    del state, step
    gc.collect()

    detail = {}
    readings = checks.train_readings(snaps, losses, reference_steps(
        cfg, mix, snaps, pool, ref_convlstm.rounding("f32")), detail)
    batch = cfg["training"]["batch_size"]
    outcome = harness.Outcome(n, skipped, readings, peak, detail=detail)
    if trace:
        rec.info.update(
            chips=1,
            unit_flops=flops_trajgru.train_step_flops(cfg["model"], batch),
            peak_flops=flops.PEAK_FLOPS[
                "bfloat16" if cfg["precision"]["compute_dtype"] == "bfloat16"
                else "tf32"],
            k8_unit_bytes=flops_trajgru.k8_step_bytes(
                cfg["model"], batch, cfg["precision"]["compute_dtype"]))
        if stretch_launches and stretch_launches[0] is not None:
            rec.info["k8_launches"] = stretch_launches[0]
        outcome.records = rec
        outcome.busy_s, outcome.window_s = busy_and_window(rec)
    else:
        outcome.e2e = {"setup_s": setup_s,
                       "train_samples_per_s": n * batch / elapsed,
                       "train_peak_mem_gib": peak / 2 ** 30}
    harness.say(f"window: {n} steps in {elapsed:.3f} s; checked steps' "
                f"losses {losses}")
    return outcome
