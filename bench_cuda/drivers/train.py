"""Training: the program's train step (``forecaster_train_step`` or
``generator_train_step``, the config's ``family``) on one object built once,
driven from the seed.

Set-up builds the model and its Adam state from the seed's weights, then
runs the first three steps through the window's own call on batches 0-2 of
the seeded pool (rows that all differ), keeping the parameters and Adam's
moments before each step and after the third (the checked steps; they warm
every shape as well), then ``warmup_steps`` more, whose time sizes the
window: ``seconds / their mean`` steps. The
window times all of them on the host clock, with the collector's existing
objects frozen (``gc.freeze``). Once it has closed and the
program is freed, the reference takes each checked step from the
program's own state at that step (``checks.train_readings``).

The batch is the configuration's ``training.batch_size``.

Mix keys: ``pool`` (seeded batches, step i reads batch i modulo the pool),
``warmup_steps``, ``trace_steps`` and ``trace_host_steps`` (the device and
the host stretch of a ``--trace 1`` run, ``trace.traced``), ``ref_rows``
(rows of the batch the reference runs at once; the forecaster's loss is a
mean over equal blocks of rows).
"""
from __future__ import annotations

import gc
import time

from .. import checks, data, flops, harness
from ..reference import convlstm as ref_convlstm
from ..reference import generator as ref_generator
from ..reference import train as ref_train
from ..trace import busy_and_window, span, traced

CHECKED_STEPS = 3


def param_shapes(cfg: dict):
    if cfg["family"] == "forecaster":
        return ref_convlstm.forecaster_param_shapes(cfg["model"])
    return ref_generator.param_shapes(cfg["model"])


def make_pool(cfg: dict, mix: dict, seed: int, device):
    m = cfg["model"]
    batch = cfg["training"]["batch_size"]
    if cfg["family"] == "forecaster":
        return data.sequence_batches(seed, mix["pool"], batch,
                                     m["input_frames"], m["output_frames"],
                                     m["image_size"], device)
    return data.downscaling_batches(seed, mix["pool"], batch, m["T"],
                                    m["image_size"], m["scale_factor"],
                                    m["lu_channels"],
                                    cfg["data"]["synthetic_num_stations"],
                                    device)


def snapshot(state) -> dict:
    """The program's parameters and Adam moments, by parameter name."""
    import torch
    names = dict(state.model.named_parameters())
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": 0}
    for name, p in names.items():
        st = state.optimizer.state.get(p, {})
        out["params"][name] = p.detach().clone()
        for key in ("exp_avg", "exp_avg_sq"):
            out[key][name] = (st[key].detach().clone() if key in st
                              else torch.zeros_like(p))
        if "step" in st:
            out["step"] = int(st["step"])
    return out


def build(cfg: dict, weights, device, clock=None):
    """(the program's TrainState, step(batch) -> metrics)."""
    import functools
    from pl_convlstm_gan_tpu_torch.predict import build_model
    from pl_convlstm_gan_tpu_torch.train import steps
    mark = clock.mark if clock else (lambda what: None)
    mark("training modules imported, weights made")
    conf = harness.program_config(cfg)
    model = build_model(conf, lu_channels=cfg["model"].get("lu_channels", 0))
    model.load_state_dict(weights)
    model.to(device).train()
    mark("model built")
    state = steps.TrainState(model, steps.make_optimizer(model))
    mark("optimizer made")
    tc = conf.training
    if cfg["family"] == "forecaster":
        fn = steps.forecaster_train_step
    else:
        fn = functools.partial(steps.generator_train_step,
                               loss_cfg=steps.loss_config(tc))
    step = functools.partial(fn, lr=tc.learning_rate,
                             grad_clip_norm=tc.grad_clip_norm)
    return state, lambda batch: step(state, batch)


def loss_cfg(cfg: dict) -> dict:
    t = cfg["training"]
    return {k: t[k] for k in ("lambda_point", "lambda_conserve",
                              "lambda_smooth", "lambda_temporal",
                              "use_weighted_loss", "weight_strategy")
            if k in t}


def reference_steps(cfg: dict, mix: dict, snaps, pool, q):
    """The reference's step k from the program's state ``snaps[k]`` on
    batch k, for each checked step."""
    t = cfg["training"]
    out = []
    with harness.reference_numerics():
        for k in range(len(snaps) - 1):
            s = snaps[k]
            state = ref_train.TrainState(dict(s["params"]),
                                         dict(s["exp_avg"]),
                                         dict(s["exp_avg_sq"]), s["step"])
            out.append(ref_train.train_step(
                cfg["family"], cfg["model"], loss_cfg(cfg), state,
                pool[k % len(pool)], t["learning_rate"],
                t["grad_clip_norm"], q, rows=mix.get("ref_rows")))
    return out


def run(cell, seed: int, seconds: float, trace: bool, clock,
        device: str = "cuda") -> harness.Outcome:
    import torch
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
    if trace:
        def run_units(units, on_unit):
            nonlocal it, skipped
            for _ in range(units):
                with span("step"):
                    m = step(pool[it % len(pool)])
                skipped += m["skipped"]
                it += 1
                on_unit()
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
        rec.info.update(chips=1,
                        unit_flops=flops.train_step_flops(
                            cfg["family"], cfg["model"], batch),
                        peak_flops=flops.PEAK_FLOPS[
                            "bfloat16" if cfg["precision"]["compute_dtype"]
                            == "bfloat16" else "tf32"])
        outcome.records = rec
        outcome.busy_s, outcome.window_s = busy_and_window(rec)
    else:
        outcome.e2e = {"setup_s": setup_s,
                       "train_samples_per_s": n * batch / elapsed,
                       "train_peak_mem_gib": peak_window / 2 ** 30}
    harness.say(f"window: {n} steps in {elapsed:.3f} s; checked steps' "
                f"losses {losses}")
    return outcome
