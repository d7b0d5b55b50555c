"""Inference: build the model from a config, load its weights, and return a
predict function. Counterpart of the JAX package's ``predict.py``.

Usage:
    from pl_convlstm_gan_tpu_torch.predict import load_predictor
    predict = load_predictor(config, "params.npz")     # runs on the GPU
    future = predict(past_frames)    # [B,T_in,1,H,W] -> [B,T_out,1,H,W] f32
    hr = predict(rain_lr, dem, lu)   # Generator: [B,T,1,H,W] -> [B,T,1,H',W']

Checkpoints are a ``.npz`` of the flattened flax params (see ``weights.py``;
the README shows how to write one from a JAX checkpoint), a torch ``.pt``
state_dict, a reference Generator ``.pth``, or a checkpoint directory that
the port's trainer wrote
(``<output_dir>/best_model`` or ``latest``). Entry points run on the GPU
unless the caller passes ``device="cpu"``; with no CUDA device and no such
request they raise. ``build_model``, ``build_predict_fn`` and
``load_predictor`` take JAX's positional order (``lu_channels`` before
``output_frames``); the port's own arguments come after JAX's.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from .config import Config, convlstm_cell_impl, rollout_path
from .models import (ConvLSTMForecaster, Discriminator, Generator, PredRNN,
                     TrajGRU)
from .models.quantized import prepare_int8_forecaster, rollout_int8
from .ops.kernels.rollout_kernel import (pack_weights, rollout_kernel,
                                         rollout_kernel_misfit)
from .weights import flax_to_state_dict, load_reference_pth


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises when
    there is none (an entry point never carries on on the CPU unasked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                               "device='cpu' to run its plain path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def compute_dtype(config: Config) -> torch.dtype:
    return (torch.bfloat16 if config.precision.compute_dtype == "bfloat16"
            else torch.float32)


def build_model(config: Config, lu_channels: int = 0,
                output_frames: int = 0, tp_group=None):
    """The (randomly initialised) module a config describes:
    ``ConvLSTMForecaster`` (families forecaster and gan; ``output_frames``
    overrides the rollout horizon, which the recurrent weights do not
    depend on), ``PredRNN`` (family predrnn; the same override; its gate
    passes on K7 on the card), ``TrajGRU`` (family trajgru; the same
    override; its warps on K8 on the card) or ``Generator`` (family
    generator;
    ``lu_channels``, else
    ``model.lu_channels``, is the LUCC class count; ``input_grid_size`` is
    passed when ``target_grid_size`` is configured).
    ``model.convlstm_impl`` picks the cells' step (``convlstm_cell_impl``).
    ``tp_group`` (training under tensor parallelism: the model group) shards
    the forecaster's cells; serving builds the whole model."""
    mc = config.model
    dtype = torch.bfloat16 if compute_dtype(config) == torch.bfloat16 else None
    impl = convlstm_cell_impl(mc.convlstm_impl)
    if mc.family in ("forecaster", "gan"):
        return ConvLSTMForecaster(
            hidden_dims=tuple(mc.hidden_dims), input_frames=mc.input_frames,
            output_frames=output_frames or mc.output_frames,
            in_channels=mc.in_channels, kernel_size=mc.kernel_size,
            dtype=dtype, convlstm_impl=impl, remat=mc.remat,
            remat_policy=mc.remat_policy, tp_group=tp_group)
    if mc.family == "predrnn":
        return PredRNN(
            hidden_dims=tuple(mc.hidden_dims), input_frames=mc.input_frames,
            output_frames=output_frames or mc.output_frames,
            in_channels=mc.in_channels, kernel_size=mc.kernel_size,
            patch_size=mc.patch_size, decouple_beta=mc.decouple_beta,
            dtype=dtype)
    if mc.family == "trajgru":
        return TrajGRU(
            hidden_dims=tuple(mc.hidden_dims), links=tuple(mc.traj_links),
            forecast_links=tuple(mc.traj_forecast_links),
            stems=mc.traj_stems, deconvs=mc.traj_deconvs,
            input_frames=mc.input_frames,
            output_frames=output_frames or mc.output_frames,
            in_channels=mc.in_channels, kernel_size=mc.kernel_size,
            dtype=dtype)
    if mc.family != "generator":
        raise ValueError(f"Unknown model family: {mc.family!r}")
    sizing = {"scale_factor": mc.scale_factor}
    if mc.target_grid_size:
        sizing = {"target_grid_size": tuple(mc.target_grid_size),
                  "input_grid_size": (tuple(mc.input_grid_size)
                                      if mc.input_grid_size else None)}
    return Generator(
        in_channels=mc.in_channels, dem_channels=mc.dem_channels,
        lu_channels=lu_channels or mc.lu_channels,
        hidden_dims=tuple(mc.hidden_dims), kernel_size=mc.kernel_size,
        convlstm_impl=impl, split_precompute=mc.split_precompute,
        dtype=dtype, **sizing)


def build_discriminator(config: Config) -> Discriminator:
    """The GAN family's (randomly initialised) discriminator: features
    ``model.disc_features``, the config's compute dtype."""
    dtype = torch.bfloat16 if compute_dtype(config) == torch.bfloat16 else None
    return Discriminator(config.model.in_channels,
                         tuple(config.model.disc_features), dtype)


def load_state_dict(checkpoint_path: str) -> dict:
    """A ``.npz`` of flattened flax params, a torch ``.pt`` state_dict, a
    reference Generator ``.pth`` (``weights.load_reference_pth``), or a
    checkpoint directory written by the port's trainer (``best_model``,
    ``latest``): its ``params``, or for a GAN checkpoint ``gen_params`` (the
    generator is the deployed model), as the JAX ``restore_params``."""
    if os.path.isdir(checkpoint_path):
        from .train.checkpoint import restore_checkpoint
        device_state = restore_checkpoint(checkpoint_path)[0]
        params = device_state.get("params", device_state.get("gen_params"))
        if params is None:
            raise ValueError(f"no params/gen_params in checkpoint "
                             f"{checkpoint_path}")
        return params
    if checkpoint_path.endswith(".npz"):
        with np.load(checkpoint_path) as data:
            return flax_to_state_dict({k: data[k] for k in data.files})
    if checkpoint_path.endswith(".pt"):
        return torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if checkpoint_path.endswith(".pth"):
        return load_reference_pth(checkpoint_path)
    raise ValueError(f"checkpoint must be a .npz of flax params, a .pt "
                     f"state_dict, a reference Generator .pth or a "
                     f"checkpoint directory of the port's trainer, got "
                     f"{checkpoint_path!r}")


def rollout_choice(config: Config, device: torch.device,
                   rollout_impl: str = "") -> str:
    """'kernel', 'torch' or 'int8': the inference path of ``rollout_impl``
    (default: the config's ``model.rollout_impl``; JAX's values map as
    ``config.rollout_path`` says) for this config on ``device``, decided
    before any weight is loaded or kernel launched. 'auto' takes the kernels
    on a GPU when ``rollout_kernel_misfit`` finds nothing in the config's
    widths and compute dtype, else the plain path; 'kernel' on a GPU raises
    ValueError naming the rule the model breaks; 'int8' is the quantized
    rollout on any device. On the kernel path bfloat16 takes K5, one
    launch a call, where ``persistent_misfit`` admits the model, else K1
    and K2 step by step; float32 takes K1 and K2 step by step."""
    impl = rollout_path(rollout_impl or config.model.rollout_impl)
    if impl in ("torch", "int8"):
        return impl
    mc = config.model
    misfit = rollout_kernel_misfit(tuple(mc.hidden_dims), mc.in_channels,
                                   mc.kernel_size, compute_dtype(config),
                                   on_card=device.type == "cuda")
    if impl == "auto":
        return "kernel" if device.type == "cuda" and misfit is None else "torch"
    if misfit:
        raise ValueError(f"rollout_impl {rollout_impl or mc.rollout_impl!r} "
                         f"cannot serve this model: {misfit}")
    return impl


def build_predict_fn(config: Config, checkpoint_path: str,
                     lu_channels: int = 0, output_frames: int = 0,
                     rollout_impl: str = "", device=None) -> Callable:
    """Load the weights and return fn(frames [B,T_in,C,H,W] tensor on the
    device) -> [B,T_out,C,H,W] float32; for the Generator family fn(rain_lr
    [B,T,1,H,W], dem [B,Cd,Hd,Wd], lu [B,Cl,Hl,Wl]) -> [B,T,1,H',W']
    float32, its cells on K1 under ``convlstm_impl: pallas`` (on CPU
    tensors K1's plain version). Its LUCC class count is ``lu_channels``,
    else the config's, else the checkpoint's.

    ``rollout_impl`` (default: the config's) picks the forecaster's path
    through ``rollout_choice``: 'kernel' (JAX's 'pallas') = the CUDA kernels
    (``rollout_kernel``: in bfloat16 one K5 launch a request where
    ``persistent_misfit`` admits the model, else K1 and K2 launched step by
    step; on CPU tensors their plain versions); 'torch' (JAX's 'xla') = the plain
    ``ConvLSTMForecaster.forward``; 'auto' = 'kernel' on a GPU when the
    kernels take the model's widths, else 'torch'; 'int8' = the
    post-training-quantized rollout (``models/quantized.py``), its weights
    quantized once here.

    Family predrnn: fn(frames [B,T_in,C,H,W]) -> [B,T_out,C,H,W] float32,
    the model itself (thuml's test mask: the input frames, then its own
    predictions), its convs on cuDNN and its gate passes on K7 on the card;
    family trajgru the same, its warps on K8 on the card; for both
    ``rollout_impl`` does not apply."""
    dev = resolve_device(device)
    if config.model.family in ("predrnn", "trajgru"):
        model = build_model(config, output_frames=output_frames)
        model.load_state_dict(load_state_dict(checkpoint_path))
        return model.to(dev).eval()
    if config.model.family == "generator":
        state = load_state_dict(checkpoint_path)
        model = build_model(config, lu_channels=lu_channels or state[
            "lu_attn.conv_reduce.weight"].shape[1])
        model.load_state_dict(state)
        return model.to(dev).eval()
    impl = rollout_choice(config, dev, rollout_impl)
    model = build_model(config, output_frames=output_frames)
    model.load_state_dict(load_state_dict(checkpoint_path))
    model.to(dev).eval()
    t_in, t_out = model.input_frames, model.output_frames

    if impl == "int8":
        q = prepare_int8_forecaster(model)

        def fn(frames):
            if frames.shape[1] != t_in:
                raise ValueError(f"expected a {t_in}-frame input window "
                                 f"(model.input_frames), got {frames.shape[1]}")
            return rollout_int8(q, frames, t_out)
        return fn
    if impl == "kernel":
        cdtype = compute_dtype(config)
        weights = pack_weights(model.state_dict(), cdtype)

        def fn(frames):
            if frames.shape[1] != t_in:
                raise ValueError(f"expected a {t_in}-frame input window "
                                 f"(model.input_frames), got {frames.shape[1]}")
            return rollout_kernel(weights, frames, t_out, cdtype)
        return fn
    return model


DATA_PARALLEL = ("auto", "off", "require")


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def load_predictor(config: Config, checkpoint_path: str,
                   lu_channels: int = 0, output_frames: int = 0,
                   data_parallel: str = "auto", device=None,
                   devices=None) -> Callable:
    """``build_predict_fn`` behind a function that takes numpy arrays or
    tensors, moves them to the device as float32, and runs without
    autograd.

    predict(frames [B,T_in,C,H,W]) -> [B,T_out,C,H,W] float32 tensor on the
    device; ``output_frames`` serves another horizon than the config's.
    Generator family: predict(rain_lr [B,T,1,H,W], dem, lu) ->
    [B,T,1,H',W'] float32 (``lu_channels``: the LUCC class count,
    ``lu.shape[1]``; by default the config's, else the checkpoint's).

    ``data_parallel`` splits a batch over several devices in this one
    process, as the JAX ``load_predictor`` shards it over its chips: one
    replica of the model per device of ``devices`` (default: every visible
    GPU when ``device`` is the GPU, else ``device`` alone), each chunk of
    the batch on its own device (the kernels launch on the stream of their
    tensors' device), the outputs concatenated on the first. "auto" splits
    when there is more than one device and the batch divides their count,
    else runs the first replica; "off" never splits; "require" raises on
    one device or on a batch that does not split evenly."""
    if data_parallel not in DATA_PARALLEL:
        raise ValueError(f"data_parallel must be auto|off|require, got "
                         f"{data_parallel!r}")
    dev = resolve_device(device)
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and dev.index is None else [dev])
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data_parallel == "require" and n == 1:
        raise ValueError(f"data_parallel='require' needs more than one "
                         f"device, found {n}")
    if data_parallel == "off" or n == 1:
        devices = [dev]
    fns = [build_predict_fn(config, checkpoint_path, lu_channels,
                            output_frames, device=d) for d in devices]

    def run(fn, d, inputs):
        return fn(*(t.to(d, torch.float32) for t in inputs))

    def predict(*inputs):
        inputs = [_as_tensor(a) for a in inputs]
        b = inputs[0].shape[0]
        with torch.inference_mode():
            if len(fns) == 1 or b % len(fns):
                if len(fns) > 1 and data_parallel == "require":
                    raise ValueError(f"batch {b} not divisible by "
                                     f"{len(fns)} devices "
                                     f"(data_parallel='require')")
                return run(fns[0], devices[0], inputs)
            chunks = zip(*(t.chunk(len(fns)) for t in inputs))
            outs = [run(fn, d, part)
                    for fn, d, part in zip(fns, devices, chunks)]
            return torch.cat([o.to(devices[0]) for o in outs])
    return predict
