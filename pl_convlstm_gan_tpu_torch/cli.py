"""Command line of the port: ``python -m pl_convlstm_gan_tpu_torch``.

    python -m pl_convlstm_gan_tpu_torch --config default --mode train \\
        [--resume]
    python -m pl_convlstm_gan_tpu_torch --config default --mode predict \\
        --input lr.npz --checkpoint output/best_model
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode train [--resume]
    python -m pl_convlstm_gan_tpu_torch --config gan_64 --mode train
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128_pallas \\
        --mode eval [--checkpoint <dir>]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode predict \\
        --input frames.npy --checkpoint params.npz [--output-frames N]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode stream \\
        --input frames.npy --checkpoint params.npz [--horizons 10,30]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode export \\
        --checkpoint params.npz [--input frames.npy] [--output model.pt2]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 \\
        --mode export-stream --checkpoint params.npz [--horizons 10,30] \\
        [--tpu-kernel auto|require|off] [--output stream.ptexport]
    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode stream \\
        --input frames.npy --checkpoint stream.ptexport [--horizons 10,30]

Train mode, the default (as in the JAX CLI), runs ``Trainer`` (the
Generator family) or ``SequenceTrainer`` (forecaster and GAN); ``--resume``
continues from ``<output_dir>/latest``, else ``best_model``, recovering a
checkpoint a crash left at ``.pending`` or ``.old``. Eval mode restores a
checkpoint (default ``<output_dir>/best_model``) and prints the test-split
metrics. Predict and stream restore the weights (a ``.npz`` of flattened
flax params, a torch ``.pt`` state_dict, a reference Generator ``.pth``,
or a checkpoint directory of the trainer, of a GAN run its generator;
default ``<output_dir>/best_model``) and read frames from a ``.npy``, or a
``.npz`` with a ``frames`` key. Predict mode runs the
forecaster on [B,T_in,C,H,W] and writes the predictions [B,T_out,C,H,W] as
a ``.npy``; for the Generator it reads an ``.npz`` of ``rain_lr``
[B,T,1,H,W], ``dem`` and ``lu`` (whose channel count sets the LUCC class
count) and writes [B,T,1,H',W']. Stream mode (sequence families only)
feeds [T,C,H,W] (one stream) or [B,T,C,H,W] (B streams) one frame at a
time through ``StreamingForecaster`` and writes an
``.npz`` with ``nowcasts`` [B,T,C,H,W] and one ``forecast_<h>`` [B,h,C,H,W]
per horizon, branched from the state after the last frame; given a
``--checkpoint`` ending in ``.ptexport`` it serves that streaming artifact
(``serve.load_streaming_exported``) instead of the model code, and a JAX
``.jaxexport`` artifact is refused (re-export it with the port). Export mode
writes the predictor as a ``torch.export`` artifact (``serve.export_model``;
default ``<output_dir>/model.pt2``): the non-batch shapes come from
``--input`` (frames, or for the Generator an ``.npz`` of ``rain_lr``/
``dem``/``lu``), else from the configured dataset. Export-stream mode writes
the streaming artifact (``serve.export_streaming``; default
``<output_dir>/stream.ptexport``) at the frame size of ``--input`` or of the
dataset, with a forecast program per ``--horizons``; ``--tpu-kernel`` keeps
the JAX flag's name and values and selects the CUDA kernel entries (auto:
when the kernels take the model on the device; require: raise unless they
do; off: the plain programs). Every mode runs on the GPU unless ``--device
cpu`` is given.

Data parallelism: launched by ``torchrun`` (or with the JAX package's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), every rank
runs this CLI; it joins the process group before anything touches the
device (``parallel.mesh.maybe_init_distributed``: NCCL on the GPUs, each
rank on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``), the trainers
split each global batch over the ranks, rank 0 alone recovers a stranded
checkpoint (the others wait at a barrier), and rank 0 alone prints the
results and writes the outputs:

    torchrun --nproc_per_node 8 -m pl_convlstm_gan_tpu_torch \\
        --config dp_v5e16 --mode train [--resume]
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config ci_smoke_seq --mode train --device cpu

Tensor parallelism (``mesh.model_axis`` > 1, the sequence families): the
trainers cut the world into data and model groups (``parallel/mesh.py``)
and shard every ConvLSTM cell over the model group; train and eval run on
every rank, checkpoints are canonical, so predict and stream (rank 0, one
process) read them as any other:

    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \\
        --config tp_nowcast_128 --mode train [--resume]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load_frames(path):
    """Frames array from a .npy, or a .npz with a 'frames' key."""
    data = np.load(path)
    return data["frames"] if isinstance(data, np.lib.npyio.NpzFile) else data


def _horizons(config, args):
    if not args.horizons:
        return (args.output_frames or config.model.output_frames,)
    try:
        return tuple(int(h) for h in args.horizons.split(","))
    except ValueError:
        raise SystemExit(f"--horizons must be comma-separated ints, "
                         f"got {args.horizons!r}")


def _stream(config, args, out_path):
    import torch

    horizons = _horizons(config, args)
    frames = np.asarray(_load_frames(args.input), np.float32)
    if frames.ndim == 4:
        frames = frames[None]
    if frames.ndim != 5:
        raise SystemExit(f"stream input must be [T,C,H,W] or [B,T,C,H,W], "
                         f"got shape {frames.shape}")
    b, t, chans, hgt, wid = frames.shape
    if args.checkpoint.endswith(".jaxexport"):
        raise SystemExit("a .jaxexport is the JAX package's streaming "
                         "artifact: re-export the checkpoint with the port "
                         "(--mode export-stream) or pass its params as .npz "
                         "or .pt")
    if args.checkpoint.endswith(".ptexport"):
        from .serve import load_streaming_exported
        with open(args.checkpoint, "rb") as f:
            server = load_streaming_exported(f.read(), device=args.device)
        missing = [h for h in horizons if h not in server.horizons]
        if missing:
            raise SystemExit(f"artifact only has forecast programs for "
                             f"horizons {list(server.horizons)}: missing "
                             f"{missing} (re-export with --horizons)")
        want = tuple(server.meta[k] for k in ("channels", "height", "width"))
        if (chans, hgt, wid) != want:
            raise SystemExit(f"input frames are C,H,W={chans, hgt, wid} but "
                             f"the artifact was exported at {want}")
        state = server.init_state(b)
        observe, forecast = server.observe, server.forecast
    else:
        from .streaming import StreamingForecaster
        sf = StreamingForecaster.from_checkpoint(config, args.checkpoint,
                                                 device=args.device)
        state = sf.init_state(b, hgt, wid)
        observe, forecast = sf.observe, sf.forecast
    nowcasts = []
    for i in range(t):
        state, nowcast = observe(state, frames[:, i])
        nowcasts.append(nowcast)
    out = {"nowcasts": torch.stack(nowcasts, 1).cpu().numpy()}
    for h in horizons:
        out[f"forecast_{h}"] = forecast(state, h).cpu().numpy()
    _make_parent(out_path)
    np.savez(out_path, **out)
    shapes = {k: v.shape for k, v in out.items()}
    print(f"Streamed {t} frames x {b} stream(s): {shapes} saved to {out_path}")


def _sample_frames(config, args):
    """[1, T, C, H, W] frames fixing an artifact's static shapes: the first
    of ``--input``, else the configured dataset's first input window."""
    if args.input:
        return np.asarray(_load_frames(args.input), np.float32)[:1]
    return np.asarray(_trainer(config, args).setup_data()[0][0])[None]


def _export(config, args, out_path):
    from .serve import export_model
    lu_channels = 0
    if config.model.family == "generator":
        if not args.input:
            raise SystemExit("generator-family export needs --input: an "
                             ".npz with rain_lr/dem/lu sample arrays")
        data = np.load(args.input)
        if not isinstance(data, np.lib.npyio.NpzFile):
            raise SystemExit("generator-family export needs an .npz with "
                             "rain_lr/dem/lu arrays (got a plain .npy)")
        example = (data["rain_lr"][:1], data["dem"][:1], data["lu"][:1])
        lu_channels = data["lu"].shape[1]
    else:
        example = (_sample_frames(config, args),)
    blob = export_model(config, args.checkpoint, example,
                        lu_channels=lu_channels,
                        output_frames=args.output_frames, device=args.device)
    _make_parent(out_path)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"Exported serving artifact ({len(blob)} bytes, batch-polymorphic)"
          f" to {out_path}")


def _export_stream(config, args, out_path):
    from .serve import export_streaming, parse_stream_header
    hgt, wid = _sample_frames(config, args).shape[-2:]
    horizons = _horizons(config, args)
    blob = export_streaming(config, args.checkpoint, int(hgt), int(wid),
                            horizons=horizons, tpu_kernel=args.tpu_kernel,
                            device=args.device)
    _make_parent(out_path)
    with open(out_path, "wb") as f:
        f.write(blob)
    meta = parse_stream_header(blob)[0]
    print(f"Exported streaming artifact ({len(blob)} bytes, observe + "
          f"forecast{list(horizons)}, {meta['rollout']} path, kernel "
          f"horizons {meta['kernel_horizons']}, batch-polymorphic) to "
          f"{out_path}")


def _trainer(config, args):
    """The family's trainer: ``Trainer`` (Generator) or
    ``SequenceTrainer``."""
    from .train import SequenceTrainer, Trainer
    cls = Trainer if config.model.family == "generator" else SequenceTrainer
    return cls(config=config, device=args.device)


def _train(config, args):
    from .parallel.mesh import print0
    from .train.checkpoint import recover_checkpoint_dir

    if args.resume and not config.training.resume_from:
        for name in ("latest", "best_model"):
            ckpt = os.path.join(config.output.output_dir, name)
            # rank 0 recovers; every rank then sees the same directory
            if recover_checkpoint_dir(ckpt):
                config.training.resume_from = ckpt
                print0(f"Resuming from {ckpt}")
                break
        else:
            print0("--resume: no checkpoint found, starting fresh")
    return _trainer(config, args).train()


def _evaluate(config, args):
    from .parallel.mesh import print0
    trainer = _trainer(config, args)
    dataset = trainer.setup_data()
    if config.model.family == "generator":
        trainer.setup_model(dataset)
    else:
        trainer.setup_model()
    trainer.restore(args.checkpoint or os.path.join(config.output.output_dir,
                                                    "best_model"))
    metrics = trainer.evaluate_test()
    print0(f"Test metrics: {metrics}")
    return metrics


def _make_parent(path):
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def main(argv=None):
    """Run one mode; returns the history (train) or the test metrics
    (eval)."""
    from .config import load_config
    from .parallel.mesh import is_primary, maybe_init_distributed
    from .predict import load_predictor

    parser = argparse.ArgumentParser(
        prog="python -m pl_convlstm_gan_tpu_torch",
        description="pl-convlstm-gan downscaling Generator, forecaster and "
                    "GAN training and inference on PyTorch/CUDA")
    parser.add_argument("--config", type=str, default="default",
                        help="configuration name (configs/<name>.yaml) or a "
                             "direct path to a .yaml file")
    parser.add_argument("--mode", choices=("train", "eval", "predict",
                                           "stream", "export",
                                           "export-stream"),
                        default="train",
                        help="train (the default, as in the JAX CLI); eval; "
                             "predict; stream (a .ptexport --checkpoint "
                             "serves that artifact); export (a torch.export "
                             "artifact of the predictor); export-stream (the "
                             "streaming artifact)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="weights: .npz of flattened flax params, a "
                             "torch .pt state_dict or a checkpoint directory "
                             "of the trainer (default: <output_dir>/"
                             "best_model); stream mode also takes a "
                             ".ptexport streaming artifact")
    parser.add_argument("--resume", action="store_true",
                        help="train mode: resume from <output_dir>/latest "
                             "(or best_model) if present")
    parser.add_argument("--input", type=str, default=None,
                        help="input frames: [B,T_in,C,H,W] for predict, "
                             "[T,C,H,W] or [B,T,C,H,W] for stream; .npy, or "
                             ".npz with a 'frames' key; Generator predict: "
                             ".npz with rain_lr/dem/lu")
    parser.add_argument("--output", type=str, default=None,
                        help="output file (default: <output_dir>/"
                             "predictions.npy, stream_out.npz, model.pt2 or "
                             "stream.ptexport)")
    parser.add_argument("--output-frames", type=int, default=0,
                        help="serve another rollout horizon than the "
                             "config's; 0 = config value")
    parser.add_argument("--horizons", type=str, default="",
                        help="stream and export-stream modes: "
                             "comma-separated forecast horizons (default: "
                             "--output-frames, else the config's)")
    parser.add_argument("--tpu-kernel", choices=("auto", "require", "off"),
                        default="auto",
                        help="export-stream mode (the JAX flag's name and "
                             "values): selects the CUDA kernel entries; "
                             "auto = when K1/K2 take the model on the "
                             "device, require = raise unless they do, off = "
                             "the plain programs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU; 'cpu' runs the "
                             "plain path)")
    args = parser.parse_args(argv)
    if args.output_frames < 0:
        raise SystemExit("--output-frames must be non-negative "
                         "(0 = config value)")

    # before anything touches the device: joins the process group that
    # torchrun (or the JAX package's coordinator variables) names
    maybe_init_distributed(args.device)
    config = load_config(args.config)
    training = args.mode in ("train", "eval")
    config.validate(training=training)
    if training:
        return _train(config, args) if args.mode == "train" else \
            _evaluate(config, args)
    if not is_primary():
        return      # inference runs on rank 0 (load_predictor splits a
                    # batch over the GPUs itself: data_parallel)
    if args.mode in ("stream", "export-stream") and \
            config.model.family == "generator":
        raise SystemExit(f"{args.mode} mode needs a sequence family "
                         f"(forecaster/gan), not the Generator")
    if args.mode in ("predict", "stream") and not args.input:
        raise SystemExit(f"--mode {args.mode} requires --input")
    args.checkpoint = args.checkpoint or os.path.join(
        config.output.output_dir, "best_model")
    default_name = {"predict": "predictions.npy", "stream": "stream_out.npz",
                    "export": "model.pt2",
                    "export-stream": "stream.ptexport"}[args.mode]
    out_path = args.output or os.path.join(config.output.output_dir,
                                           default_name)
    if args.mode != "predict":
        {"stream": _stream, "export": _export,
         "export-stream": _export_stream}[args.mode](config, args, out_path)
        return
    if config.model.family == "generator":
        data = np.load(args.input)
        if not isinstance(data, np.lib.npyio.NpzFile):
            raise SystemExit("generator-family predict needs an .npz with "
                             "rain_lr/dem/lu arrays")
        predict = load_predictor(config, args.checkpoint, device=args.device,
                                 lu_channels=data["lu"].shape[1])
        pred = predict(data["rain_lr"], data["dem"], data["lu"])
    else:
        predict = load_predictor(config, args.checkpoint,
                                 output_frames=args.output_frames,
                                 device=args.device)
        pred = predict(_load_frames(args.input))
    pred = pred.cpu().numpy()
    _make_parent(out_path)
    np.save(out_path, pred)
    print(f"Predictions {pred.shape} saved to {out_path}")


if __name__ == "__main__":
    main()
