"""Command line of the port: ``python -m pl_convlstm_gan_tpu_torch``.

    python -m pl_convlstm_gan_tpu_torch --config nowcast_128 --mode predict \\
        --input frames.npy --checkpoint params.npz [--output-frames N]

Predict mode restores the weights (a ``.npz`` of flattened flax params or a
torch ``.pt`` state_dict), runs the forecaster on the input frames
[B,T_in,C,H,W] (a ``.npy``, or a ``.npz`` with a ``frames`` key) and writes
the predictions [B,T_out,C,H,W] as a ``.npy``. It runs on the GPU unless
``--device cpu`` is given. Training and the other modes are not ported yet.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    from .config import load_config
    from .predict import load_predictor

    parser = argparse.ArgumentParser(
        prog="python -m pl_convlstm_gan_tpu_torch",
        description="pl-convlstm-gan forecaster inference on PyTorch/CUDA")
    parser.add_argument("--config", type=str, default="default",
                        help="configuration name (configs/<name>.yaml) or a "
                             "direct path to a .yaml file")
    parser.add_argument("--mode", choices=("predict",), default="predict")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="weights: .npz of flattened flax params or a "
                             "torch .pt state_dict")
    parser.add_argument("--input", type=str, required=True,
                        help="input frames [B,T_in,C,H,W]: .npy, or .npz "
                             "with a 'frames' key")
    parser.add_argument("--output", type=str, default=None,
                        help="output .npy (default: "
                             "<output_dir>/predictions.npy)")
    parser.add_argument("--output-frames", type=int, default=0,
                        help="serve another rollout horizon than the "
                             "config's; 0 = config value")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the GPU; 'cpu' runs the "
                             "plain path)")
    args = parser.parse_args(argv)
    if args.output_frames < 0:
        raise SystemExit("--output-frames must be non-negative "
                         "(0 = config value)")

    config = load_config(args.config)
    config.validate()
    if config.model.family not in ("forecaster", "gan"):
        raise SystemExit(f"the port serves the forecaster/gan families, not "
                         f"{config.model.family!r}")
    out_path = args.output or os.path.join(config.output.output_dir,
                                           "predictions.npy")
    data = np.load(args.input)
    frames = data["frames"] if isinstance(data, np.lib.npyio.NpzFile) else data
    predict = load_predictor(config, args.checkpoint,
                             output_frames=args.output_frames,
                             device=args.device)
    pred = predict(frames).cpu().numpy()
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.save(out_path, pred)
    print(f"Predictions {pred.shape} saved to {out_path}")


if __name__ == "__main__":
    main()
