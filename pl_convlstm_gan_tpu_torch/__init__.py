"""pl_convlstm_gan_tpu_torch: the PyTorch / CUDA port of pl_convlstm_gan_tpu
for NVIDIA Hopper GPUs.

It imports torch and never jax or the JAX package, which stays beside it as
the reference, and does all that package does: the downscaling Generator
(model, four-term physics loss, train/eval steps, ``Trainer``, predictor,
CLI; synthetic and Fenhe data), the forecaster's serving paths (batch
predict, streaming, int8 post-training-quantized serving, and their
``torch.export`` artifacts in ``serve``), its training and GAN training
(discriminator, BCE losses, both GAN step variants; train/eval steps,
trainer, checkpoints; synthetic or on-disk frames, the plain or the grain
loader; the trainers' plots), rematerialized recurrence (``model.remat``),
data-parallel and tensor-parallel training over ``torch.distributed``
(launched by ``torchrun``), profiling and the offline tools, with
hand-written CUDA kernels: the fused ConvLSTM cell step (which also writes
the conv pre-activation for the custom backward in training), the conv
head, and the tap-structure experiment's two contractions. It also runs
PredRNN-V2 (family ``predrnn``), whose gate passes are a hand-written
kernel as well, and TrajGRU's encoder-forecaster (family ``trajgru``), whose
learned-flow warp is one, each beside a plain float32 reference
(``reference``). Serving's kernel path is also registered as PyTorch ops,
so that exported programs hold it.

Layout
------
- ``config``   the YAML config system (a copy of the JAX package's)
- ``ops``      NHWC conv helpers, the cell math, coords, pixel shuffle and
               resizes, int8 quantization (``quant``), and
               ``ops.kernels``: the CUDA kernels (sources in ``csrc/``)
               with their plain versions, and serving's kernel path as
               registered ops (``export_ops``)
- ``models``   ``Generator``, ``ConvLSTMForecaster``, the GAN's
               ``Discriminator``, ``PredRNN``, ``TrajGRU`` and their
               layers as ``nn.Module``s; the int8 rollout (``quantized``)
- ``reference`` plain float32 references (``predrnn``: thuml's PredRNN-V2;
               ``trajgru``: HKO-7's TrajGRU)
- ``weights``  flax params tree <-> torch state_dict; optax Adam state <->
               torch.optim.Adam; a whole JAX GANTrainState; the reference
               PyTorch Generator's ``.pth`` names
- ``predict``  config + checkpoint -> predict function
- ``streaming`` ``StreamingForecaster``: observe frames into a carried state,
               branch forecasts from it
- ``serve``    ``torch.export`` artifacts of the predictor and of the
               streaming surface (``export_model``, ``load_exported``,
               ``export_streaming``, ``load_streaming_exported``)
- ``losses``   the Generator's combined loss, L1, L2, the GAN's BCE losses,
               SSIM, POD/FAR/CSI/HSS, sharpness
- ``data``     synthetic sequences, on-disk frames, synthetic and Fenhe
               downscaling data, splits, batching, the grain loader,
               device prefetch
- ``parallel`` the data and model groups (``mesh``), the DP train steps
               (``train_parallel``), and tensor parallelism's shard layout
               (``tensor_parallel``) and collectives (``tp_collectives``)
- ``train``    Generator, forecaster and GAN train steps, eval steps,
               ``Trainer``, ``SequenceTrainer``, checkpoints, plateau,
               early stopping, metrics log
- ``utils``    profiling (``Timer``, ``benchmark_fn``, ``profile_trace``,
               ``compiled_cost``) and the trainers' plots
- ``tools``    offline ETL (CMORPH, DEM/LUCC, station tables) and the
               reference ``.pth`` import, ``python -m ...tools.<name>``
- ``experiments`` GPU counterparts of the repository's experiments
               (``tap_structure``)
- ``cli``      ``python -m pl_convlstm_gan_tpu_torch --mode
               train|eval|predict|stream|export|export-stream``

``Config`` and ``load_config`` load with the package; ``Trainer``,
``SequenceTrainer``, ``load_predictor``, ``build_model`` and
``StreamingForecaster`` load at first access, so that importing the package
loads no module of models, training or kernels.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import Config, load_config  # noqa: F401

# the entry points load at first access, as in the JAX package
_LAZY = {
    "Trainer": ("pl_convlstm_gan_tpu_torch.train.trainer", "Trainer"),
    "SequenceTrainer": ("pl_convlstm_gan_tpu_torch.train.sequence_trainer",
                        "SequenceTrainer"),
    "load_predictor": ("pl_convlstm_gan_tpu_torch.predict", "load_predictor"),
    "build_model": ("pl_convlstm_gan_tpu_torch.predict", "build_model"),
    "StreamingForecaster": ("pl_convlstm_gan_tpu_torch.streaming",
                            "StreamingForecaster"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
