"""pl_convlstm_gan_tpu_torch: the PyTorch / CUDA port of pl_convlstm_gan_tpu
for NVIDIA Hopper GPUs.

It imports torch and never jax or the JAX package, which stays beside it as
the reference. Ported so far: the downscaling Generator (model, four-term
physics loss, train/eval steps, ``Trainer``, predictor, CLI; synthetic and
Fenhe data), the forecaster's serving paths (batch predict, streaming),
its training and GAN training (discriminator, BCE losses, both GAN step
variants; train/eval steps, trainer, checkpoints), rematerialized
recurrence (``model.remat``) and data-parallel training of every family
over ``torch.distributed`` (launched by ``torchrun``),
with hand-written CUDA kernels: the fused ConvLSTM cell step (which also
writes the conv pre-activation for the custom backward in training), the
conv head, and the tap-structure experiment's two contractions.

Layout
------
- ``config``   the YAML config system (a copy of the JAX package's)
- ``ops``      NHWC conv helpers, the cell math, coords, pixel shuffle and
               resizes, and ``ops.kernels``: the CUDA kernels (sources in
               ``csrc/``) with their plain versions
- ``models``   ``Generator``, ``ConvLSTMForecaster``, the GAN's
               ``Discriminator`` and their layers as ``nn.Module``s
- ``weights``  flax params tree <-> torch state_dict; optax Adam state <->
               torch.optim.Adam; a whole JAX GANTrainState; the reference
               PyTorch Generator's ``.pth`` names
- ``predict``  config + checkpoint -> predict function
- ``streaming`` ``StreamingForecaster``: observe frames into a carried state,
               branch forecasts from it
- ``losses``   the Generator's combined loss, L1, L2, the GAN's BCE losses,
               SSIM, POD/FAR/CSI/HSS, sharpness
- ``data``     synthetic sequences, synthetic and Fenhe downscaling data,
               splits, batching, device prefetch
- ``parallel`` the data-parallel process group (``mesh``) and the DP
               train steps (``train_parallel``)
- ``train``    Generator, forecaster and GAN train steps, eval steps,
               ``Trainer``, ``SequenceTrainer``, checkpoints, plateau,
               early stopping, metrics log
- ``experiments`` GPU counterparts of the repository's experiments
               (``tap_structure``)
- ``cli``      ``python -m pl_convlstm_gan_tpu_torch --mode
               train|eval|predict|stream``
"""

__version__ = "0.1.0"
