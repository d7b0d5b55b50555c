"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- ``convlstm_kernel``: K1, the fused ConvLSTM cell step (csrc/convlstm_cell.cu),
  with or without the pre-activation z, and ``ConvLSTMCellFn``, the training
  step with its hand-written backward, whose gate algebra is K6
  (csrc/cell_backward.cu)
- ``rollout_kernel``: K2, the conv head (csrc/conv_head.cu); K5, the whole
  bfloat16 rollout in one cooperative launch (csrc/rollout_persistent.cu);
  the rollout's phase table; and the free-running rollouts (cold, and warm
  from a carried state) and streaming observe, on K5 in bfloat16 or K1 and
  K2 step by step
- ``tap_structure_kernel``: K3 and K4, the tap-structure experiment's 9-tap
  and one-K1152 contractions (csrc/tap_structure.cu)
- ``export_ops``: the serving loops of ``rollout_kernel`` registered as
  PyTorch ops (``plcg_torch::rollout``, ``rollout_from_state``,
  ``observe``), so that ``torch.export`` programs hold them
- ``build``: nvcc build of csrc/ and ctypes loading, at first use
"""
