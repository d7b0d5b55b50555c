"""YAML -> nested-dataclass config system for the PyTorch port.

A copy of the JAX package's config module, so that the port reads the same
``configs/<name>.yaml`` files without importing that package: four sections
(data/model/training/output) plus mesh, precision and debug, an env-var
fallback (``CONFIG_NAME``), round-trip ``to_yaml`` and ``validate()``.

Differences from the JAX copy: no ``apply_debug_flags`` (it drives JAX's own
debug switches), ``model.rollout_impl`` takes the port's values
``auto | torch | kernel | int8`` and the JAX package's ``xla`` (= torch) and
``pallas`` (= kernel) through one mapping (``rollout_path``), and
``model.convlstm_impl`` keeps the JAX values
with the port's meaning (``convlstm_cell_impl``): ``pallas`` runs the cells
on the hand-written CUDA kernel K1 (in training: K1 writing z and the custom
backward, ``ops.kernels.convlstm_kernel.ConvLSTMCellFn``); ``xla`` and
``auto`` run the plain PyTorch step. ``validate(training=True)`` also checks
what a training run needs: ``data.loader: grain`` needs the grain package
(an ImportError naming ``data.loader: plain`` where it is not installed; the
loader is never switched silently). ``mesh.data_axis`` is the number of
data-parallel ranks (0: the world size, over ``mesh.model_axis`` under
tensor parallelism) and ``mesh.model_axis`` the ranks that shard each
ConvLSTM cell's channels; ``parallel.mesh`` holds both against the process
group the run was launched with.
"""
from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field, asdict, fields
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class DataConfig:
    """Data paths & time range (reference: src/config.py:7-17)."""
    rain_lr_path: str = ""
    dem_path: str = ""
    lucc_path: str = ""
    meta_path: str = ""
    rain_excel_path: str = ""
    shp_path: str = ""
    start_year: int = 2012
    end_year: int = 2021
    # TPU-build extensions
    source: str = "fenhe"          # "fenhe" | "synthetic" | "frames"
    synthetic_num_sequences: int = 256
    synthetic_image_size: int = 64
    synthetic_num_stations: int = 16
    seed: int = 0                  # synthetic-data generation seed
    # random-split permutation seed, default matching the reference's
    # split_dataset_random (fenhe_dataset_split.py:70) so split membership is
    # stable vs the reference. Migration note: sequence-family (forecaster/gan)
    # checkpoints trained before this key existed split with data.seed (then 0)
    # — when running --mode eval on those, set split_seed: 0 so the test split
    # excludes samples they trained on. Generator-family checkpoints always
    # used 42 and are unaffected.
    split_seed: int = 42
    loader: str = "plain"          # "plain" | "grain"
    worker_count: int = 0          # grain multiprocess workers (0 = in-process)
    # source="frames": on-disk .npy/.npz frame stacks for the sequence families
    frames_path: str = ""
    frames_stride: int = 0         # movie layout only; 0 = non-overlapping
    frames_scale: float = 1.0      # multiplicative normalization on load


@dataclass
class ModelConfig:
    """Model hyperparameters (reference: src/config.py:20-27)."""
    hidden_dims: List[int] = field(default_factory=lambda: [16, 32])
    T: int = 5
    scale_factor: Optional[int] = 8
    target_grid_size: Optional[List[int]] = None
    input_grid_size: Optional[List[int]] = None
    # TPU-build extensions
    # "generator" | "forecaster" | "gan" | "predrnn" | "trajgru"
    family: str = "generator"
    in_channels: int = 1
    dem_channels: int = 1
    lu_channels: int = 0           # 0 => resolved from dataset at setup_model time
    kernel_size: int = 3
    # "auto" | "xla" | "pallas"; in the port: pallas = the CUDA cell kernel
    # K1 (training: K1 writing z + the custom backward), xla/auto = the
    # plain PyTorch step (config.convlstm_cell_impl)
    convlstm_impl: str = "auto"
    # inference path of predict and streaming (sequence families):
    # "auto" = the hand-written CUDA kernels (fused cell + head, launched per
    # step by ops.kernels.rollout_kernel) when the model is on a GPU and the
    # kernels take its widths (rollout_kernel_misfit), else the plain PyTorch
    # forward; "kernel" (or JAX's "pallas") forces the kernel path and
    # raises on widths the kernels refuse (on CPU tensors each kernel
    # wrapper runs its plain version); "torch" (or JAX's "xla") = the plain
    # ConvLSTMForecaster.forward; "int8" = the post-training-quantized
    # rollout (models/quantized.py: int8 convs on torch._int_mm, float32
    # gates), whose streaming observe stays float on the "auto" path.
    rollout_impl: str = "auto"
    remat: bool = False            # rematerialized scan body (O(1) memory in T)
    remat_policy: str = ""         # "" (full) | "save_z" | "dots" (selective)
    scan_unroll: int = 1           # lax.scan unroll (measured: 1 is fastest)
    # generator: hoist cell1's x-side conv out of the scan (measured negative
    # at current shapes — see docs/design.md; kept as an opt-in experiment)
    split_precompute: bool = False
    # forecaster family
    input_frames: int = 5
    output_frames: int = 20
    # discriminator (gan family)
    disc_features: List[int] = field(default_factory=lambda: [64, 128, 256])
    # predrnn family (PredRNN-V2, models/predrnn.py): frames folded
    # patch_size x patch_size into channels, and the decoupling loss's weight
    patch_size: int = 1
    decouple_beta: float = 0.1
    # trajgru family (TrajGRU's encoder-forecaster, models/trajgru.py), one
    # entry a resolution from the frames up (hidden_dims: each level's
    # TrajGRU width; kernel_size: its i2h conv): the encoder's and the
    # forecaster's link counts L, the encoder's downsampling conv before
    # each level and the forecaster's transposed conv after each level,
    # each [out_channels, kernel, stride, padding]
    traj_links: List[int] = field(default_factory=lambda: [13, 13, 9])
    traj_forecast_links: List[int] = field(
        default_factory=lambda: [9, 13, 13])
    traj_stems: List[List[int]] = field(default_factory=lambda: [
        [8, 7, 5, 1], [192, 5, 3, 1], [192, 3, 2, 1]])
    traj_deconvs: List[List[int]] = field(default_factory=lambda: [
        [8, 7, 5, 1], [64, 5, 3, 1], [192, 4, 2, 1]])


@dataclass
class TrainingConfig:
    """Training hyperparameters (reference: src/config.py:30-55)."""
    batch_size: int = 8
    epochs: int = 50
    learning_rate: float = 0.001
    lambda_point: float = 1.0
    lambda_conserve: float = 1.0
    lambda_smooth: float = 0.1
    lambda_temporal: float = 0.05
    grad_clip_norm: float = 0.5
    scheduler_patience: int = 5
    scheduler_factor: float = 0.5
    use_weighted_loss: bool = True
    weight_strategy: str = "log"   # "log" | "stratified" | "sqrt"
    use_early_stopping: bool = True
    early_stopping_patience: int = 20
    early_stopping_min_delta: float = 0.0001
    use_split: bool = True
    split_method: str = "year"     # "year" | "random"
    train_years: List[int] = field(default_factory=lambda: [2012, 2018])
    val_years: List[int] = field(default_factory=lambda: [2019, 2020])
    test_years: List[int] = field(default_factory=lambda: [2021, 2021])
    # TPU-build extensions
    seed: int = 0
    # GAN (north-star configs #2/#5)
    disc_learning_rate: Optional[float] = None   # default: learning_rate
    lambda_adv: float = 0.001
    lambda_l1: float = 1.0
    label_smoothing: float = 0.0                 # one-sided D label smoothing
    # GAN step structure: "default" (two G forwards — textbook alternating)
    # or "vjp" (one G forward under jax.vjp, ~0.78x modeled step FLOPs at the
    # 256px shape, higher live memory; identical math — train/steps.py)
    gan_step_impl: str = "default"
    # scheduled sampling (north-star config #4)
    scheduled_sampling: bool = False
    sampling_decay_epochs: int = 50              # teacher-forcing prob 1 -> 0 over this many epochs
    # categorical nowcasting skill scores (POD/FAR/CSI/HSS) at these thresholds
    eval_thresholds: Optional[List[float]] = None
    # spectral/gradient sharpness ratios in eval (losses/sharpness.py) — the
    # metrics the GAN term is supposed to move (blur detection beyond L1/SSIM)
    eval_sharpness: bool = False
    # resume
    resume_from: Optional[str] = None


@dataclass
class OutputConfig:
    """Output / logging (reference: src/config.py:58-64)."""
    output_dir: str = "output"
    log_interval: int = 10
    save_model_interval: int = 10
    plot_dpi: int = 300


@dataclass
class MeshConfig:
    """TPU device-mesh layout (TPU-build extension; no reference equivalent —
    the reference is single-device, src/training/trainer.py:20).

    ``model_axis > 1`` enables tensor parallelism for the sequence families:
    a 2-D (data, model) mesh where every ConvLSTM cell is channel-sharded
    over `model_axis` devices (parallel/tensor_parallel.py) — the scaling
    path when hidden widths outgrow one chip. data_axis then defaults to
    n_devices / model_axis."""
    data_axis: int = 0             # 0 => use all available devices on the 'data' axis
    axis_name: str = "data"
    model_axis: int = 1            # >1 => DP x TP over a 2-D mesh
    model_axis_name: str = "model"


@dataclass
class PrecisionConfig:
    """Mixed-precision policy (TPU-build extension; north-star config #4)."""
    compute_dtype: str = "float32"   # "float32" | "bfloat16"
    param_dtype: str = "float32"


@dataclass
class DebugConfig:
    """Debug modes (TPU-build equivalent of sanitizers, SURVEY.md §5): NaN
    tracing and jit-disable for step-through debugging."""
    nans: bool = False           # jax.config jax_debug_nans
    disable_jit: bool = False    # run ops eagerly for debugging
    # print the compiled train step's FLOP/HBM/live-memory attribution (XLA
    # cost model) on the first step — works where profiler traces don't
    log_compiled_cost: bool = False


def _filtered(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only keys the dataclass knows, so configs stay forward-compatible."""
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class Config:
    """Top-level config (reference: src/config.py:68-119)."""
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "Config":
        return cls(
            data=DataConfig(**_filtered(DataConfig, config_dict.get("data", {}))),
            model=ModelConfig(**_filtered(ModelConfig, config_dict.get("model", {}))),
            training=TrainingConfig(**_filtered(TrainingConfig, config_dict.get("training", {}))),
            output=OutputConfig(**_filtered(OutputConfig, config_dict.get("output", {}))),
            mesh=MeshConfig(**_filtered(MeshConfig, config_dict.get("mesh", {}))),
            precision=PrecisionConfig(**_filtered(PrecisionConfig, config_dict.get("precision", {}))),
            debug=DebugConfig(**_filtered(DebugConfig, config_dict.get("debug", {}))),
        )

    @classmethod
    def from_yaml(cls, yaml_path: str) -> "Config":
        if not os.path.exists(yaml_path):
            raise FileNotFoundError(f"Config file not found: {yaml_path}")
        with open(yaml_path, "r", encoding="utf-8") as f:
            config_dict = yaml.safe_load(f) or {}
        return cls.from_dict(config_dict)

    def to_yaml(self, yaml_path: str) -> None:
        config_dict = asdict(self)
        dirname = os.path.dirname(yaml_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(yaml_path, "w", encoding="utf-8") as f:
            yaml.dump(config_dict, f, default_flow_style=False, allow_unicode=True)

    def validate(self, training: bool = False) -> None:
        """Path warnings + range checks (reference: src/config.py:104-119).
        ``training=True`` (the trainers and ``--mode train/eval``) also
        checks what a training run needs (``_check_training``)."""
        for path_name, path_value in self.data.__dict__.items():
            if path_name.endswith("_path") and path_value and not os.path.exists(path_value):
                print(f"Warning: {path_name} does not exist: {path_value}")
        if self.training.learning_rate <= 0:
            raise ValueError("Learning rate must be positive")
        if self.training.batch_size <= 0:
            raise ValueError("Batch size must be positive")
        if self.model.T <= 0:
            raise ValueError("Time window T must be positive")
        if self.training.epochs <= 0:
            raise ValueError("Epochs must be positive")
        if self.model.family not in FAMILIES:
            raise ValueError(f"Unknown model family: {self.model.family}")
        if self.model.family == "predrnn":
            self._check_predrnn()
        if self.model.family == "trajgru":
            self._check_trajgru()
        if self.precision.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute dtype: {self.precision.compute_dtype}")
        convlstm_cell_impl(self.model.convlstm_impl)   # raises if unknown
        rollout_path(self.model.rollout_impl)          # raises if unknown
        if self.training.gan_step_impl not in ("default", "vjp"):
            raise ValueError(
                f"Unknown gan_step_impl: {self.training.gan_step_impl!r} "
                f"(valid: 'default', 'vjp')")
        if self.model.remat_policy not in ("", "save_z", "dots"):
            raise ValueError(
                f"Unknown remat_policy: {self.model.remat_policy!r} "
                f"(valid: '', 'save_z', 'dots')")
        if self.model.remat_policy and not self.model.remat:
            print("Warning: model.remat_policy is set but model.remat is "
                  "false — the policy has no effect without remat: true")
        if self.model.remat_policy == "save_z" and \
                self.model.convlstm_impl == "pallas":
            raise ValueError(
                "remat_policy 'save_z' requires convlstm_impl 'xla': the "
                "pallas cell does not tag its conv pre-activations, so the "
                "policy would silently degrade to full recompute")
        if self.model.split_precompute and self.model.convlstm_impl == "pallas":
            raise ValueError(
                "split_precompute requires convlstm_impl 'xla': the "
                "split-input cell has no pallas variant, so cell1 would "
                "silently run the XLA path while benchmarks claim pallas")
        if self.mesh.model_axis > 1:
            if self.model.family == "generator":
                raise ValueError(
                    "mesh.model_axis > 1 (tensor parallelism) supports the "
                    "sequence families (forecaster/gan); the parity generator "
                    "is narrow by design (<=32 channels) and stays DP-only")
            if self.model.convlstm_impl == "pallas":
                raise ValueError(
                    "tensor parallelism requires convlstm_impl 'xla'/'auto': "
                    "the pallas cell computes full-width gates per device")
            bad = [f for f in self.model.hidden_dims
                   if f % self.mesh.model_axis]
            if bad:
                raise ValueError(
                    f"hidden_dims {bad} not divisible by "
                    f"mesh.model_axis={self.mesh.model_axis}")
        if self.model.target_grid_size and not self.model.input_grid_size:
            raise ValueError(
                "model.target_grid_size requires model.input_grid_size — "
                "without it the generator silently falls back to scale 1 "
                "(no upsampling at all)")
        if training:
            self._check_training()

    def _check_predrnn(self) -> None:
        """What the predrnn family needs: equal hidden widths (the memory
        passes between layers and the decoupling adapter is shared), an odd
        kernel, a patch that divides the synthetic frames, and none of the
        ConvLSTM paths' options it has no counterpart of."""
        mc = self.model
        if len(set(mc.hidden_dims)) != 1:
            raise ValueError(f"predrnn needs every hidden width equal, got "
                             f"hidden_dims {mc.hidden_dims}")
        if mc.kernel_size % 2 == 0:
            raise ValueError(f"predrnn needs an odd kernel_size, got "
                             f"{mc.kernel_size}")
        if mc.patch_size < 1 or (
                self.data.source == "synthetic"
                and self.data.synthetic_image_size % mc.patch_size):
            raise ValueError(f"patch_size {mc.patch_size} must divide the "
                             f"frames ({self.data.synthetic_image_size})")
        if mc.input_frames < 1 or mc.output_frames < 1:
            raise ValueError("predrnn needs input_frames and output_frames "
                             ">= 1")
        if self.mesh.model_axis > 1 or mc.remat:
            raise ValueError("predrnn has no tensor-parallel or remat path "
                             "(mesh.model_axis 1, model.remat false)")

    def _check_trajgru(self) -> None:
        """What the trajgru family needs: one link count, stem and
        transposed conv a level, each positive, convs whose strides the
        transposed convs undo on the synthetic frames (``level_sizes``), and
        none of the ConvLSTM paths' options it has no counterpart of (its
        forecaster does not feed its predictions back, so no scheduled
        sampling)."""
        from .models.trajgru import level_sizes
        mc = self.model
        n = len(mc.hidden_dims)
        lists = {"traj_links": mc.traj_links,
                 "traj_forecast_links": mc.traj_forecast_links,
                 "traj_stems": mc.traj_stems,
                 "traj_deconvs": mc.traj_deconvs}
        bad = {k: len(v) for k, v in lists.items() if len(v) != n}
        if n < 1 or bad:
            raise ValueError(f"trajgru needs one entry a level in each of "
                             f"{', '.join(lists)} ({n} hidden_dims), got "
                             f"{bad}")
        specs = [tuple(s) for s in mc.traj_stems + mc.traj_deconvs]
        if any(len(s) != 4 or min(s[:3]) < 1 or s[3] < 0 for s in specs):
            raise ValueError(f"trajgru's stems and transposed convs are "
                             f"[out_channels, kernel, stride, padding], "
                             f"positive, got {specs}")
        if min(mc.hidden_dims + mc.traj_links + mc.traj_forecast_links
               + [mc.in_channels]) < 1:
            raise ValueError("trajgru's widths and link counts must be "
                             "positive")
        if mc.kernel_size % 2 == 0:
            raise ValueError(f"trajgru needs an odd kernel_size, got "
                             f"{mc.kernel_size}")
        if self.data.source == "synthetic":
            size = self.data.synthetic_image_size
            level_sizes(size, size, mc.traj_stems, mc.traj_deconvs)
        if mc.input_frames < 1 or mc.output_frames < 1:
            raise ValueError("trajgru needs input_frames and output_frames "
                             ">= 1")
        if self.mesh.model_axis > 1 or mc.remat:
            raise ValueError("trajgru has no tensor-parallel or remat path "
                             "(mesh.model_axis 1, model.remat false)")
        if self.training.scheduled_sampling:
            raise ValueError("trajgru's forecaster does not feed its "
                             "predictions back, so it has no scheduled "
                             "sampling (training.scheduled_sampling false)")

    def _check_training(self) -> None:
        """What a training run needs beyond the checks above."""
        if self.data.loader == "grain" and \
                importlib.util.find_spec("grain") is None:
            raise ImportError(GRAIN_MISSING)


FAMILIES = ("generator", "forecaster", "gan", "predrnn", "trajgru")
GRAIN_MISSING = ("data.loader 'grain' needs the grain package, which is not "
                 "installed; use data.loader: plain")


CONVLSTM_IMPLS = ("auto", "xla", "pallas")


def convlstm_cell_impl(convlstm_impl: str) -> str:
    """The port's cell step for a config's ``model.convlstm_impl``, as the
    JAX trainer maps it (sequence_trainer.py:137): 'pallas' -> 'kernel' (K1),
    'xla' and 'auto' -> 'torch' (the plain step)."""
    if convlstm_impl not in CONVLSTM_IMPLS:
        raise ValueError(f"Unknown convlstm_impl: {convlstm_impl!r} "
                         f"(valid: {', '.join(CONVLSTM_IMPLS)})")
    return "kernel" if convlstm_impl == "pallas" else "torch"


# model.rollout_impl -> the port's path: its own values and the JAX
# package's (xla: the plain scan, pallas: the TPU rollout kernel, int8: the
# quantized rollout)
ROLLOUT_IMPLS = {"auto": "auto", "torch": "torch", "kernel": "kernel",
                 "xla": "torch", "pallas": "kernel", "int8": "int8"}


def rollout_path(rollout_impl: str) -> str:
    """The port's inference path for a ``model.rollout_impl``: 'auto',
    'torch', 'kernel' or 'int8' (JAX's 'xla' -> 'torch', 'pallas' ->
    'kernel'). Any other value raises."""
    if rollout_impl not in ROLLOUT_IMPLS:
        raise ValueError(f"Unknown rollout_impl: {rollout_impl!r} (valid: "
                         f"{', '.join(ROLLOUT_IMPLS)})")
    return ROLLOUT_IMPLS[rollout_impl]


def config_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "configs")


def load_config(config_name: str = "default") -> Config:
    """Load ``configs/<name>.yaml`` with CONFIG_NAME env fallback
    (reference: src/config.py:122-132). A name ending in ``.yaml``/``.yml`` is
    treated as a direct file path instead — the route for installed (pip)
    deployments where the repo's ``configs/`` directory isn't on disk."""
    if config_name.endswith((".yaml", ".yml")):
        if not os.path.exists(config_name):
            raise FileNotFoundError(f"config file not found: {config_name}")
        return Config.from_yaml(config_name)
    path = os.path.join(config_dir(), f"{config_name}.yaml")
    if not os.path.exists(path):
        env_config = os.getenv("CONFIG_NAME", "default")
        fallback = os.path.join(config_dir(), f"{env_config}.yaml")
        # reference semantics (src/config.py:122-132) fall back silently; warn
        # loudly so a typo'd --config doesn't burn a training run unnoticed
        print(f"WARNING: config '{config_name}' not found at {path}; "
              f"falling back to '{env_config}'")
        path = fallback
    return Config.from_yaml(path)
