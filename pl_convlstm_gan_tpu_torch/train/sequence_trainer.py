"""SequenceTrainer: training of the forecaster, GAN and PredRNN families,
on one device or data-parallel over the ranks of a process group.

Counterpart of the JAX package's ``train/sequence_trainer.py``. What it
keeps:
- synthetic moving-blob data (``data.source: synthetic``) or an on-disk
  ``.npy`` / ``.npz`` stack of frames (``frames``: ``NpyFramesDataset``;
  the frame geometry is the data's, the model needs no sample to be built),
  the seeded 70/15/15 split, shuffled batches per epoch (``data.py``; under
  ``data.loader: grain`` the grain pipeline ``make_grain_loader``, seeded
  ``training.seed + epoch``, sharded over the data group), prefetched to the
  device;
- the model of ``predict.build_model`` (``convlstm_impl: pallas`` runs the
  cells on K1 writing z, with the custom backward), float32 params and the
  config's compute dtype, initialised from ``training.seed``;
- the linear scheduled-sampling decay, with draws from a ``torch.Generator``
  seeded ``seed * 100_003 + epoch`` (the JAX trainer's key for the epoch);
- ``family: predrnn`` (``models/predrnn.py``): the same step on the
  model's own loss, its [T_in + T_out - 2, B] reverse-scheduled-sampling
  masks drawn from the same generator: with the decay's probability p, a
  true frame at an input-phase choice with probability 1 - p / 2 and at a
  prediction-phase choice with p / 2 (thuml's ``r_eta`` and ``eta``, 0.5
  and 0.5 at the start, 1 and 0 at the end); with p 0 no masks (the input
  frames, then the model's own predictions);
- the forecaster train step (clip 0.5, Adam, NaN-skip: ``steps.py``),
  ReduceLROnPlateau on the val L1, optional early stopping;
- ``family: gan``: a discriminator (``model.disc_features``) initialised
  from ``training.seed + 1``, the GAN step (``steps.gan_train_step``,
  ``training.gan_step_impl``) with D at ``disc_learning_rate or
  learning_rate``, constant, while the plateau scheduler drives G only;
  ``g_loss`` / ``d_loss`` in the history; eval and the best metric on the
  generator; checkpoints hold ``gen_params``, ``disc_params``,
  ``gen_opt_state``, ``disc_opt_state`` and ``step``;
- ``model.remat`` / ``remat_policy``: the recurrence's steps under
  ``torch.utils.checkpoint`` (``models/forecaster.py``);
- data parallelism when launched by ``torchrun`` (``parallel/``): each rank
  trains on its block of every global batch (``training.batch_size`` is
  the global batch) with the steps of ``steps.py`` bound to the group, from
  rank 0's initial state (one broadcast); every rank draws the global
  ``[steps, B]`` scheduled-sampling draws from the one generator and takes
  its own columns, so a run at world N equals the run at world 1 with the
  same draws; eval sums each metric over the ranks before the host
  aggregation; rank 0 alone prints, writes checkpoints and the metrics;
- tensor parallelism (``mesh.model_axis`` m > 1, under ``torchrun``): the
  world cut model-minor into data and model groups (``parallel/mesh.py``),
  every cell of the forecaster (of a GAN, the generator) channel-sharded
  over the model group, the head and a GAN's discriminator replicated; the
  ranks of a model group read the same rows and draws (those of their data
  index), so the run equals one process's on the same global batch;
  checkpoints are canonical (the shards gathered over the model group and
  permuted back, written by rank 0) and restore into any layout, one
  process included;
- the best checkpoint (``best_model``), ``latest`` every
  ``save_model_interval`` epochs, resume (``training.resume_from``);
- ``validate`` / ``evaluate_test`` (L1, SSIM, POD/FAR/CSI/HSS, sharpness);
- ``metrics.jsonl`` (one line per epoch) and ``history.json``;
- ``debug.log_compiled_cost``: the first step of the run prints its
  operations and peak memory (``utils.profiling.log_compiled_cost``);
- the plots, on rank 0: ``final_training_curves.png`` and
  ``final_sequence_comparison.png`` (``utils/visualization.py``, at JAX's
  dpi); a failing sequence plot prints "Sequence plot skipped" and never
  fails a finished run; without matplotlib one line says that no plots are
  written.

Usage:
    SequenceTrainer(config=load_config("nowcast_128_pallas")).train()  # GPU
    SequenceTrainer(config=cfg, device="cpu").train()
    torchrun --nproc_per_node 8 -m pl_convlstm_gan_tpu_torch --config dp_v5e16
    torchrun --nproc_per_node 2 -m pl_convlstm_gan_tpu_torch \
        --config tp_nowcast_128
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, load_config
from ..data import (NpyFramesDataset, SyntheticSequenceDataset,
                    batch_iterator, eval_batches, make_grain_loader,
                    prefetch_to_device, split_dataset_random, to_device)
from ..parallel.mesh import (broadcast_module, is_primary, mesh_position,
                             print0, train_group)
from ..parallel.tensor_parallel import canonical_state_dict, shard_state_dict
from ..predict import build_discriminator, build_model, resolve_device
from ..utils.profiling import log_compiled_cost
from ..utils.visualization import (have_matplotlib, plot_sequence_comparison,
                                   plot_training_curves)
from .checkpoint import CheckpointWriter, restore_checkpoint
from .early_stopping import EarlyStopping
from .metrics_log import append_metrics_line, dump_history
from .plateau import ReduceLROnPlateau
from .steps import (GANTrainState, TrainState, aggregate_epoch_metrics,
                    aggregate_sequence_eval, forecaster_eval_step,
                    forecaster_train_step, gan_train_step, make_optimizer,
                    sum_over_ranks)


class SequenceTrainer:
    def __init__(self, config_name: str = "default",
                 config: Optional[Config] = None, device=None):
        self.config = config if config is not None else load_config(config_name)
        self.config.validate(training=True)
        if self.config.model.family == "generator":
            raise ValueError("SequenceTrainer trains the forecaster and GAN "
                             "families; the Generator trains with Trainer")
        self.device = resolve_device(device)
        self.group = train_group(self.config, self.device)
        self.tp = self.config.mesh.model_axis > 1
        # this rank's data index and the data replicas (the rows it reads),
        # and its place in the model group
        (self.data_index, self.n_data, self.model_index,
         self.n_model) = mesh_position(self.config.mesh.model_axis)
        if self.tp:
            print0(f"DPxTP layout: {{'data': {self.n_data}, 'model': "
                   f"{self.n_model}}} ({dist.get_backend()})")
        elif self.group is not None:
            print0(f"Data parallelism over {self.n_data} ranks "
                   f"({dist.get_backend()})")
        self.is_gan = self.config.model.family == "gan"
        self.output_dir = self.config.output.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.history = {"epoch": [], "total_loss": [], "val_l1": [],
                        "val_ssim": [], "learning_rate": []}
        if self.is_gan:
            self.history.update({"g_loss": [], "d_loss": []})
        self.best_metric = float("inf")
        self.best_epoch = -1
        self.start_epoch = 0
        self._ckpt_writer = CheckpointWriter()
        tc = self.config.training
        self.early_stopping = EarlyStopping(
            patience=tc.early_stopping_patience,
            min_delta=tc.early_stopping_min_delta) \
            if tc.use_early_stopping else None

    # ------------------------------------------------------------------ data
    def setup_data(self):
        dc, mc = self.config.data, self.config.model
        if dc.source == "frames":
            full = NpyFramesDataset(
                dc.frames_path, input_frames=mc.input_frames,
                output_frames=mc.output_frames,
                stride=dc.frames_stride or None, scale=dc.frames_scale)
            print0(f"Frames dataset: {len(full)} sequences from "
                   f"{dc.frames_path}")
        else:
            full = SyntheticSequenceDataset(
                num_sequences=dc.synthetic_num_sequences,
                input_frames=mc.input_frames, output_frames=mc.output_frames,
                image_size=dc.synthetic_image_size, seed=dc.seed)
        if self.config.training.use_split:
            self.train_dataset, self.val_dataset, self.test_dataset = \
                split_dataset_random(full, seed=dc.split_seed)
        else:
            self.train_dataset, self.val_dataset, self.test_dataset = \
                full, None, None
        return full

    def _loader(self, dataset, epoch: int):
        tc = self.config.training
        if self.config.data.loader == "grain":
            it = make_grain_loader(
                dataset, tc.batch_size, shuffle=True, seed=tc.seed + epoch,
                worker_count=self.config.data.worker_count,
                process_index=self.data_index, process_count=self.n_data)
        else:
            it = batch_iterator(dataset, tc.batch_size, shuffle=True,
                                seed=tc.seed, epoch=epoch,
                                process_index=self.data_index,
                                process_count=self.n_data)
        return prefetch_to_device(it, self.device)

    # ----------------------------------------------------------------- model
    def setup_model(self):
        tc = self.config.training
        # the init draws from the global generator; fork it so that seeding
        # here leaves the caller's random state alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tc.seed)
            model = build_model(self.config, tp_group=(
                self.group.model if self.tp else None))
        model.to(self.device)
        if self.is_gan:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(tc.seed + 1)
                disc = build_discriminator(self.config)
            disc.to(self.device)
            self.disc_lr = tc.disc_learning_rate or tc.learning_rate
            self.state = GANTrainState(model, disc, make_optimizer(model),
                                       make_optimizer(disc), 0)
            loss = dict(lambda_adv=tc.lambda_adv, lambda_l1=tc.lambda_l1,
                        label_smoothing=tc.label_smoothing)
            self.train_step = functools.partial(
                gan_train_step, impl=tc.gan_step_impl, group=self.group,
                **loss)
        else:
            self.state = TrainState(model, make_optimizer(model), 0)
            self.train_step = functools.partial(forecaster_train_step,
                                                group=self.group)
        self.scheduler = ReduceLROnPlateau(
            lr=tc.learning_rate, factor=tc.scheduler_factor,
            patience=tc.scheduler_patience)
        self.thresholds = (tuple(tc.eval_thresholds)
                           if tc.eval_thresholds else None)
        if tc.resume_from:
            self.restore(tc.resume_from)
        # the replicas start from rank 0's state (one broadcast; under TP
        # the shards from the data group's rank 0)
        broadcast_module(torch.nn.ModuleList(
            [model, disc] if self.is_gan else [model]), self.group)

    @property
    def model(self):
        """The forecaster; of a GAN, its generator."""
        return self.state.gen if self.is_gan else self.state.model

    # ------------------------------------------------------------- schedules
    def teacher_forcing_prob(self, epoch: int) -> float:
        """Linear scheduled-sampling decay 1 -> 0 over
        sampling_decay_epochs."""
        tc = self.config.training
        if not tc.scheduled_sampling:
            return 0.0
        return float(np.clip(1.0 - epoch / max(tc.sampling_decay_epochs, 1),
                             0.0, 1.0))

    # ------------------------------------------------------------------ eval
    def _run_eval(self, dataset) -> Optional[Dict[str, float]]:
        """Wrap-padded batches masked in the step, sums aggregated exactly:
        metrics do not depend on the batch size."""
        if dataset is None or len(dataset) == 0:
            return None
        bs = self.config.training.batch_size
        row0 = self.data_index * (bs // self.n_data)
        self.model.eval()
        acc = [sum_over_ranks(forecaster_eval_step(
                   self.model, to_device(batch, self.device), n_valid,
                   self.thresholds, self.config.training.eval_sharpness,
                   row0), self.group)
               for batch, n_valid in eval_batches(dataset, bs, self.data_index,
                                                  self.n_data)]
        self.model.train()
        return aggregate_sequence_eval(acc)

    def validate(self) -> Optional[Dict[str, float]]:
        return self._run_eval(self.val_dataset)

    def evaluate_test(self) -> Optional[Dict[str, float]]:
        """Every eval metric on the held-out test split (free rollout)."""
        return self._run_eval(self.test_dataset)

    # ----------------------------------------------------------------- train
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        tc = self.config.training
        tf_prob = self.teacher_forcing_prob(epoch)
        lr = self.scheduler.lr
        gen = torch.Generator().manual_seed(tc.seed * 100_003 + epoch)
        local = tc.batch_size // self.n_data
        prob = self.model.teacher_probs(tf_prob)
        metrics_acc = []
        for i, batch in enumerate(self._loader(self.train_dataset, epoch)):
            draws = None
            if tf_prob > 0:
                # the global batch's draws; this data replica's columns
                draws = torch.rand((len(prob), tc.batch_size), generator=gen)
                draws = (draws < prob[:, None])[
                    :, self.data_index * local:(self.data_index + 1) * local]
            lrs = (lr, self.disc_lr) if self.is_gan else (lr,)
            args = (self.state, batch, *lrs, draws)
            if i == 0 and epoch == self.start_epoch and \
                    self.config.debug.log_compiled_cost:
                fam = self.config.model.family
                m, _ = log_compiled_cost(f"{fam} train step", self.train_step,
                                         *args, grad_clip_norm=tc.grad_clip_norm)
            else:
                m = self.train_step(*args, grad_clip_norm=tc.grad_clip_norm)
            metrics_acc.append(m)
            if i % self.config.output.log_interval == 0:
                if self.is_gan:
                    print0(
                        f"Epoch {epoch} | G: {m['g_total']:.4f} (adv "
                        f"{m['g_adv']:.4f}, l1 {m['g_l1']:.4f}) | D: "
                        f"{m['d_total']:.4f} | tf_prob {tf_prob:.2f}")
                else:
                    print0(f"Epoch {epoch} | {self.model.loss_name}: "
                           f"{m['total']:.4f} | "
                           f"tf_prob {tf_prob:.2f}")
        if not metrics_acc:
            raise ValueError(
                f"No training batches: dataset has {len(self.train_dataset)} "
                f"samples < batch_size {tc.batch_size}")
        return aggregate_epoch_metrics(metrics_acc)

    def train(self):
        self.setup_data()
        self.setup_model()
        self.model.train()
        if self.is_gan:
            self.state.disc.train()
        for epoch in range(self.start_epoch, self.config.training.epochs):
            epoch_t0 = time.perf_counter()
            avg = self.train_epoch(epoch)
            epoch_s = time.perf_counter() - epoch_t0
            self.history["epoch"].append(epoch)
            train_loss = avg["g_total"] if self.is_gan else avg["total"]
            self.history["total_loss"].append(train_loss)
            if self.is_gan:
                self.history["g_loss"].append(avg["g_total"])
                self.history["d_loss"].append(avg["d_total"])
            self.history["learning_rate"].append(self.scheduler.lr)

            val = self.validate()
            if val:
                self.history["val_l1"].append(val["l1"])
                self.history["val_ssim"].append(val["ssim"])
                print0(f"Epoch {epoch} | Train: {train_loss:.4f} | "
                       f"Val L1: {val['l1']:.4f} | Val SSIM: "
                       f"{val['ssim']:.4f} | {epoch_s:.1f}s")
                current = val["l1"]
            else:
                # NaN-pad so every history series stays aligned with 'epoch'
                self.history["val_l1"].append(float("nan"))
                self.history["val_ssim"].append(float("nan"))
                print0(f"Epoch {epoch} | Train: {train_loss:.4f}")
                current = train_loss
            # logged before scheduler.step: the record carries the lr this
            # epoch trained at
            self._log_epoch_metrics(epoch, epoch_s, avg, val)
            self.scheduler.step(current)

            if self.early_stopping is not None:
                should_save = self.early_stopping(current, epoch)
            else:
                should_save = current < self.best_metric
            if should_save:
                self.best_metric = current
                self.best_epoch = epoch
                self.save_best(epoch, current)
                print0(f"New best model saved! Epoch {epoch + 1}, "
                       f"metric {current:.4f}")
            interval = self.config.output.save_model_interval
            if interval and (epoch + 1) % interval == 0:
                self._ckpt_writer.save(os.path.join(self.output_dir, "latest"),
                                       self._device_state_dict(),
                                       self._host_state(epoch, current))
            if self.early_stopping is not None and self.early_stopping.early_stop:
                print0(f"Early stopping at epoch {epoch + 1}")
                break

        self._ckpt_writer.wait()
        self._final_plots()
        dump_history(self.output_dir, self.history)
        print0(f"\nTraining completed. Best epoch {self.best_epoch + 1}, "
               f"metric {self.best_metric:.4f}")
        return self.history

    def _final_plots(self):
        """The training curves and a frame-grid comparison of one val (or
        train) sample, drawn by rank 0. The sample's prediction runs on
        every rank: under tensor parallelism the forward is a collective."""
        if not have_matplotlib():
            print0("matplotlib is not installed: no plots written")
            return
        pred = sample = None
        try:
            ds = self.val_dataset or self.train_dataset
            sample = ds[0]
            self.model.eval()
            with torch.no_grad():
                pred = self.model(torch.from_numpy(sample[0][None]).to(
                    self.device)).float().cpu().numpy()
            self.model.train()
        except Exception as e:  # plotting must never fail a finished run
            print0(f"Sequence plot skipped: {e}")
        if not is_primary():
            return
        val = self.history.get("val_l1", [])
        rmse_series = val if len(val) == len(self.history["epoch"]) \
            else self.history["total_loss"]
        plot_training_curves(
            {"epoch": self.history["epoch"],
             "total_loss": self.history["total_loss"],
             "rmse": rmse_series,
             "learning_rate": self.history["learning_rate"]},
            save_path=os.path.join(self.output_dir,
                                   "final_training_curves.png"),
            dpi=self.config.output.plot_dpi)
        if pred is None:
            return
        try:
            plot_sequence_comparison(
                sample[0], sample[1], pred[0],
                save_path=os.path.join(self.output_dir,
                                       "final_sequence_comparison.png"),
                dpi=self.config.output.plot_dpi // 2 or 100)
        except Exception as e:  # plotting must never fail a finished run
            print(f"Sequence plot skipped: {e}")

    def _log_epoch_metrics(self, epoch, epoch_s, train_avg, val_metrics):
        rec = {"epoch": epoch, "epoch_seconds": round(epoch_s, 3),
               "lr": self.scheduler.lr,
               "tf_prob": self.teacher_forcing_prob(epoch),
               **{f"train_{k}": float(v) for k, v in train_avg.items()}}
        if val_metrics:
            rec.update({f"val_{k}": float(v) for k, v in val_metrics.items()})
        append_metrics_line(self.output_dir, rec)

    # ------------------------------------------------------------ checkpoint
    def _device_state_dict(self):
        """The checkpoint's tensors, canonical: under TP the generator's
        shards (params and Adam moments) gathered over the model group and
        permuted back, on every rank (a collective; rank 0 writes)."""
        if self.is_gan:
            st = self.state
            return {"gen_params": self._canonical(st.gen.state_dict()),
                    "disc_params": st.disc.state_dict(),
                    "gen_opt_state": self._canonical(
                        st.gen_optimizer.state_dict(), True),
                    "disc_opt_state": st.disc_optimizer.state_dict(),
                    "step": st.step}
        return {"params": self._canonical(self.model.state_dict()),
                "opt_state": self._canonical(
                    self.state.optimizer.state_dict(), True),
                "step": self.state.step}

    def _param_names(self):
        return [n for n, _ in self.model.named_parameters()]

    def _canonical(self, sd, optimizer=False):
        if not self.tp:
            return sd
        return canonical_state_dict(
            sd, self.group.model, self._param_names() if optimizer else None)

    def _local(self, sd, optimizer=False):
        """This rank's shards of a canonical state dict (under TP)."""
        if not self.tp:
            return sd
        return shard_state_dict(sd, self.model_index, self.n_model,
                                self._param_names() if optimizer else None)

    def _host_state(self, epoch: int, metric: float) -> Dict:
        return {"epoch": epoch, "metric": metric, "history": self.history,
                # the historical best, apart from this checkpoint's metric,
                # so resuming from 'latest' never lowers the bar
                "best_metric": self.best_metric, "best_epoch": self.best_epoch,
                "scheduler": self.scheduler.state_dict(),
                "early_stopping": (self.early_stopping.state_dict()
                                   if self.early_stopping else None)}

    def save_best(self, epoch: int, metric: float):
        """Async best-checkpoint save (overlaps the next epoch)."""
        self._ckpt_writer.save(os.path.join(self.output_dir, "best_model"),
                               self._device_state_dict(),
                               self._host_state(epoch, metric))

    def restore(self, path: str):
        self._ckpt_writer.wait()   # finalize any in-flight save of this path
        device_state, host_state = restore_checkpoint(path)
        # checkpoints are canonical: under TP this rank's shards of them
        if self.is_gan:
            st = self.state
            st.gen.load_state_dict(self._local(device_state["gen_params"]))
            st.disc.load_state_dict(device_state["disc_params"])
            st.gen_optimizer.load_state_dict(
                self._local(device_state["gen_opt_state"], True))
            st.disc_optimizer.load_state_dict(device_state["disc_opt_state"])
        else:
            self.model.load_state_dict(self._local(device_state["params"]))
            self.state.optimizer.load_state_dict(
                self._local(device_state["opt_state"], True))
        self.state.step = int(device_state["step"])
        self.history = host_state["history"]
        self.best_metric = host_state.get("best_metric", host_state["metric"])
        self.best_epoch = host_state.get("best_epoch", host_state["epoch"])
        self.start_epoch = host_state["epoch"] + 1
        self.scheduler.load_state_dict(host_state["scheduler"])
        if self.early_stopping is not None and host_state.get("early_stopping"):
            self.early_stopping.load_state_dict(host_state["early_stopping"])
        print0(f"Restored checkpoint from {path} "
               f"(epoch {host_state['epoch']})")
