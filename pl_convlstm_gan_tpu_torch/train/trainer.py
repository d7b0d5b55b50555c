"""Trainer: training of the downscaling Generator, on one device or
data-parallel over the ranks of a process group.

Counterpart of the JAX package's ``train/trainer.py`` without its plots
(matplotlib's training curves and station scatter, ROADMAP A6). What it
keeps, with the JAX trainer's public surface:
- ``setup_data``: ``SyntheticDownscalingDataset`` (``data.source:
  synthetic``) or ``FenheDataset`` (``fenhe``), split by year (Fenhe with
  ``split_method: year``) or by the seeded 70/15/15 permutation
  (``data.split_seed``); shuffled batches per epoch, prefetched to the
  device;
- ``setup_model(dataset)``: the Generator of ``predict.build_model`` with
  the dataset's LUCC class count unless ``model.lu_channels`` is set,
  float32 params and the config's compute dtype, initialised from
  ``training.seed`` (``convlstm_impl: pallas`` runs the cells on K1 writing
  z, with the custom backward);
- ``train_epoch``: the Generator train step (combined loss, NaN-skip, clip,
  Adam at the plateau scheduler's LR: ``steps.generator_train_step``) and
  the JAX trainer's per-interval log line;
- ``train``: the same ``history`` keys, ReduceLROnPlateau on the val RMSE
  (train RMSE without a val split), optional early stopping, the best
  checkpoint (``best_model``) and ``latest`` every ``save_model_interval``
  epochs (bundle ``params`` / ``opt_state`` / ``step``), resume
  (``training.resume_from``), ``metrics.jsonl`` and ``history.json``;
- ``validate`` / ``evaluate_test``: loss, station RMSE and the four parts,
  aggregated exactly over wrap-padded batches;
- data parallelism when launched by ``torchrun`` (``parallel/``), as
  ``SequenceTrainer`` runs it: each rank trains on its block of every
  global batch with the Generator step bound to the group (the point term
  and the RMSE over the global station counts), from rank 0's initial state;
  eval sums each metric over the ranks; rank 0 alone prints and writes.

Usage:
    Trainer(config=load_config("default")).train()        # on the GPU
    Trainer(config=cfg, device="cpu").train()
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import Config, load_config
from ..data import (FenheDataset, SyntheticDownscalingDataset, batch_iterator,
                    eval_batches, prefetch_to_device, split_dataset_by_year,
                    split_dataset_random, to_device)
from ..parallel.mesh import (broadcast_module, print0, rank_and_world,
                             train_group)
from ..losses import station_rmse
from ..predict import build_model, resolve_device
from .checkpoint import CheckpointWriter, restore_checkpoint
from .early_stopping import EarlyStopping
from .metrics_log import append_metrics_line, dump_history
from .plateau import ReduceLROnPlateau
from .steps import (TrainState, aggregate_epoch_metrics,
                    aggregate_generator_eval, generator_eval_step,
                    generator_train_step, loss_config, make_optimizer,
                    sum_over_ranks)


class Trainer:
    def __init__(self, config_name: str = "default",
                 config: Optional[Config] = None, device=None):
        self.config = config if config is not None else load_config(config_name)
        self.config.validate(training=True)
        if self.config.model.family != "generator":
            raise ValueError(f"Trainer trains the Generator family; family "
                             f"{self.config.model.family!r} trains with "
                             f"SequenceTrainer")
        self.device = resolve_device(device)
        self.group = train_group(self.config, self.device)
        self.rank, self.world = (rank_and_world() if self.group is not None
                                 else (0, 1))
        if self.group is not None:
            print0(f"Data parallelism over {self.world} ranks "
                   f"({dist.get_backend()})")
        self.output_dir = self.config.output.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.history = {
            "epoch": [], "total_loss": [], "point_loss": [], "conserve_loss": [],
            "smooth_loss": [], "temporal_loss": [], "rmse": [],
            "learning_rate": []}
        self.best_rmse = float("inf")
        self.best_epoch = -1
        self.start_epoch = 0
        self._ckpt_writer = CheckpointWriter()
        tc = self.config.training
        self.early_stopping = None
        if tc.use_early_stopping:
            self.early_stopping = EarlyStopping(
                patience=tc.early_stopping_patience,
                min_delta=tc.early_stopping_min_delta)
            print0(f"Early stopping: enabled (patience="
                   f"{tc.early_stopping_patience}, min_delta="
                   f"{tc.early_stopping_min_delta})")
        else:
            print0("Early stopping: disabled")

    # ------------------------------------------------------------------ data
    def _build_dataset(self):
        dc, mc = self.config.data, self.config.model
        if dc.source == "synthetic":
            return SyntheticDownscalingDataset(
                num_days=dc.synthetic_num_sequences, T=mc.T,
                lr_size=dc.synthetic_image_size,
                scale_factor=int(mc.scale_factor or 8),
                num_stations=dc.synthetic_num_stations, seed=dc.seed,
                start_year=dc.start_year, end_year=dc.end_year)
        return FenheDataset(
            rain_lr_path=dc.rain_lr_path, dem_path=dc.dem_path,
            lucc_path=dc.lucc_path, rain_meta_path=dc.meta_path,
            rain_station_path=dc.rain_excel_path, shp_path=dc.shp_path,
            T=mc.T, start_year=dc.start_year, end_year=dc.end_year)

    def setup_data(self):
        """The dataset, split into train/val/test (None without a split)."""
        full = self._build_dataset()
        tc = self.config.training
        if tc.use_split:
            print0(f"\nSplitting dataset with method "
                   f"'{tc.split_method}'...")
            if tc.split_method == "year" and self.config.data.source == "fenhe":
                splits = split_dataset_by_year(
                    full, tuple(tc.train_years), tuple(tc.val_years),
                    tuple(tc.test_years))
            else:
                splits = split_dataset_random(
                    full, seed=self.config.data.split_seed)
            self.train_dataset, self.val_dataset, self.test_dataset = splits
            print0(f"Train: {len(splits[0])} | Val: {len(splits[1])} | "
                   f"Test: {len(splits[2])} samples\n")
        else:
            print0("\nTraining on the full dataset (no split)\n")
            self.train_dataset, self.val_dataset, self.test_dataset = \
                full, None, None
        return full

    def _loader(self, dataset, epoch: int):
        it = batch_iterator(dataset, self.config.training.batch_size,
                            shuffle=True, seed=self.config.training.seed,
                            epoch=epoch, process_index=self.rank,
                            process_count=self.world)
        return prefetch_to_device(it, self.device)

    # ----------------------------------------------------------------- model
    def setup_model(self, dataset):
        """Model, optimizer, scheduler and loss settings; resumes when
        ``training.resume_from`` is set."""
        mc, tc = self.config.model, self.config.training
        lu_channels = mc.lu_channels or dataset.num_lu_classes
        # the init draws from the global generator; fork it so that seeding
        # here leaves the caller's random state alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tc.seed)
            self.model = build_model(self.config, lu_channels=lu_channels)
        self.model.to(self.device).train()
        self.state = TrainState(self.model, make_optimizer(self.model), 0)
        self.scheduler = ReduceLROnPlateau(
            lr=tc.learning_rate, factor=tc.scheduler_factor,
            patience=tc.scheduler_patience)
        self.loss_cfg = loss_config(tc)
        self.train_step = functools.partial(
            generator_train_step, loss_cfg=self.loss_cfg, group=self.group)
        print0(f"Loss config: weighted="
               f"{'on' if tc.use_weighted_loss else 'off'}, "
               f"strategy={tc.weight_strategy}")
        if tc.resume_from:
            self.restore(tc.resume_from)
        # the replicas start from rank 0's state (one broadcast)
        broadcast_module(self.model, self.group)

    # ------------------------------------------------------------------ eval
    def compute_station_rmse(self, fake_hr, s_coords, s_values,
                             scale_factor=1.0):
        """Masked RMSE at the station pixels of ``fake_hr`` [B,T,1,H,W]
        (numpy or tensors; ``losses.station_rmse``), the reference
        trainer's metric."""
        return station_rmse(*(torch.as_tensor(a) for a in
                              (fake_hr, s_coords, s_values)), scale_factor)

    def _run_eval(self, dataset) -> Optional[Dict[str, float]]:
        """Wrap-padded batches masked in the step, sums aggregated exactly:
        metrics do not depend on the batch size."""
        if dataset is None or len(dataset) == 0:
            return None
        bs = self.config.training.batch_size
        row0 = self.rank * (bs // self.world)
        self.model.eval()
        acc = [sum_over_ranks(generator_eval_step(
                   self.model, to_device(batch, self.device), n_valid,
                   self.loss_cfg, row0), self.group)
               for batch, n_valid in eval_batches(dataset, bs, self.rank,
                                                  self.world)]
        self.model.train()
        return aggregate_generator_eval(acc, self.loss_cfg)

    def validate(self) -> Optional[Dict[str, float]]:
        return self._run_eval(self.val_dataset)

    def evaluate_test(self) -> Optional[Dict[str, float]]:
        """Loss, station RMSE and the four parts on the held-out test
        split."""
        return self._run_eval(self.test_dataset)

    # ----------------------------------------------------------------- train
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        tc = self.config.training
        lr = self.scheduler.lr
        metrics_acc = []
        for i, batch in enumerate(self._loader(self.train_dataset, epoch)):
            m = self.train_step(self.state, batch, lr,
                                grad_clip_norm=tc.grad_clip_norm)
            metrics_acc.append(m)
            if i % self.config.output.log_interval == 0:
                print0(f"Epoch {epoch} | Loss: {m['total']:.4f} | "
                       f"Point: {m['point']:.4f} | "
                       f"Conserve: {m['conserve']:.4f} | "
                       f"Smooth: {m['smooth']:.4f} | "
                       f"Temporal: {m['temporal']:.4f} | "
                       f"Batch RMSE: {m['rmse']:.4f}")
        if not metrics_acc:
            raise ValueError(
                f"No training batches: dataset has {len(self.train_dataset)} "
                f"samples < batch_size {tc.batch_size}")
        return aggregate_epoch_metrics(metrics_acc)

    def train(self):
        dataset = self.setup_data()
        self.setup_model(dataset)
        for epoch in range(self.start_epoch, self.config.training.epochs):
            epoch_t0 = time.perf_counter()
            avg = self.train_epoch(epoch)
            epoch_s = time.perf_counter() - epoch_t0
            self.history["epoch"].append(epoch)
            for key, part in (("total_loss", "total"), ("point_loss", "point"),
                              ("conserve_loss", "conserve"),
                              ("smooth_loss", "smooth"),
                              ("temporal_loss", "temporal"), ("rmse", "rmse")):
                self.history[key].append(avg[part])
            self.history["learning_rate"].append(self.scheduler.lr)

            val = self.validate()
            if val:
                print0(f"Epoch {epoch} | Train RMSE: {avg['rmse']:.4f} | "
                       f"Val Loss: {val['loss']:.4f} | "
                       f"Val RMSE: {val['rmse']:.4f} | {epoch_s:.1f}s")
                current = val["rmse"]
            else:
                print0(f"Epoch {epoch} finished. Avg Batch RMSE: "
                       f"{avg['rmse']:.4f}")
                current = avg["rmse"]
            # logged before scheduler.step: the record carries the lr this
            # epoch trained at
            self._log_epoch_metrics(epoch, epoch_s, avg, val)
            self.scheduler.step(current)

            if self.early_stopping is not None:
                should_save = self.early_stopping(current, epoch)
            else:
                should_save = current < self.best_rmse
            if should_save:
                self.best_rmse = current
                self.best_epoch = epoch
                self.save_best(epoch, current)
                print0(f"New best model saved! Epoch {epoch + 1}, "
                       f"RMSE: {current:.4f}")
            interval = self.config.output.save_model_interval
            if interval and (epoch + 1) % interval == 0:
                self.save_latest(epoch, current)
            if self.early_stopping is not None and self.early_stopping.early_stop:
                print0(f"Early stopping at epoch {epoch + 1}; best "
                       f"epoch {self.best_epoch + 1}, RMSE "
                       f"{self.best_rmse:.4f}")
                break

        self._ckpt_writer.wait()
        dump_history(self.output_dir, self.history)
        print0("\nTraining completed!")
        print0(f"Best model: Epoch {self.best_epoch + 1}, "
               f"RMSE: {self.best_rmse:.4f}")
        print0(f"Results saved to {self.output_dir}/")
        return self.history

    def _log_epoch_metrics(self, epoch, epoch_s, train_avg, val_metrics):
        rec = {"epoch": epoch, "epoch_seconds": round(epoch_s, 3),
               "lr": self.scheduler.lr,
               **{f"train_{k}": float(v) for k, v in train_avg.items()}}
        if val_metrics:
            rec.update({f"val_{k}": float(v) for k, v in val_metrics.items()})
        append_metrics_line(self.output_dir, rec)

    # ------------------------------------------------------------ checkpoint
    def _host_state(self, epoch: int, rmse: float) -> Dict:
        return {"epoch": epoch, "rmse": rmse, "history": self.history,
                # the historical best, apart from this checkpoint's rmse, so
                # that resuming from 'latest' never lowers the bar
                "best_rmse": self.best_rmse, "best_epoch": self.best_epoch,
                "scheduler": self.scheduler.state_dict(),
                "early_stopping": (self.early_stopping.state_dict()
                                   if self.early_stopping else None)}

    def _device_state(self):
        return {"params": self.model.state_dict(),
                "opt_state": self.state.optimizer.state_dict(),
                "step": self.state.step}

    def save_best(self, epoch: int, rmse: float):
        """Async best-checkpoint save (overlaps the next epoch)."""
        self._ckpt_writer.save(os.path.join(self.output_dir, "best_model"),
                               self._device_state(),
                               self._host_state(epoch, rmse))

    def save_latest(self, epoch: int, rmse: float):
        """Rolling latest checkpoint, for restart after a failure."""
        self._ckpt_writer.save(os.path.join(self.output_dir, "latest"),
                               self._device_state(),
                               self._host_state(epoch, rmse))

    def restore(self, path: str):
        self._ckpt_writer.wait()   # finalize any in-flight save of this path
        device_state, host_state = restore_checkpoint(path)
        self.model.load_state_dict(device_state["params"])
        self.state.optimizer.load_state_dict(device_state["opt_state"])
        self.state.step = int(device_state["step"])
        self.history = host_state["history"]
        self.best_rmse = host_state.get("best_rmse", host_state["rmse"])
        self.best_epoch = host_state.get("best_epoch", host_state["epoch"])
        self.start_epoch = host_state["epoch"] + 1
        self.scheduler.load_state_dict(host_state["scheduler"])
        if self.early_stopping is not None and host_state.get("early_stopping"):
            self.early_stopping.load_state_dict(host_state["early_stopping"])
        print0(f"Restored checkpoint from {path} (epoch "
               f"{host_state['epoch']}, rmse {host_state['rmse']:.4f})")
