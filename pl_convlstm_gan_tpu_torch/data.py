"""Data of the three model families: the synthetic moving-blob sequences,
the synthetic and the Fenhe downscaling datasets, the seeded 70/15/15 and
by-year splits, numpy batching, and a prefetch to the device.

Copies of the JAX package's ``data/frames.py`` (``NpyFramesDataset``: an
on-disk ``.npy`` / ``.npz`` stack of frame sequences, ``data.source:
frames``), ``data/synthetic.py``
(``SyntheticSequenceDataset``, ``SyntheticDownscalingDataset``; pure numpy:
the same seed gives the same items bit for bit), ``data/fenhe.py``
(``FenheDataset`` and its helpers; pandas, which reads the station tables,
is imported only when a Fenhe dataset is built), ``data/splits.py``
(``Subset``, ``split_dataset_random``, ``year_indices``,
``split_dataset_by_year``) and ``data/pipeline.py`` (``make_grain_loader``,
the grain pipeline of ``data.loader: grain``, with grain imported when a
loader is made and the process index and count those of the trainer's data
group, not JAX's process; ``batch_iterator``, ``eval_batches`` with
wrap-padding, and ``_process_slice``: under data parallelism each rank
takes its contiguous block of every global batch, in JAX's index order, and
every rank yields the same number of batches, since a rank that entered an
extra step would deadlock the collectives). ``prefetch_to_device`` takes
the place of the JAX ``prefetch_to_device``: it copies each batch from
pinned host memory with ``non_blocking`` a batch or two ahead of the step
that reads it.
"""
from __future__ import annotations

import collections
import itertools
import os
import struct
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class SyntheticSequenceDataset:
    """Moving-blob sequences: item = (input_frames [T_in,1,H,W],
    target_frames [T_out,1,H,W]) float32 in [0, 1]."""

    num_blobs = 3

    def __init__(self, num_sequences: int = 256, input_frames: int = 5,
                 output_frames: int = 10, image_size: int = 64,
                 seed: int = 0):
        self.num_sequences = num_sequences
        self.t_in = input_frames
        self.t_out = output_frames
        self.size = image_size
        self.seed = seed
        yy, xx = np.mgrid[0:image_size, 0:image_size]
        self._yy = yy.astype(np.float32)
        self._xx = xx.astype(np.float32)

    def __len__(self) -> int:
        return self.num_sequences

    def _render(self, pos: np.ndarray, radius: np.ndarray) -> np.ndarray:
        frame = np.zeros((self.size, self.size), np.float32)
        for (py, px), r in zip(pos, radius):
            d2 = (self._yy - py) ** 2 + (self._xx - px) ** 2
            frame += np.exp(-d2 / (2 * r * r)).astype(np.float32)
        return np.clip(frame, 0.0, 1.0)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        total = self.t_in + self.t_out
        margin = max(2.0, self.size / 8.0)
        speed = max(0.5, self.size / 64.0)
        pos = rng.uniform(margin, self.size - margin,
                          (self.num_blobs, 2)).astype(np.float32)
        vel = rng.uniform(-3 * speed, 3 * speed,
                          (self.num_blobs, 2)).astype(np.float32)
        radius = rng.uniform(self.size / 20.0 + 1.0, self.size / 10.0 + 1.5,
                             self.num_blobs).astype(np.float32)
        frames = np.empty((total, 1, self.size, self.size), np.float32)
        lo, hi = margin / 2.0, self.size - margin / 2.0
        for t in range(total):
            frames[t, 0] = self._render(pos, radius)
            pos = pos + vel
            for d in range(2):          # bounce off the edges
                over = (pos[:, d] < lo) | (pos[:, d] > hi)
                vel[over, d] *= -1
            pos = np.clip(pos, lo, hi)
        return frames[:self.t_in], frames[self.t_in:]


def _smooth_field(rng: np.random.Generator, shape: Tuple[int, ...],
                  blur: int = 3) -> np.ndarray:
    """White noise box-blurred ``blur`` times along both axes."""
    x = rng.random(shape).astype(np.float32)
    for _ in range(blur):
        for axis in (-2, -1):
            x = (np.roll(x, 1, axis) + x + np.roll(x, -1, axis)) / 3.0
    return x


class SyntheticDownscalingDataset:
    """Fenhe-shaped synthetic data: item = (x_lr [T,1,H,W], dem [1,Hs,Ws],
    lu [C,Hs,Ws], s_coords [N,2] int64, s_vals [T,N]); ``num_days - T``
    windows of daily LR rain (smooth fields with occasional heavy cells),
    a smooth DEM and a one-hot LUCC at H*scale, stations observing the LR
    rain at their cell times U(0.8, 1.2)."""

    def __init__(self, num_days: int = 128, T: int = 5, lr_size: int = 16,
                 scale_factor: int = 8, num_stations: int = 16,
                 num_lu_classes: int = 5, seed: int = 0,
                 start_year: int = 2012, end_year: int = 2012):
        rng = np.random.default_rng(seed)
        self.T = T
        self.start_year = start_year
        self.end_year = end_year
        h = w = lr_size
        hs = ws = lr_size * scale_factor
        self.scale_factor = scale_factor
        base = _smooth_field(rng, (num_days, h, w)) * 8.0
        heavy = (rng.random((num_days, h, w)) > 0.97) * rng.gamma(
            2.0, 15.0, (num_days, h, w))
        self.rain_lr = np.maximum(base + heavy, 0.0).astype(np.float32)
        self.dem_norm = _smooth_field(rng, (hs, ws), blur=6).astype(np.float32)
        lucc = rng.integers(1, num_lu_classes + 1, (hs, ws))
        self.lucc_onehot = np.stack(
            [(lucc == k).astype(np.float32)
             for k in range(1, num_lu_classes + 1)])
        self.is_multiyear_lucc = False
        self.s_coords = np.stack([rng.integers(0, h, num_stations),
                                  rng.integers(0, w, num_stations)],
                                 axis=1).astype(np.int64)
        at = self.rain_lr[:, self.s_coords[:, 0], self.s_coords[:, 1]]
        self.s_values = (at * rng.uniform(0.8, 1.2, at.shape)
                         ).astype(np.float32)                     # [days, N]

    @property
    def num_lu_classes(self) -> int:
        return self.lucc_onehot.shape[0]

    def __len__(self) -> int:
        return self.rain_lr.shape[0] - self.T

    def __getitem__(self, idx: int):
        x_lr = self.rain_lr[idx:idx + self.T][:, None]
        return (x_lr, self.dem_norm[None], self.lucc_onehot,
                self.s_coords.copy(), self.s_values[idx:idx + self.T])


# ------------------------------------------------------------------- Fenhe

class NpyFramesDataset:
    """On-disk frame sequences for the forecaster / GAN families; item =
    (inputs [T_in, C, H, W] float32, targets [T_out, C, H, W] float32).

    A copy of the JAX package's ``data/frames.py``. Layouts (by rank):
    ``[N, T, H, W]`` (N single-channel sequences), ``[N, T, C, H, W]``, or
    ``[T, H, W]``, one long movie cut into windows ``stride`` frames apart
    (default: non-overlapping). ``.npy`` is memory-mapped (``mmap``);
    ``.npz`` is read eagerly from entry ``key``. Values are multiplied by
    ``scale``."""

    def __init__(self, path: str, input_frames: int, output_frames: int,
                 stride: Optional[int] = None, scale: float = 1.0,
                 key: str = "frames", mmap: bool = True):
        self.t_in = input_frames
        self.t_out = output_frames
        self.scale = float(scale)
        total = input_frames + output_frames
        if path.endswith(".npz"):
            with np.load(path) as zf:
                arr = np.asarray(zf[key])
        else:
            arr = np.load(path, mmap_mode="r" if mmap else None)

        if arr.ndim == 3:            # one long movie [T, H, W]
            self._movie = arr
            self._stride = stride or total
            n_windows = (arr.shape[0] - total) // self._stride + 1
            if n_windows <= 0:
                raise ValueError(
                    f"movie of {arr.shape[0]} frames too short for "
                    f"{total}-frame windows")
            self._n = n_windows
        elif arr.ndim in (4, 5):     # [N, T(, C), H, W]
            if arr.shape[1] < total:
                raise ValueError(
                    f"sequences have {arr.shape[1]} frames, need >= {total}")
            self._movie = None
            self._seqs = arr
            self._n = arr.shape[0]
        else:
            raise ValueError(f"unsupported frame array rank {arr.ndim} "
                             f"(shape {arr.shape})")

    def __len__(self) -> int:
        return self._n

    def _window(self, idx: int) -> np.ndarray:
        total = self.t_in + self.t_out
        if self._movie is not None:
            start = idx * self._stride
            w = self._movie[start:start + total]          # [T, H, W]
            return np.asarray(w)[:, None]                 # [T, 1, H, W]
        w = np.asarray(self._seqs[idx, :total])
        if w.ndim == 3:                                   # [T, H, W]
            w = w[:, None]
        return w                                          # [T, C, H, W]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        w = self._window(int(idx)).astype(np.float32)
        if self.scale != 1.0:
            w = w * self.scale
        return w[:self.t_in], w[self.t_in:]


def read_shapefile_extent(shp_path: str) -> List[float]:
    """[min_lat, max_lat, min_lon, max_lon] from an ESRI shapefile's main
    header: four little-endian doubles at byte 36 (Xmin, Ymin, Xmax,
    Ymax)."""
    with open(shp_path, "rb") as f:
        header = f.read(100)
    if len(header) < 68:
        raise ValueError(f"Not a valid shapefile: {shp_path}")
    xmin, ymin, xmax, ymax = struct.unpack("<4d", header[36:68])
    return [ymin, ymax, xmin, xmax]


def is_leap_year(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def days_in_year(year: int) -> int:
    return 366 if is_leap_year(year) else 365


def lucc_to_onehot(lucc: np.ndarray, ignore_index: int = 0) -> np.ndarray:
    """One-hot [C, H, W] over the unique classes other than
    ``ignore_index``: the class count depends on the data and sets the
    model's lu_channels."""
    labels = np.unique(lucc[lucc != ignore_index])
    onehot = np.zeros((len(labels),) + lucc.shape, dtype=np.float32)
    for i, label in enumerate(labels):
        onehot[i, lucc == label] = 1.0
    return onehot


def _read_table(path: str, **kwargs):
    """A station table: .csv/.txt by pandas, .xlsx by pandas with openpyxl,
    or the .csv beside it when openpyxl is missing."""
    import pandas as pd
    if str(path).endswith((".csv", ".txt")):
        return pd.read_csv(path, **kwargs)
    try:
        return pd.read_excel(path, **kwargs)
    except ImportError as e:
        csv_alt = str(Path(path).with_suffix(".csv"))
        if os.path.exists(csv_alt):
            return pd.read_csv(csv_alt, **kwargs)
        raise ImportError(
            f"Reading {path} needs openpyxl (not installed). Provide a .csv "
            f"with the same columns at {csv_alt} instead.") from e


def repair_negative_values(series: np.ndarray,
                           spatial_mean: np.ndarray) -> np.ndarray:
    """A negative entry becomes the mean of its non-negative temporal
    neighbours (the previous one as already repaired), else the spatial
    mean across stations of that day, else 0."""
    out = series.copy()
    for t in range(len(out)):
        if out[t] >= 0:
            continue
        candidates = []
        if t - 1 >= 0 and out[t - 1] >= 0:
            candidates.append(out[t - 1])
        if t + 1 < len(out) and series[t + 1] >= 0:
            candidates.append(series[t + 1])
        if candidates:
            out[t] = np.mean(candidates)
        elif not np.isnan(spatial_mean[t]):
            out[t] = spatial_mean[t]
        else:
            out[t] = 0.0
    return out


class FenheDataset:
    """The Fenhe basin's daily windows: item = (x_lr [T,1,H,W], dem
    [1,Hd,Wd] min-max normalized, lu [C,Hl,Wl] one-hot (multi-year LUCC:
    the layer of the window's middle day's year), s_coords [N,2] int64,
    s_vals [T,N]). Rain is a .npy with NaN/inf -> 0; stations come from a
    meta table (id, lon, lat) and a daily table (year, month, day, one
    column per station id), placed on the grid by the shapefile's extent
    (or ``grid_extent``), truncating toward zero; stations outside the grid
    are skipped and negative values repaired (``repair_negative_values``)."""

    def __init__(self, rain_lr_path: str, dem_path: str, lucc_path: str,
                 rain_meta_path: str = "", rain_station_path: str = "",
                 shp_path: str = "", T: int = 5,
                 start_year: int = 2012, end_year: int = 2021,
                 grid_extent: Optional[Sequence[float]] = None):
        self.rain_lr = np.nan_to_num(np.load(rain_lr_path).astype(np.float32),
                                     nan=0.0, posinf=0.0, neginf=0.0)
        self.dem = np.load(dem_path)
        self.dem_norm = ((self.dem - self.dem.min())
                         / (self.dem.max() - self.dem.min() + 1e-7)
                         ).astype(np.float32)
        lucc_data = np.load(lucc_path)
        if lucc_data.ndim == 3:
            self.lucc_multiyear = lucc_data.astype(int)
            self.is_multiyear_lucc = True
            mapping = Path(lucc_path).parent / "lucc_year_mapping.npy"
            self.lucc_years = (np.load(mapping) if mapping.exists()
                               else np.arange(start_year, end_year + 1))
            if len(self.lucc_years) != self.lucc_multiyear.shape[0]:
                raise ValueError(
                    f"Multi-year LUCC has {self.lucc_multiyear.shape[0]} "
                    f"layers but the year mapping covers "
                    f"{len(self.lucc_years)} years "
                    f"({self.lucc_years[0]}..{self.lucc_years[-1]}). Provide "
                    f"a lucc_year_mapping.npy when layers are not "
                    f"one-per-calendar-year.")
            self.lucc_onehot_list = [lucc_to_onehot(self.lucc_multiyear[i])
                                     for i in range(len(self.lucc_years))]
            # each year is one-hot over its own classes: differing class
            # sets would give channel k other meanings in other years
            class_sets = [tuple(np.unique(l[l != 0]))
                          for l in self.lucc_multiyear]
            if len(set(class_sets)) > 1:
                raise ValueError(
                    "LUCC class sets differ across years "
                    f"({dict(zip(map(int, self.lucc_years), class_sets))}); "
                    "per-year one-hot channels would be inconsistent. "
                    "Harmonize the rasters first.")
            self._build_day_to_year_idx(start_year, end_year)
        else:
            self.lucc = lucc_data.astype(int)
            self.lucc_onehot = lucc_to_onehot(self.lucc)
            self.is_multiyear_lucc = False
        self.T = T
        self.start_year = start_year
        self.end_year = end_year
        if grid_extent is not None:
            self.grid_extent = list(grid_extent)
        elif shp_path:
            self.grid_extent = read_shapefile_extent(shp_path)
        else:
            raise ValueError("Provide shp_path or grid_extent")
        if not (rain_meta_path and rain_station_path):
            raise ValueError("rain_meta_path and rain_station_path are "
                             "required")
        self.s_coords, self.s_values = self._prepare_stations(
            rain_meta_path, rain_station_path, start_year, end_year)

    @property
    def num_lu_classes(self) -> int:
        if self.is_multiyear_lucc:
            return self.lucc_onehot_list[0].shape[0]
        return self.lucc_onehot.shape[0]

    def _build_day_to_year_idx(self, start_year: int, end_year: int) -> None:
        """Day -> LUCC layer: the layer of the day's year, or of the nearest
        year the mapping has; leap years counted."""
        idx = []
        for year in range(start_year, end_year + 1):
            where = np.where(self.lucc_years == year)[0]
            year_idx = int(where[0]) if len(where) else \
                int(np.argmin(np.abs(self.lucc_years - year)))
            idx.extend([year_idx] * days_in_year(year))
        self.day_to_year_idx = np.asarray(idx)

    def _prepare_stations(self, meta_path: str, station_path: str,
                          start_year: int, end_year: int):
        df_meta = _read_table(meta_path)
        # the reference's column names (station id, longitude, latitude)
        # or romanized aliases
        col_id = next(c for c in ("F_站号", "station_id", "id")
                      if c in df_meta.columns)
        col_lon = next(c for c in ("经度", "lon", "longitude")
                       if c in df_meta.columns)
        col_lat = next(c for c in ("纬度", "lat", "latitude")
                       if c in df_meta.columns)
        df_rain = (_read_table(station_path)
                   .query(f"year >= {start_year} and year <= {end_year}")
                   .sort_values(["year", "month", "day"])
                   .reset_index(drop=True))
        min_lat, max_lat, min_lon, max_lon = self.grid_extent
        rows_total, cols_total = self.rain_lr.shape[-2:]
        rain_values = df_rain.drop(columns=["year", "month", "day"],
                                   errors="ignore")
        spatial_mean = rain_values.mask(rain_values < 0).mean(axis=1).to_numpy()
        coords, val_list = [], []
        for _, row in df_meta.iterrows():
            st_id = int(row[col_id])
            lat, lon = row[col_lat], row[col_lon]
            # int() truncates toward zero: a coordinate a hair outside the
            # extent lands on the edge cell and is kept
            r_idx = int((max_lat - lat) / (max_lat - min_lat)
                        * (rows_total - 1))
            c_idx = int((lon - min_lon) / (max_lon - min_lon)
                        * (cols_total - 1))
            if not (0 <= r_idx < rows_total and 0 <= c_idx < cols_total):
                print(f"Station {st_id} ({lat},{lon}) out of bounds, skipped")
                continue
            col = str(st_id)
            if col not in df_rain.columns:
                continue
            series = df_rain[col].to_numpy(dtype=np.float32)
            coords.append([r_idx, c_idx])
            val_list.append(repair_negative_values(series, spatial_mean))
        if not val_list:
            raise ValueError("No valid stations found within grid bounds!")
        stacked = np.nan_to_num(np.stack(val_list, axis=1).astype(np.float32),
                                nan=0.0, posinf=0.0, neginf=0.0)
        # a table with missing or repeated days would shift every later
        # observation against rain_lr's day axis
        if stacked.shape[0] != self.rain_lr.shape[0]:
            raise ValueError(
                f"Station table covers {stacked.shape[0]} days but rain_lr "
                f"has {self.rain_lr.shape[0]}: the daily series must align "
                f"one-to-one with the rain grid (check for missing or "
                f"duplicated dates in {station_path})")
        return np.asarray(coords, dtype=np.int64), stacked

    def __len__(self) -> int:
        return self.rain_lr.shape[0] - self.T

    def __getitem__(self, idx: int):
        x_lr = self.rain_lr[idx:idx + self.T][:, None, ...]
        if self.is_multiyear_lucc:
            mid_idx = min(idx + self.T // 2, len(self.day_to_year_idx) - 1)
            lu = self.lucc_onehot_list[self.day_to_year_idx[mid_idx]]
        else:
            lu = self.lucc_onehot
        return (x_lr.astype(np.float32),
                self.dem_norm[None, ...].astype(np.float32),
                lu.astype(np.float32), self.s_coords.copy(),
                self.s_values[idx:idx + self.T].astype(np.float32))


# ------------------------------------------------------------------ splits

class Subset:
    """Index view over a map-style dataset."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def split_dataset_random(dataset, seed: int = 42):
    """Seeded permutation split into (train, val, test) Subsets, 70/15/15."""
    perm = np.random.RandomState(seed).permutation(len(dataset))
    n_train = int(len(dataset) * 0.7)
    n_val = int(len(dataset) * 0.15)
    print(f"Random split: train {n_train} | val {n_val} | "
          f"test {len(dataset) - n_train - n_val}")
    return (Subset(dataset, perm[:n_train].tolist()),
            Subset(dataset, perm[n_train:n_train + n_val].tolist()),
            Subset(dataset, perm[n_train + n_val:].tolist()))


def year_indices(dataset, start_year: int, end_year: int) -> List[int]:
    """Window indices whose start day lies in [start_year, end_year], each
    year's last ``T`` windows dropped (the reference's arithmetic) so that no
    window crosses into the next year; leap years counted."""
    indices: List[int] = []
    cumulative_days = 0
    for year in range(dataset.start_year, dataset.end_year + 1):
        d = days_in_year(year)
        if start_year <= year <= end_year:
            indices.extend(range(cumulative_days,
                                 cumulative_days + d - dataset.T))
        cumulative_days += d
    return indices


def split_dataset_by_year(dataset, train_years: Tuple[int, int],
                          val_years: Tuple[int, int],
                          test_years: Tuple[int, int]):
    """(train, val, test) Subsets of the windows of each year range."""
    train_idx = year_indices(dataset, *train_years)
    val_idx = year_indices(dataset, *val_years)
    test_idx = year_indices(dataset, *test_years)
    print(f"Year split: train {train_years} {len(train_idx)} | "
          f"val {val_years} {len(val_idx)} | test {test_years} "
          f"{len(test_idx)}")
    return (Subset(dataset, train_idx), Subset(dataset, val_idx),
            Subset(dataset, test_idx))


def _stack(items):
    """A list of example tuples -> a tuple of batched arrays."""
    return tuple(np.stack([it[i] for it in items]) for i in range(len(items[0])))


def _process_slice(idx, process_index: int = 0, process_count: int = 1):
    """Rank ``process_index``'s contiguous block of a global batch's index
    list (``process_count`` equal blocks; the whole list for one
    process)."""
    if process_count == 1:
        return idx
    local = len(idx) // process_count
    if local * process_count != len(idx):
        raise ValueError(f"global batch {len(idx)} not divisible by "
                         f"{process_count} processes")
    return idx[process_index * local:(process_index + 1) * local]


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0, process_index: int = 0,
                   process_count: int = 1) -> Iterator:
    """One epoch of full numpy batches (the last partial batch is dropped);
    the order is shuffled by seed + epoch. ``batch_size`` is the global
    batch: every process draws the same order and yields its block of each
    batch, so every process yields the same number of batches."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    for start in range(0, n - n % batch_size, batch_size):
        idx = _process_slice(order[start:start + batch_size], process_index,
                            process_count)
        yield _stack([dataset[int(i)] for i in idx])


def eval_batches(dataset, batch_size: int, process_index: int = 0,
                 process_count: int = 1) -> Iterator:
    """Full-coverage eval batching: yields (batch, n_valid). The last partial
    batch is wrap-padded to the full (global) batch size; eval steps give
    the rows with global index >= n_valid weight zero. A process yields its
    block of every global batch (rows ``process_index * local`` on), with
    the global ``n_valid``."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        n_valid = min(batch_size, n - start)
        idx = _process_slice([(start + j) % n for j in range(batch_size)],
                            process_index, process_count)
        yield _stack([dataset[int(i)] for i in idx]), n_valid


def make_grain_loader(dataset, batch_size: int, shuffle: bool = False,
                      seed: int = 0, num_epochs: Optional[int] = 1,
                      drop_remainder: bool = True,
                      shard_by_process: bool = True, worker_count: int = 0,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> Iterable:
    """A ``grain.MapDataset`` pipeline: [shard] -> shuffle -> [truncate] ->
    [repeat] -> batch (-> worker processes), yielding tuples of stacked
    numpy arrays. A copy of the JAX package's ``make_grain_loader``.

    ``batch_size`` is the global batch. With ``process_count`` > 1 each
    process reads the interleaved shard ``dataset[process_index::
    process_count]`` and yields its ``batch_size / process_count`` rows of
    every global batch; every shard is truncated, after the shuffle, to one
    length, a multiple of the local batch, so that every process takes the
    same number of steps. The index and count default to this process's
    rank and world (``parallel.mesh.rank_and_world``); the trainers pass
    their data group's (``mesh_position``), which under tensor parallelism
    gives the ranks of a model group the same rows. ``num_epochs``: 1 = one
    pass, None = endless. grain is imported here; where it is not
    installed this raises ImportError naming ``data.loader: plain``."""
    try:
        import grain
    except ImportError as e:
        from .config import GRAIN_MISSING
        raise ImportError(GRAIN_MISSING) from e
    if process_index is None or process_count is None:
        from .parallel.mesh import rank_and_world
        rank, world = rank_and_world()
        process_index = rank if process_index is None else process_index
        process_count = world if process_count is None else process_count

    ds = grain.MapDataset.source(dataset)
    local_bs = batch_size
    common = None
    if shard_by_process and process_count > 1:
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        ds = ds[process_index::process_count]
        local_bs = batch_size // process_count
        n = len(dataset)
        common = ((n // process_count // local_bs) * local_bs
                  if drop_remainder else n // process_count)
    if shuffle:
        ds = ds.shuffle(seed=seed)
    if common is not None:
        ds = ds[:common]
    # grain's convention: repeat(None) = endless, 1 = one pass
    if num_epochs is None or num_epochs != 1:
        ds = ds.repeat(num_epochs)
    ds = ds.batch(local_bs, drop_remainder=drop_remainder, batch_fn=_stack)
    if worker_count > 0:
        return ds.to_iter_dataset().mp_prefetch(
            grain.MultiprocessingOptions(num_workers=worker_count))
    return ds


def to_device(batch, device: torch.device):
    """A tuple of numpy arrays -> tensors on ``device``; to a GPU from
    pinned memory without waiting for the copy."""
    out = []
    for a in batch:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


PREFETCH = 2   # batches copied ahead of the one being consumed


def prefetch_to_device(iterator: Iterable, device: torch.device) -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, ``PREFETCH`` of them
    copied ahead of the one being consumed."""
    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, PREFETCH):
        queue.append(to_device(batch, device))
    while queue:
        out = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(to_device(nxt, device))
        yield out
