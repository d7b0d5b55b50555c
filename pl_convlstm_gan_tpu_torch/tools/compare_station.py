"""Station-comparison CLI: gauge observations vs satellite daily accumulations.

Port of the reference analysis tool (``src/scripts/
compare_station.py:33-250``): pivots the per-cell satellite CSV to (time) x
(lat, lon), finds the nearest grid cell per station, computes MAE/RMSE/correlation/
overlap per station for each accumulation system, writes per-station timeseries
plots and a summary CSV.

Usage: python -m pl_convlstm_gan_tpu_torch.tools.compare_station \
           --sat-csv hydro=fenhe_hydro_2012.csv --sat-csv cma=fenhe_cma_2012.csv \
           --meta meta.csv --rain rain.csv --start-year 2012 --end-year 2012 \
           --out-dir output/station_compare
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np


def load_satellite_csv(path: str):
    """Satellite daily-accumulation CSV -> (times, lats, lons, values[time, cell]).

    Accepts BOTH on-disk formats, auto-detected from the header:

    - ours (tools.cmorph): wide, index=time, one column per cell named
      '{lat:.3f}_{lon:.3f}';
    - the reference's (``src/scripts/cmorph.py:134-137``):
      long, one row per (time, lat, lon) with a ``precip`` column and NaN
      rows dropped at export — the format its ``compare_station.py:33-51``
      pivots. Users migrating with existing reference-produced exports feed
      them here unchanged; cells missing on a given day (the dropped NaN
      rows) reappear as NaN and are masked by ``compute_metrics`` like any
      other missing observation."""
    import pandas as pd
    header_cols = set(pd.read_csv(path, nrows=0).columns)
    if {"time", "lat", "lon", "precip"} <= header_cols:
        df = pd.read_csv(path, parse_dates=["time"])
        df = df.dropna(subset=["precip"])
        if df.empty:
            raise ValueError(f"{path} contains no valid precip records")
        # keep-first-with-warning dedupe, matching what compare_systems does
        # for the wide format downstream — pivot_table would otherwise
        # silently AVERAGE duplicated (time, lat, lon) rows (e.g. two export
        # runs concatenated), giving format-dependent metrics
        dups = df.duplicated(subset=["time", "lat", "lon"])
        if dups.any():
            print(f"WARNING: {path}: {int(dups.sum())} duplicated "
                  f"(time, lat, lon) rows dropped (kept first)")
            df = df[~dups]
        pivot = df.pivot_table(index="time", columns=["lat", "lon"],
                               values="precip").sort_index()
        # reindex to the FULL lat x lon grid: pivot_table only materializes
        # OBSERVED (lat, lon) pairs, so a cell that was NaN on every day
        # (dropped entirely at export) would vanish from the grid and
        # nearest_cell could bind a station to a different, farther cell
        # than the wide format would — format-dependent metrics. Restored
        # as all-NaN columns, such cells lose nearest_cell ties exactly
        # like their wide counterparts (overlap=0 metrics).
        full = pd.MultiIndex.from_product(
            [np.sort(df["lat"].unique()), np.sort(df["lon"].unique())])
        pivot = pivot.reindex(columns=full)
        coords = np.array(list(pivot.columns), dtype=np.float64)
        return (pivot.index, coords[:, 0], coords[:, 1],
                pivot.to_numpy(dtype=np.float32))
    df = pd.read_csv(path, index_col=0, parse_dates=True)
    coords = np.array([[float(p) for p in c.split("_")] for c in df.columns])
    return df.index, coords[:, 0], coords[:, 1], df.to_numpy(dtype=np.float32)


def nearest_cell(lats: np.ndarray, lons: np.ndarray, lat: float,
                 lon: float) -> int:
    """Nearest grid cell by squared degree distance (reference :54-63)."""
    return int(np.argmin((lats - lat) ** 2 + (lons - lon) ** 2))


def compute_metrics(obs: np.ndarray, sat: np.ndarray) -> Dict[str, float]:
    """MAE / RMSE / correlation / overlap count on jointly-valid days
    (reference :66-76)."""
    valid = ~np.isnan(obs) & ~np.isnan(sat)
    n = int(valid.sum())
    if n == 0:
        return {"mae": np.nan, "rmse": np.nan, "corr": np.nan, "overlap": 0}
    o, s = obs[valid], sat[valid]
    mae = float(np.mean(np.abs(o - s)))
    rmse = float(np.sqrt(np.mean((o - s) ** 2)))
    corr = float(np.corrcoef(o, s)[0, 1]) if n > 1 else np.nan
    return {"mae": mae, "rmse": rmse, "corr": corr, "overlap": n}


def compare_systems(sat_csvs: Dict[str, str], meta_path: str, rain_path: str,
                    start_year: int, end_year: int, out_dir: str,
                    make_plots: bool = True):
    """Per-station metrics for each accumulation system + summary CSV
    (reference :120-250)."""
    import pandas as pd
    from .station import read_station_meta, read_rain_series

    os.makedirs(out_dir, exist_ok=True)
    meta = read_station_meta(meta_path)
    systems = {name: load_satellite_csv(path) for name, path in sat_csvs.items()}

    rows = []
    for st_id, (lon, lat) in meta.items():
        try:
            obs = read_rain_series(rain_path, st_id, start_year, end_year)
        except KeyError:
            continue
        row = {"station": st_id, "lon": lon, "lat": lat}
        series_for_plot = {}
        rmses = {}
        for name, (times, lats, lons, vals) in systems.items():
            cell = nearest_cell(lats, lons, lat, lon)
            # align by TIMESTAMP (reference compute_metrics joins on the
            # series index, :66-69): a missing day in either table drops that
            # day only — positional truncation would silently offset every
            # later day against the wrong date
            sat = pd.Series(vals[:, cell], index=times)
            # duplicated dates would make the index join raise mid-run with
            # no station context — dedupe (keep first) with a warning, like
            # the cmorph ingest does for duplicate timestamps
            for label, s in (("gauge", obs), ("satellite", sat)):
                dups = s.index.duplicated()
                if dups.any():
                    print(f"WARNING: station {st_id}: {int(dups.sum())} "
                          f"duplicated {label} dates dropped (kept first)")
            obs_u = obs[~obs.index.duplicated(keep="first")]
            sat = sat[~sat.index.duplicated(keep="first")]
            joined = pd.concat({"obs": obs_u, "sat": sat}, axis=1,
                               join="inner")
            m = compute_metrics(joined["obs"].to_numpy(),
                                joined["sat"].to_numpy())
            row.update({f"{name}_{k}": v for k, v in m.items()})
            series_for_plot[name] = (joined.index, joined["sat"].to_numpy())
            if not np.isnan(m["rmse"]):
                rmses[name] = m["rmse"]
        # lowest-RMSE system per station (reference :177-179 'better_system';
        # generalized from two fixed systems to N)
        row["better_system"] = min(rmses, key=rmses.get) if rmses else None
        rows.append(row)
        if make_plots:
            _station_plot(st_id, obs, series_for_plot, out_dir)

    summary = pd.DataFrame(rows)
    out_csv = os.path.join(out_dir, "station_comparison_summary.csv")
    summary.to_csv(out_csv, index=False)
    print(f"saved {out_csv} ({len(summary)} stations)")
    # console overview like the reference (:238-249): station, per-system
    # rmse/corr, winning system
    if len(summary):
        cols = (["station"]
                + [f"{n}_{k}" for n in systems for k in ("rmse", "corr")]
                + ["better_system"])
        print(summary[cols].to_string(index=False))
    return summary


def _station_plot(st_id: int, obs, systems, out_dir: str):
    """Per-station obs-vs-satellite timeseries, date-indexed (reference
    :79-96 plots against the series index)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(14, 4))
    plt.plot(obs.index, obs.to_numpy(), label="gauge obs", linewidth=1,
             color="k")
    for name, (idx, sat) in systems.items():
        plt.plot(idx, sat, label=name, linewidth=0.8, alpha=0.8)
    plt.xlabel("date")
    plt.ylabel("precipitation (mm/day)")
    plt.title(f"Station {st_id}")
    plt.legend()
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, f"station_{st_id}.png"), dpi=120)
    plt.close()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sat-csv", action="append", required=True,
                   help="name=path, repeatable (one per accumulation system)")
    p.add_argument("--meta", required=True)
    p.add_argument("--rain", required=True)
    p.add_argument("--start-year", type=int, default=2012)
    p.add_argument("--end-year", type=int, default=2021)
    p.add_argument("--out-dir", default="output/station_compare")
    p.add_argument("--no-plots", action="store_true")
    args = p.parse_args()
    sat_csvs = dict(kv.split("=", 1) for kv in args.sat_csv)
    compare_systems(sat_csvs, args.meta, args.rain, args.start_year,
                    args.end_year, args.out_dir, make_plots=not args.no_plots)


if __name__ == "__main__":
    main()
