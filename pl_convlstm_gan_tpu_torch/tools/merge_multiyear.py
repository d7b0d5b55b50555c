"""Merge per-year artifacts into the multi-year training inputs.

Port of the reference (``src/scripts/merge_multiyear_data.py``):
- ``merge_rain_data`` (:5-45): concat per-year daily rain npys on the time axis ->
  the single npy ``configs/default.yaml`` points at.
- ``merge_lucc_data`` (:48-98): stack per-year LUCC grids to (Y, H, W) and write the
  ``lucc_year_mapping.npy`` companion the dataset uses for window-midpoint year
  selection (src/datasets/fenhe_dataset.py:44-51).

Usage: python -m pl_convlstm_gan_tpu_torch.tools.merge_multiyear \
           --rain-template 'daily/fenhe_hydro_08-08_{year}.npy' \
           --lucc-template 'static/lucc_1km_{year}.npy' \
           --start-year 2012 --end-year 2021 --out-dir data/processed
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def merge_rain_data(template: str, start_year: int, end_year: int,
                    out_path: str) -> np.ndarray:
    """Concat per-year [days, H, W] rain arrays along time."""
    arrays = []
    for year in range(start_year, end_year + 1):
        path = template.format(year=year)
        arr = np.load(path)
        print(f"  {path}: {arr.shape}")
        arrays.append(arr)
    merged = np.concatenate(arrays, axis=0).astype(np.float32)
    np.save(out_path, merged)
    print(f"saved {out_path} {merged.shape}")
    return merged


def merge_lucc_data(template: str, start_year: int, end_year: int,
                    out_path: str) -> np.ndarray:
    """Stack per-year [H, W] LUCC grids to (Y, H, W) + year mapping npy."""
    arrays, years = [], []
    for year in range(start_year, end_year + 1):
        path = template.format(year=year)
        arrays.append(np.load(path))
        years.append(year)
        print(f"  {path}: {arrays[-1].shape}")
    stacked = np.stack(arrays, axis=0)
    np.save(out_path, stacked)
    mapping_path = os.path.join(os.path.dirname(out_path), "lucc_year_mapping.npy")
    np.save(mapping_path, np.asarray(years))
    print(f"saved {out_path} {stacked.shape} + {mapping_path}")
    return stacked


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rain-template", help="per-year rain npy path with {year}")
    p.add_argument("--lucc-template", help="per-year LUCC npy path with {year}")
    p.add_argument("--start-year", type=int, default=2012)
    p.add_argument("--end-year", type=int, default=2021)
    p.add_argument("--out-dir", default="data/processed")
    args = p.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    span = f"{args.start_year}-{args.end_year}"
    if args.rain_template:
        merge_rain_data(args.rain_template, args.start_year, args.end_year,
                        os.path.join(args.out_dir, f"rain_daily_{span}.npy"))
    if args.lucc_template:
        merge_lucc_data(args.lucc_template, args.start_year, args.end_year,
                        os.path.join(args.out_dir, f"lucc_1km_{span}.npy"))


if __name__ == "__main__":
    main()
