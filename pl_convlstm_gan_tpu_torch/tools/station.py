"""Station table reader helpers.

Port of the reference helper (``src/scripts/station.py:3-25``):
read the station metadata table into a dict keyed by station id, and a per-station
daily rain series (year-filtered). Accepts .xlsx (needs openpyxl) or .csv."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..data import _read_table


def read_station_meta(meta_path: str) -> Dict[int, Tuple[float, float]]:
    """station id -> (lon, lat)."""
    df = _read_table(meta_path)
    col_id = next(c for c in ("F_站号", "station_id", "id") if c in df.columns)
    col_lon = next(c for c in ("经度", "lon", "longitude") if c in df.columns)
    col_lat = next(c for c in ("纬度", "lat", "latitude") if c in df.columns)
    return {int(r[col_id]): (float(r[col_lon]), float(r[col_lat]))
            for _, r in df.iterrows()}


def read_rain(rain_path: str, station_id: int, start_year: int,
              end_year: int) -> np.ndarray:
    """Daily series for one station over [start_year, end_year]."""
    return read_rain_series(rain_path, station_id, start_year,
                            end_year).to_numpy(dtype=np.float32)


def read_rain_series(rain_path: str, station_id: int, start_year: int,
                     end_year: int):
    """Daily series for one station as a date-indexed pandas Series.

    The dates matter: the reference's compute_metrics joins gauge and
    satellite series on their time index (compare_station.py:66-76), so
    comparisons must align by timestamp, not position — a missing day in
    either table must drop that day, not shift everything after it."""
    import pandas as pd
    df = (_read_table(rain_path)
          .query(f"year >= {start_year} and year <= {end_year}")
          .sort_values(["year", "month", "day"])
          .reset_index(drop=True))
    col = str(station_id)
    if col not in df.columns:
        raise KeyError(f"station {station_id} not in {rain_path}")
    idx = pd.to_datetime(df[["year", "month", "day"]])
    return pd.Series(df[col].to_numpy(dtype=np.float32), index=idx)
