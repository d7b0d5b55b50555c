"""CMORPH ingest: hourly 0.25-degree NetCDF -> basin-masked daily precipitation.

Port of the reference ETL (``src/scripts/cmorph.py:11-207``):
open_mfdataset concat on time, longitude 0..360 -> -180..180 + sort, 3-D polygon
basin mask from an EPSG:4326-normalized shapefile (regionmask), crop to the
mask's valid-cell extent, leap-year/duplicate-timestamp QC, and TWO daily
accumulation systems:

- hydrological "08-08" (Beijing time) == UTC-day resample ``sum(min_count=24)``
- meteorological "20-20" == ``shift(time=-12h)`` then the same resample

exporting npy + per-system CSV and a comparison plot.

Requires: xarray, regionmask, geopandas (lazy imports; not deps of the GPU host).
Usage: python -m pl_convlstm_gan_tpu_torch.tools.cmorph \
           --nc-glob 'cmorph_{year}_*.nc' --shp fenhe.shp \
           --out-dir data/processed/daily --start-year 2012 --end-year 2021
(the '{year}' placeholder is substituted per year; required when processing
more than one year so each year reads its own files)
"""
from __future__ import annotations

import argparse
import os

# one calendar implementation with the port's data layer
from ..data import days_in_year


def normalize_crs(gdf):
    """Normalize the basin shapefile to EPSG:4326 before masking (reference
    cmorph.py:40-44): set the CRS when the file carries none, reproject
    otherwise. Without this, a shapefile in a projected CRS (common for
    Chinese basin products) makes ``mask_3D_geopandas`` compare projected
    meters against geographic degrees — an empty/wrong mask and silently
    all-NaN output."""
    if gdf.crs is None:
        gdf.set_crs("EPSG:4326", inplace=True)
        return gdf
    return gdf.to_crs("EPSG:4326")


def mask_valid_extent(mask2d, lons, lats):
    """Min rectangle of the basin mask's VALID cells (reference
    cmorph.py:61-72: ``lon_valid``/``lat_valid`` from ``basin_mask.any``).

    ``mask2d``: [lat, lon] boolean basin mask; ``lons``/``lats``: coordinate
    vectors. Returns (lon_min, lon_max, lat_min, lat_max) over cells that are
    actually inside the basin — NOT the polygon bbox (``gdf.total_bounds``):
    when a bbox edge row/col contains no basin cell *centers*, the bbox crop
    keeps it and produces a grid shape that misaligns with reference-produced
    DEM/LUCC/station grids. Pure numpy so the crop math is test-pinned without
    xarray (tests/test_tools.py)."""
    import numpy as np

    mask2d = np.asarray(mask2d).astype(bool)
    if not mask2d.any():
        raise ValueError(
            "basin mask has no valid cells — shapefile and grid do not "
            "overlap (check the shapefile CRS)")
    lon_sel = np.asarray(lons)[mask2d.any(axis=0)]
    lat_sel = np.asarray(lats)[mask2d.any(axis=1)]
    return (float(lon_sel.min()), float(lon_sel.max()),
            float(lat_sel.min()), float(lat_sel.max()))


def qc_hourly_times(times, year: int) -> dict:
    """Hourly-timestamp QC (reference cmorph.py:74-106), dependency-light
    (pandas only): duplicate timestamps (count + first five, as the reference
    reports), hour-count vs leap-year expectation with over/under direction,
    and the covered time range. Returns a dict; the CLI prints `messages`."""
    import pandas as pd

    times = pd.DatetimeIndex(times)
    dups = times[times.duplicated()]
    expected_hours = days_in_year(year) * 24
    msgs = []
    if len(dups) > 0:
        msgs.append(f"WARNING: {len(dups)} duplicate timestamps "
                    f"(first 5: {[str(t) for t in dups[:5]]})")
    diff = len(times) - expected_hours
    if diff > 0:
        msgs.append(f"WARNING: {diff} hours MORE than expected "
                    f"({len(times)} vs {expected_hours})")
    elif diff < 0:
        msgs.append(f"WARNING: {-diff} hours MISSING "
                    f"({len(times)} vs {expected_hours})")
    return {
        "total_hours": len(times), "expected_hours": expected_hours,
        "n_duplicates": int(len(dups)),
        "duplicate_times": [str(t) for t in dups[:5]],
        "time_range": (str(times.min()), str(times.max())) if len(times) else None,
        "messages": msgs,
    }


def daily_accumulations(values, times, year: int) -> dict:
    """The two daily accumulation systems (reference cmorph.py:108-119), pure
    numpy/pandas so the math is testable without xarray:

    - "hydro_08-08": Beijing-time 08:00->08:00 hydrological days == plain UTC
      calendar-day sums (UTC 00:00 == Beijing 08:00), NaN unless all 24 hours
      are present (min_count=24).
    - "cma_20-20": Beijing 20:00->20:00 meteorological days == shift the hourly
      series 12 positions earlier, then the same calendar-day sum — day D
      aggregates [D 12:00 UTC, D+1 12:00 UTC); the final day is NaN (its last
      12 source hours don't exist).

    `values`: [T, H, W] hourly grids (NaN outside the basin mask);
    `times`: matching hourly DatetimeIndex. Returns
    {system: (daily [D, H, W] float32, DatetimeIndex of D days)} plus a
    per-system day-count QC message list under key "messages"."""
    import numpy as np
    import pandas as pd

    t, h, w = values.shape
    df = pd.DataFrame(values.reshape(t, h * w),
                      index=pd.DatetimeIndex(times))
    df = df[~df.index.duplicated(keep="first")]
    # reindex to the CONTINUOUS hourly range so shift(-12) moves by 12 HOURS
    # even when source hours are missing: a gap becomes NaN rows that
    # min_count=24 turns into NaN days, instead of positionally misaligning
    # every 20-20 window after the gap. (The reference shifts the raw index,
    # reference cmorph.py:114 — silently wrong after any missing hour.)
    # anchor the range to DAY boundaries, not the first/last present hour:
    # if hour 0 of the series is missing, a min()-anchored range starts at
    # 01:00 and every shifted 20-20 day bin is one row short — NaN even when
    # all 24 of its *source* hours are present (found by hypothesis).
    df = df.reindex(pd.date_range(df.index.min().normalize(),
                                  df.index.max().normalize()
                                  + pd.Timedelta(hours=23), freq="h"))
    daily = {
        "hydro_08-08": df.resample("1D").sum(min_count=24),
        "cma_20-20": df.shift(-12).resample("1D").sum(min_count=24),
    }
    expected_days = days_in_year(year)
    out, msgs = {}, []
    for name, d in daily.items():
        arr = d.to_numpy().astype(np.float32).reshape(len(d), h, w)
        if len(d) != expected_days:
            msgs.append(f"WARNING: {name}: {len(d)} days, "
                        f"expected {expected_days}")
        out[name] = (arr, d.index)
    out["messages"] = msgs
    return out


def process_cmorph_to_fenhe(nc_glob: str, shp_path: str, out_dir: str, year: int,
                            make_plot: bool = True, csv_format: str = "wide"):
    # validate args BEFORE the expensive load/mask/accumulate pipeline — a
    # typo'd csv_format must not cost minutes of raster work (argparse only
    # guards the CLI, not API callers)
    if csv_format not in ("wide", "long", "both"):
        raise ValueError(f"csv_format must be wide|long|both, "
                         f"got {csv_format!r}")
    import numpy as np
    import pandas as pd
    import xarray as xr
    import regionmask
    import geopandas as gpd

    os.makedirs(out_dir, exist_ok=True)

    ds = xr.open_mfdataset(nc_glob, combine="by_coords")
    var = "cmorph" if "cmorph" in ds else list(ds.data_vars)[0]

    # longitude 0..360 -> -180..180 (identity for data already in range), then
    # BOTH axes sorted ascending — unconditionally, as the reference does
    # (cmorph.py:31-33): descending-lat files and post-conversion lon
    # disorder would otherwise silently flip/empty the mask and crop
    ds = ds.assign_coords(lon=(((ds.lon + 180) % 360) - 180))
    ds = ds.sortby(["lon", "lat"])

    # basin polygon mask, CRS-normalized first (reference cmorph.py:37-58)
    gdf = normalize_crs(gpd.read_file(shp_path))
    mask = regionmask.mask_3D_geopandas(gdf, ds.lon, ds.lat)
    basin = mask.isel(region=0)
    # mask sanity QC (reference cmorph.py:47-52 debug prints): an empty or
    # full mask means a CRS/extent mismatch — surface it before aggregation
    bvals = basin.values
    n_in = int(np.sum(bvals == True))        # noqa: E712 — may be float-NaN mask
    n_out = int(np.sum(bvals == False))      # noqa: E712
    print(f"[QC] {year}: basin mask {bvals.shape}: {n_in} cells inside, "
          f"{n_out} outside")
    if n_in == 0:
        raise ValueError(
            "basin mask has no valid cells — shapefile extent/CRS does not "
            "overlap the CMORPH grid (check lon convention and the .prj)")
    pre_crop = ds[var].where(basin)

    # crop to the min rectangle of the mask's VALID cells, not the polygon
    # bbox (reference cmorph.py:61-72; see mask_valid_extent)
    lon_min, lon_max, lat_min, lat_max = mask_valid_extent(
        basin.transpose("lat", "lon").values, ds.lon.values, ds.lat.values)
    # both axes are ascending after the sortby above, so plain min..max
    # slices select correctly; pin the dim order the numpy cores and the
    # lat-major CSV headers below assume (a (time, lon, lat)-stored variable
    # would otherwise flow through transposed, silently)
    masked = pre_crop.sel(lon=slice(lon_min, lon_max),
                          lat=slice(lat_min, lat_max))
    masked = masked.transpose("time", "lat", "lon")

    # QC report (reference cmorph.py:74-106), then dedupe (an improvement over
    # the reference, which only reports duplicates)
    qc = qc_hourly_times(masked.time.values, year)
    for m in qc["messages"]:
        print(f"[QC] {year}: {m}")
    if qc["time_range"]:
        print(f"[QC] {year}: time range {qc['time_range'][0]} ~ "
              f"{qc['time_range'][1]}")
    if qc["n_duplicates"]:
        _, unique_idx = np.unique(masked.time.values, return_index=True)
        masked = masked.isel(time=np.sort(unique_idx))

    # two accumulation systems + per-system day-count QC
    # (reference cmorph.py:108-119) — pure numpy/pandas core
    acc = daily_accumulations(np.asarray(masked.values), masked.time.values, year)
    for m in acc.pop("messages"):
        print(f"[QC] {year}: {m}")

    results, result_dates = {}, {}
    for name, (arr, dates) in acc.items():
        npy_path = os.path.join(out_dir, f"fenhe_{name}_{year}.npy")
        np.save(npy_path, arr)
        flat = arr.reshape(arr.shape[0], -1)
        csv_path = os.path.join(out_dir, f"fenhe_{name}_{year}.csv")
        if csv_format in ("wide", "both"):
            # per-cell wide CSV (our canonical export; reference
            # cmorph.py:121-141 is the long equivalent below)
            cols = [f"{float(la):.3f}_{float(lo):.3f}"
                    for la in masked.lat.values for lo in masked.lon.values]
            pd.DataFrame(flat, index=dates, columns=cols).to_csv(csv_path)
        if csv_format in ("long", "both"):
            # the reference's EXACT export shape (cmorph.py:134-137): one row
            # per (time, lat, lon) with NaN rows dropped — for downstream
            # scripts written against reference-produced CSVs. `both` writes
            # it alongside as *_long.csv; `long` replaces the wide file.
            lat_v, lon_v = masked.lat.values, masked.lon.values
            long_df = pd.DataFrame({
                "time": np.repeat(np.asarray(dates), lat_v.size * lon_v.size),
                "lat": np.tile(np.repeat(lat_v, lon_v.size), len(dates)),
                "lon": np.tile(lon_v, lat_v.size * len(dates)),
                "precip": flat.reshape(-1),
            }).dropna(subset=["precip"])
            long_path = (csv_path if csv_format == "long"
                         else os.path.join(out_dir,
                                           f"fenhe_{name}_{year}_long.csv"))
            long_df.to_csv(long_path, index=False)
        results[name] = arr
        result_dates[name] = dates
        print(f"saved {npy_path} {arr.shape}")

    # post-crop extent report (reference cmorph.py:172-175)
    lon_v, lat_v = masked.lon.values, masked.lat.values
    print(f"[QC] {year}: cropped extent lon {lon_v.min():.2f}~{lon_v.max():.2f},"
          f" lat {lat_v.min():.2f}~{lat_v.max():.2f}")

    if make_plot:
        _comparison_plot(results, out_dir, year)
        _spatial_comparison_plot(results, result_dates,
                                 masked.lon.values, masked.lat.values,
                                 out_dir, year)
    return results


def _comparison_plot(results, out_dir: str, year: int):
    """Basin-mean daily series for both accumulation systems
    (reference cmorph.py:144-176)."""
    import numpy as np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(14, 5))
    for name, arr in results.items():
        series = np.nanmean(arr.reshape(arr.shape[0], -1), axis=1)
        plt.plot(series, label=name, linewidth=1)
    plt.xlabel("day of year")
    plt.ylabel("basin-mean precipitation (mm/day)")
    plt.title(f"CMORPH daily accumulation systems, {year}")
    plt.legend()
    plt.tight_layout()
    path = os.path.join(out_dir, f"accumulation_comparison_{year}.png")
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"saved {path}")


def pick_spatial_sample_day(dates, arrs, year: int):
    """Index of the day to map spatially: the reference's fixed July 10
    (cmorph.py:144-176) when it exists with data; otherwise the wettest
    basin-mean day across the systems (a fixed date on a partial year would
    plot an all-NaN panel)."""
    import numpy as np
    import pandas as pd
    idx = pd.DatetimeIndex(dates)
    target = pd.Timestamp(year=year, month=7, day=10)
    pos = idx.get_indexer([target])
    if pos[0] >= 0 and any(np.isfinite(a[pos[0]]).any() for a in arrs):
        return int(pos[0])
    means = np.nansum([np.where(np.isfinite(a), a, 0.0)
                       .reshape(a.shape[0], -1).mean(1) for a in arrs], axis=0)
    return int(np.argmax(means))


def _spatial_comparison_plot(results, result_dates, lons, lats,
                             out_dir: str, year: int):
    """Side-by-side spatial precipitation maps for one sample date — the
    reference's comparison view (cmorph.py:144-176: one panel per
    accumulation system, Blues, 0..50 mm/day)."""
    import numpy as np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(results)
    first = names[0]
    day = pick_spatial_sample_day(result_dates[first],
                                  [results[n] for n in names], year)
    date_label = str(np.asarray(result_dates[first])[day])[:10]
    fig, axes = plt.subplots(1, len(names), figsize=(7.5 * len(names), 6),
                             squeeze=False)
    extent = [float(lons.min()), float(lons.max()),
              float(lats.min()), float(lats.max())]
    for ax, name in zip(axes[0], names):
        im = ax.imshow(results[name][day], origin="lower", extent=extent,
                       cmap="Blues", vmin=0, vmax=50, aspect="auto")
        ax.set_title(f"{name} ({date_label})")
        ax.set_xlabel("longitude (deg)")
        ax.set_ylabel("latitude (deg)")
        fig.colorbar(im, ax=ax, label="mm/day")
    plt.tight_layout()
    path = os.path.join(out_dir, f"spatial_comparison_{year}.png")
    plt.savefig(path, dpi=150)
    plt.close()
    print(f"saved {path}")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nc-glob", required=True)
    p.add_argument("--shp", required=True)
    p.add_argument("--out-dir", default="data/processed/daily")
    p.add_argument("--start-year", type=int, default=2012)
    p.add_argument("--end-year", type=int, default=2021)
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--csv-format", default="wide",
                   choices=("wide", "long", "both"),
                   help="'long' writes the reference's time/lat/lon/precip "
                        "export shape; 'both' writes it alongside as "
                        "*_long.csv")
    args = p.parse_args()
    if args.end_year > args.start_year and "{year}" not in args.nc_glob:
        raise SystemExit(
            "--nc-glob needs a '{year}' placeholder when processing multiple "
            "years — otherwise every year would re-read the same files under "
            "the wrong year label")
    for year in range(args.start_year, args.end_year + 1):
        glob_y = args.nc_glob.format(year=year)
        process_cmorph_to_fenhe(glob_y, args.shp, args.out_dir, year,
                                make_plot=not args.no_plot,
                                csv_format=args.csv_format)


if __name__ == "__main__":
    main()
