"""Static-feature ETL: 30 m GeoTIFF -> 1 km npy grids.

Port of the reference (``src/scripts/dem_lucc_to_npy.py:5-141``):
dask-chunked rioxarray load; DEM cleaned with ``where(< 9000)`` then 33x33
coarsen-MEAN; LUCC cleaned (255 -> 0) then coarsen-MAX (dominant-ish class without a
mode pass); saves the grid npy plus lon/lat coordinate vectors. DEM converted once,
LUCC per year.

Requires rioxarray + dask (lazy imports).
Usage: python -m pl_convlstm_gan_tpu_torch.tools.dem_lucc_to_npy --dem dem_30m.tif \
           --lucc 'lucc_{year}_30m.tif' --out-dir data/processed/static_features_1km
"""
from __future__ import annotations

import argparse
import os


def _trim(arr, factor: int):
    """boundary='trim' coarsen prep: crop to multiples of `factor`, reshape to
    (H', f, W', f) blocks (xarray coarsen semantics on a 2-D array)."""
    h, w = arr.shape
    hh, ww = (h // factor) * factor, (w // factor) * factor
    return arr[:hh, :ww].reshape(hh // factor, factor, ww // factor, factor)


def coarsen_dem(arr, factor: int = 33):
    """DEM 30m -> 1km: invalid cells (>= 9000, e.g. nodata) set to 0, then
    block MEAN with boundary-trim — exactly the reference math
    (``dem_lucc_to_npy.py:24-27,46-47``: ``where(< 9000, 0)`` replaces with
    ZERO, which participates in the mean — not a NaN-skip)."""
    import numpy as np
    a = np.where(np.asarray(arr, np.float64) < 9000, arr, 0.0)
    out = _trim(a, factor).mean(axis=(1, 3)).astype(np.float32)
    out[out > 9000] = 0  # reference's post-coarsen final cleanup (:46-47)
    return out


def coarsen_lucc(arr, factor: int = 33):
    """LUCC 30m -> 1km: nodata (255) -> 0, then block MAX with boundary-trim
    (reference ``dem_lucc_to_npy.py:36-39,53-55``)."""
    import numpy as np
    a = np.asarray(arr)
    a = np.where(a == 255, 0, a)
    out = _trim(a, factor).max(axis=(1, 3))
    out = np.where(out == 255, 0, out)  # reference's final cleanup (:53-55)
    return out.astype(np.int32)


def coarsen_coords(vec, factor: int = 33):
    """Coordinate vector for a trim-coarsened axis: block means of the source
    coordinates (xarray coarsen coordinate handling)."""
    import numpy as np
    v = np.asarray(vec, np.float64)
    n = (len(v) // factor) * factor
    return v[:n].reshape(-1, factor).mean(axis=1)


def convert_tif_to_npy(tif_path: str, out_prefix: str, kind: str,
                       coarsen: int = 33):
    """kind: 'dem' (>=9000 -> 0, coarsen-mean) or 'lucc' (255 -> 0, coarsen-max).

    The raster stays dask-chunked through cleanup + coarsen (a 30m regional
    GeoTIFF can be tens of GB dense — only the 1km result is materialized);
    the xarray expressions mirror the pure-numpy coarsen_* cores above, which
    pin the block math in tests (geo deps absent there)."""
    import numpy as np
    import rioxarray

    da = rioxarray.open_rasterio(tif_path, chunks={"x": 4096, "y": 4096}).squeeze()
    if kind == "dem":
        cleaned = da.where(da < 9000, 0)        # zeros participate in the mean
        coarse = cleaned.coarsen(x=coarsen, y=coarsen, boundary="trim").mean()
        arr = np.asarray(coarse.values, np.float32)
        arr[arr > 9000] = 0                     # reference final cleanup
    elif kind == "lucc":
        cleaned = da.where(da != 255, 0)
        coarse = cleaned.coarsen(x=coarsen, y=coarsen, boundary="trim").max()
        arr = np.asarray(coarse.values)
        arr = np.where(arr == 255, 0, arr).astype(np.int32)
    else:
        raise ValueError(kind)

    np.save(out_prefix + ".npy", arr)
    np.save(out_prefix + "_lon.npy", coarsen_coords(da.x.values, coarsen))
    np.save(out_prefix + "_lat.npy", coarsen_coords(da.y.values, coarsen))
    print(f"saved {out_prefix}.npy {arr.shape}")
    return arr


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dem", help="30m DEM GeoTIFF path")
    p.add_argument("--lucc", help="30m LUCC GeoTIFF path template with {year}")
    p.add_argument("--out-dir", default="data/processed/static_features_1km")
    p.add_argument("--start-year", type=int, default=2012)
    p.add_argument("--end-year", type=int, default=2021)
    p.add_argument("--coarsen", type=int, default=33)
    args = p.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.dem:
        convert_tif_to_npy(args.dem, os.path.join(args.out_dir, "dem_1km"),
                           "dem", args.coarsen)
    if args.lucc:
        for year in range(args.start_year, args.end_year + 1):
            convert_tif_to_npy(args.lucc.format(year=year),
                               os.path.join(args.out_dir, f"lucc_1km_{year}"),
                               "lucc", args.coarsen)


if __name__ == "__main__":
    main()
