"""Offline ETL and analysis tools (host-side numpy / pandas), copies of the
JAX package's ``tools/``, and the reference checkpoint exchange:
- ``cmorph``             hourly CMORPH NetCDF -> basin-masked daily precipitation npy
- ``dem_lucc_to_npy``    30 m GeoTIFF -> 1 km DEM/LUCC npy grids
- ``merge_multiyear``    concat per-year rain npys; stack per-year LUCC
- ``compare_station``    gauge-vs-satellite per-station metrics CLI
- ``station``            station Excel/CSV reader helpers
- ``import_torch_checkpoint``  the reference Generator's ``.pth`` -> a
                         checkpoint directory of the port's trainer

Each runs as ``python -m pl_convlstm_gan_tpu_torch.tools.<name>``. The geo
stack (xarray, rioxarray, regionmask, geopandas) is imported lazily: these
tools run in an analysis environment, not on the GPU host."""
