"""The port imports nothing of JAX, flax, optax, orbax, the JAX package or
the repository's ``experiments/`` scripts, and its optional packages
(grain, matplotlib, pandas, the geo stack) only inside the functions that
need them.

A subprocess blocks the first group (``sys.modules[name] = None`` makes any
``import name`` raise), then imports every module of the port and the
module-level code of chip_smoke.py, and reports what got loaded of either
group. grain and matplotlib are not blocked: importing a module of the port
must simply not load them (grain imports JAX where it can)."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pl_convlstm_gan_tpu_torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pl_convlstm_gan_tpu",
           "experiments")
LAZY = ("grain", "matplotlib", "pandas", "xarray", "rioxarray", "regionmask",
        "geopandas", "rasterio")

_PROBE = """
import importlib, json, runpy, sys
for name in {blocked!r}:
    sys.modules[name] = None
for mod in {modules!r}:
    importlib.import_module(mod)
runpy.run_path({chip_smoke!r}, run_name="chip_smoke_module_level")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and
                m.split(".")[0] in {blocked!r} + {lazy!r})
print(json.dumps(loaded))
"""


def _port_modules():
    mods = [pl_convlstm_gan_tpu_torch.__name__]
    for info in pkgutil.walk_packages(pl_convlstm_gan_tpu_torch.__path__,
                                      prefix="pl_convlstm_gan_tpu_torch."):
        if not info.name.endswith("__main__"):   # runs the CLI when imported
            mods.append(info.name)
    return mods


def test_port_and_chip_smoke_import_no_jax():
    modules = _port_modules()
    assert "pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel" in modules
    assert "pl_convlstm_gan_tpu_torch.cli" in modules
    assert "pl_convlstm_gan_tpu_torch.streaming" in modules
    for mod in ("train.sequence_trainer", "train.steps", "train.checkpoint",
                "losses", "data", "models.discriminator",
                "ops.kernels.tap_structure_kernel", "experiments.tap_structure",
                "models.generator", "train.trainer", "ops.resize",
                "ops.coords", "ops.pixel_shuffle", "parallel.mesh",
                "parallel.train_parallel", "parallel.tensor_parallel",
                "parallel.tp_collectives", "utils.profiling",
                "utils.visualization", "ops.quant", "models.quantized",
                "tools.cmorph", "tools.compare_station",
                "tools.dem_lucc_to_npy", "tools.merge_multiyear",
                "tools.station", "tools.import_torch_checkpoint"):
        assert f"pl_convlstm_gan_tpu_torch.{mod}" in modules
    code = _PROBE.format(blocked=BLOCKED, lazy=LAZY, modules=modules,
                         chip_smoke=str(REPO / "chip_smoke.py"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


_LAYERING = """
import json, sys
from pl_convlstm_gan_tpu_torch.utils import profiling
profiling.counters()
profiling.add_counts({})
profiling.compiled_cost(lambda: 0)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[:2] in [
    ["pl_convlstm_gan_tpu_torch", layer]
    for layer in ("ops", "models", "parallel", "train")])))
"""


def test_profiling_loads_no_layer_above_it():
    """``utils/profiling`` sits at the bottom of the package: its counters,
    ``add_counts`` and ``compiled_cost`` load no module of ``ops``,
    ``models``, ``parallel`` or ``train`` (the modules that count declare
    their counters in it, not the other way round)."""
    res = subprocess.run([sys.executable, "-c", _LAYERING], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
