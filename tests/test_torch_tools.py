"""The port's offline tools (``pl_convlstm_gan_tpu_torch/tools/``) against the
JAX package's, on the CPU.

Every case of ``tests/test_tools.py`` (its fakes of the geo stack
included) runs again with the JAX tools' modules replaced by the port's
copies: the case's own assertions then hold the port's tools, and every
tool function the case calls also runs the JAX function on a deep copy of
the same arguments, whose result (or error) must be equal: arrays, frames
and plain values exactly, NaN where NaN. The JAX-only cases (its flax
round trip and its import probe) are replaced by the ``.pth`` exchange
below and by ``tests/test_torch_isolation.py``'s walk over ``tools.*``."""
import copy
import functools
import importlib
import inspect
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import test_tools
from pl_convlstm_gan_tpu.tools.import_torch_checkpoint import \
    export_state_dict
from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.predict import build_model, load_state_dict
from pl_convlstm_gan_tpu_torch.tools import import_torch_checkpoint as itc
from pl_convlstm_gan_tpu_torch.weights import (load_reference_pth,
                                               reference_state_dict,
                                               state_dict_to_flax)

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("cmorph", "compare_station", "dem_lucc_to_npy", "merge_multiyear",
         "station")
JAX_ONLY = ("test_torch_checkpoint_roundtrip",
            "test_etl_tools_import_without_jax")
CASES = sorted(name for name, fn in vars(test_tools).items()
               if name.startswith("test_") and callable(fn)
               and name not in JAX_ONLY)


def _same(a, b, where="result"):
    """a (the port's) equals b (JAX's): exactly, NaN where NaN."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True)
    elif isinstance(a, pd.Index):
        pd.testing.assert_index_equal(a, b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        _same(vars(a), vars(b), where)
    else:
        assert a == b, (where, a, b)


def _both(port_fn, jax_fn):
    """port_fn, which also runs jax_fn on a deep copy of its arguments
    (first, so that files both write end as the port's) and holds the two
    results, or the two errors, equal."""
    @functools.wraps(port_fn)
    def run(*args, **kwargs):
        jargs, jkwargs = copy.deepcopy((args, kwargs))
        try:
            ref, ref_err = jax_fn(*jargs, **jkwargs), None
        except Exception as e:   # compared with the port's error below
            ref, ref_err = None, e
        try:
            out = port_fn(*args, **kwargs)
        except Exception as e:
            assert ref_err is not None, \
                f"{port_fn.__name__}: only the port raised {e!r}"
            assert (type(e), str(e)) == (type(ref_err), str(ref_err))
            raise
        assert ref_err is None, \
            f"{port_fn.__name__}: only JAX's raised {ref_err!r}"
        _same(out, ref, port_fn.__name__)
        return out
    return run


def _dual_module(name):
    """The port's tools.<name>, its functions run beside JAX's."""
    port = importlib.import_module(f"pl_convlstm_gan_tpu_torch.tools.{name}")
    jax = importlib.import_module(f"pl_convlstm_gan_tpu.tools.{name}")
    dual = types.ModuleType(port.__name__)
    for attr, value in vars(port).items():
        if inspect.isfunction(value) and value.__module__ == port.__name__:
            value = _both(value, getattr(jax, attr))
        setattr(dual, attr, value)
    return dual


@pytest.mark.parametrize("case", CASES)
def test_jax_tool_case_on_the_port(case, tmp_path, monkeypatch):
    duals = {name: _dual_module(name) for name in TOOLS}
    for name, dual in duals.items():
        monkeypatch.setitem(sys.modules, f"pl_convlstm_gan_tpu.tools.{name}",
                            dual)
    # the names tests/test_tools.py imported at its top
    for attr, value in list(vars(test_tools).items()):
        module = getattr(value, "__module__", "") or ""
        if inspect.isfunction(value) and \
                module.startswith("pl_convlstm_gan_tpu.tools."):
            dual = duals[module.rsplit(".", 1)[1]]
            monkeypatch.setattr(test_tools, attr, getattr(dual, attr))
    fn = getattr(test_tools, case)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


def test_tools_use_the_ports_own_helpers():
    """The tools read the port's data helpers, not the JAX package's."""
    from pl_convlstm_gan_tpu_torch import data
    from pl_convlstm_gan_tpu_torch.tools import cmorph, station
    assert cmorph.days_in_year is data.days_in_year
    assert station._read_table is data._read_table
    assert set(CASES) >= {
        "test_compare_systems_end_to_end",
        "test_process_cmorph_glue_sorts_transposes_and_crops"}


@pytest.fixture(scope="module")
def generator_state():
    """A port Generator's state_dict (configs/ci_smoke.yaml, 5 LUCC
    classes), from a seed."""
    cfg = load_config("ci_smoke")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model(cfg, lu_channels=5)
    return model.state_dict()


def test_reference_pth_round_trip(tmp_path, generator_state):
    """reference_state_dict is the reference's names over the port's
    tensors, equal to JAX's export_state_dict of the same weights;
    load_reference_pth of the .pth it makes (a bundle with
    model_state_dict, or the bare state_dict) gives the port's state_dict
    back, so reference_state_dict after load_reference_pth is the identity;
    a state_dict that is not the Generator's is refused."""
    ref = reference_state_dict(generator_state)
    assert "cell1.conv.weight" in ref and "upsample_blocks.0.conv.bias" in ref
    assert "post_process.2.weight" in ref and "lu_attn.conv.0.weight" in ref
    jax_ref = export_state_dict(state_dict_to_flax(generator_state))
    assert ref.keys() == jax_ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k].numpy(), jax_ref[k])
    for i, obj in enumerate(({"model_state_dict": ref, "epoch": 3}, ref)):
        path = tmp_path / f"best_model_{i}.pth"
        torch.save(obj, path)
        back = load_reference_pth(str(path))
        assert back.keys() == generator_state.keys()
        for k in back:
            assert torch.equal(back[k], generator_state[k])
        again = reference_state_dict(back)
        assert again.keys() == ref.keys()
        assert all(torch.equal(again[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="not a parameter of the Generator"):
        reference_state_dict({"core.cell_0.weight": torch.zeros(1)})


def test_import_tool_main_and_module_entry(tmp_path, generator_state):
    """main() writes a checkpoint directory of the port's trainer whose
    params are the .pth's weights (what --checkpoint and load_predictor
    read); `python -m pl_convlstm_gan_tpu_torch.tools.<name> --help` runs for
    every tool."""
    pth = tmp_path / "best_model.pth"
    torch.save({"model_state_dict": reference_state_dict(generator_state)},
               pth)
    itc.main(["--pth", str(pth), "--out", str(tmp_path / "converted")])
    loaded = load_state_dict(str(tmp_path / "converted"))
    assert loaded.keys() == generator_state.keys()
    assert all(torch.equal(loaded[k], generator_state[k]) for k in loaded)
    for name in TOOLS[:-1] + ("import_torch_checkpoint",):
        res = subprocess.run(
            [sys.executable, "-m", f"pl_convlstm_gan_tpu_torch.tools.{name}",
             "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and "usage" in res.stdout, (name,
                                                               res.stderr)
