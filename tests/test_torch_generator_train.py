"""The port's Generator training pieces against the JAX package, on the CPU:
the four-term combined loss and each of its terms, the train step (params,
Adam moments, metrics, the NaN-skip), the eval step and its exact
aggregation, the synthetic downscaling data, the splits and the Fenhe
dataset.

Both packages start from one state: the JAX Generator's ``init`` params and
optax Adam state, carried into the port by ``weights.py``. Inputs are made
with numpy from seeds. Each tolerance is stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu import data as jax_data
from pl_convlstm_gan_tpu.losses import combined as jax_loss
from pl_convlstm_gan_tpu.models import Generator as JaxGenerator
from pl_convlstm_gan_tpu.train import steps as jax_steps
from pl_convlstm_gan_tpu_torch import data as port_data
from pl_convlstm_gan_tpu_torch import losses
from pl_convlstm_gan_tpu_torch.models import Generator
from pl_convlstm_gan_tpu_torch.train.steps import (
    TrainState, aggregate_generator_eval, generator_eval_step,
    generator_train_step, make_optimizer)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               load_optax_adam_state,
                                               optax_adam_state)
from test_data import _write_shapefile

HIDDEN = (8, 8)
B, T, LR, SCALE = 2, 3, 8, 2
LOSS_CFG = dict(lambda_point=1.0, lambda_conserve=1.0, lambda_smooth=0.1,
                lambda_temporal=0.05, use_weighted_loss=True,
                weight_strategy="log")


def _loss_inputs(seed, b=3, t=3, h=12, w=10, n=6):
    """pred [B,T,1,H,W] up to 60 (every stratified band), LR input at half
    size, stations [N,2] with two outside the HR grid once scaled (a
    negative row, a column past the edge), observations with NaNs."""
    rng = np.random.default_rng(seed)
    pred = rng.random((b, t, 1, h, w), dtype=np.float32) * 60.0
    lr = rng.random((b, t, 1, h // 2, w // 2), dtype=np.float32) * 60.0
    coords = np.stack([rng.integers(0, h // 2, n),
                       rng.integers(0, w // 2, n)], 1).astype(np.int64)
    coords[0] = (-1, 0)
    coords[1] = (1, w // 2 + 3)
    values = rng.random((b, t, n), dtype=np.float32) * 60.0
    values[0, 1, 2] = np.nan
    values[2, :, 3] = np.nan
    return pred, lr, coords, values


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


@pytest.mark.parametrize("weighted,strategy", [
    (True, "log"), (True, "stratified"), (True, "sqrt"), (False, "log")])
@pytest.mark.parametrize("masked", [False, True])
def test_combined_loss_and_terms_match_jax(weighted, strategy, masked):
    """Every term, the total and the sum forms, float32: rtol 1e-6 (the
    same reductions in other orders). NaN observations and stations outside
    the grid are masked; ``batch_mask`` drops a row."""
    pred, lr, coords, values = _loss_inputs(20)
    j, t = _jt(pred, lr, coords, values)
    mask = np.array([True, False, True])
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    args = (SCALE, 1.0, 0.7, 0.1, 0.05, weighted, strategy)
    want, want_parts = jax_loss.combined_loss(*j, *args, batch_mask=jm)
    got, parts = losses.combined_loss(*t, *args, batch_mask=tm)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-6,
        atol=1e-7)
    close(got, want)
    for k in want_parts:
        close(parts[k], want_parts[k])
    for fn, extra in (("point_supervision_sums", (weighted, strategy)),
                      ("station_sq_err_sums", ())):
        jw = getattr(jax_loss, fn)(j[0], j[2], j[3], SCALE, *extra,
                                   batch_mask=jm)
        tg = getattr(losses, fn)(t[0], t[2], t[3], SCALE, *extra,
                                 batch_mask=tm)
        for a, b in zip(tg, jw):
            close(a, b)
    close(losses.station_rmse(t[0], t[2], t[3], SCALE, tm),
          jax_loss.station_rmse(j[0], j[2], j[3], SCALE, jm))
    close(losses.compute_sample_weights(t[3].nan_to_num(), weighted, strategy),
          jax_loss.compute_sample_weights(jnp.nan_to_num(j[3]), weighted,
                                          strategy))


def test_station_pixels_truncate_toward_zero():
    """(c + 0.5) * s - 0.5 truncated toward zero, as torch's .long() and
    JAX's astype: coord 0 at scale 0.25 gives -0.375 -> 0 (kept), -1 at
    scale 2 gives -1.5 -> -1 (masked); equal to JAX's indices."""
    coords = np.array([[0, 0], [-1, 2], [3, 7], [5, 1]], np.int64)
    for scale in (0.25, 2.0, 1.5):
        want = jax_loss._station_pixel_indices(jnp.asarray(coords), scale, 8,
                                               8)
        got = losses._station_pixel_indices(torch.from_numpy(coords), scale,
                                            8, 8)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows, _, valid = losses._station_pixel_indices(
        torch.from_numpy(coords), 0.25, 8, 8)
    assert bool(valid[0]) and int(rows[0]) == 0
    assert not bool(losses._station_pixel_indices(
        torch.from_numpy(coords), 2.0, 8, 8)[2][1])


def test_station_batches_of_either_layout_and_no_valid_entry():
    """coords [B,N,2] take item 0 and values [T,N] broadcast over B, as in
    JAX; with every observation NaN the point loss and RMSE are 0."""
    pred, _, coords, values = _loss_inputs(21)
    j, t = _jt(pred, np.broadcast_to(coords, (3,) + coords.shape).copy(),
               values[0])
    np.testing.assert_allclose(
        float(losses.point_supervision_loss(*t, SCALE)),
        float(jax_loss.point_supervision_loss(*j, SCALE)), rtol=1e-6)
    nan = torch.full_like(t[2], float("nan"))
    assert float(losses.point_supervision_loss(t[0], t[1], nan, SCALE)) == 0
    assert float(losses.station_rmse(t[0], t[1], nan, SCALE)) == 0


# ------------------------------------------------------------------ steps

def _dataset(seed=0, days=24):
    kw = dict(num_days=days, T=T, lr_size=LR, scale_factor=SCALE,
              num_stations=6, num_lu_classes=3, seed=seed)
    return jax_data.SyntheticDownscalingDataset(**kw), \
        port_data.SyntheticDownscalingDataset(**kw)


def _batches(ds, n, b=B):
    return [tuple(np.stack(a) for a in zip(*(ds[i * b + j] for j in range(b))))
            for i in range(n)]


def _states(impl="torch", clip=0.5):
    jds, _ = _dataset()
    jm = JaxGenerator(hidden_dims=HIDDEN, lu_channels=3, scale_factor=SCALE)
    batch = _batches(jds, 1)[0]
    params = jm.init(jax.random.PRNGKey(3), *map(jnp.asarray, batch[:3]))
    tx = jax_steps.make_optimizer(clip)
    state_j = jax_steps.TrainState(params, tx.init(params),
                                   jnp.zeros((), jnp.int32))
    pm = Generator(hidden_dims=HIDDEN, lu_channels=3, scale_factor=SCALE,
                   convlstm_impl=impl)
    pm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    opt = make_optimizer(pm)
    load_optax_adam_state(opt, pm, jax.device_get(state_j.opt_state))
    step_j = jax_steps.make_generator_train_step(jm.apply, tx, LOSS_CFG)
    return jm, step_j, state_j, TrainState(pm, opt, 0)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_train_steps_match_jax(impl):
    """Two steps from one state (clip 0.5 scales both: the global norm here
    is ~1e2): the metrics (rtol 1e-5), then the params and the Adam moments
    after each step, 1e-5 of each tensor's largest magnitude (float32; the
    same forward, sums in other orders). impl 'kernel' runs K1's plain
    version with the custom backward on CPU tensors."""
    _, step_j, state_j, state_p = _states(impl)
    _, pds = _dataset()
    batches = _batches(pds, 2)
    lr = 5e-4
    for i, batch in enumerate(batches):
        state_j, m_j = step_j(state_j, tuple(map(jnp.asarray, batch)),
                              jnp.asarray(lr, jnp.float32))
        m_p = generator_train_step(state_p, tuple(map(torch.from_numpy,
                                                      batch)), lr, LOSS_CFG)
        assert m_p["skipped"] == int(m_j["skipped"]) == 0
        assert set(m_p) == set(m_j)
        for k in m_p:
            np.testing.assert_allclose(m_p[k], float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        want = flax_to_state_dict(jax.device_get(state_j.params))
        adam_j = jax.device_get(state_j.opt_state)[1]
        mu, nu = flax_to_state_dict(adam_j.mu), flax_to_state_dict(adam_j.nu)
        got = optax_adam_state(state_p.optimizer, state_p.model)
        assert int(got["count"]) == int(adam_j.count) == i + 1
        mu_p, nu_p = flax_to_state_dict(got["mu"]), flax_to_state_dict(
            got["nu"])
        for name, p in state_p.model.named_parameters():
            assert _max_rel(p.detach().numpy(), want[name].numpy()) <= 1e-5, \
                (i, name)
            assert _max_rel(mu_p[name].numpy(), mu[name].numpy()) <= 1e-5
            assert _max_rel(nu_p[name].numpy(), nu[name].numpy()) <= 1e-5
    assert state_p.step == int(state_j.step) == 2


def test_nan_batch_keeps_params_and_adam_state():
    """A batch whose loss is NaN skips the update: params and Adam's state
    (its step included) unchanged, the state's step count advanced, as in
    JAX (whose skipped counter is 1 on the same batch)."""
    _, step_j, state_j, state_p = _states()
    _, pds = _dataset()
    good, bad = _batches(pds, 2)
    generator_train_step(state_p, tuple(map(torch.from_numpy, good)), 5e-4,
                         LOSS_CFG)
    bad = (np.full_like(bad[0], np.nan),) + bad[1:]
    before = {k: v.clone() for k, v in state_p.model.state_dict().items()}
    adam = {k: {n: t.clone() for n, t in v.items()}
            for k, v in state_p.optimizer.state_dict()["state"].items()}
    m = generator_train_step(state_p, tuple(map(torch.from_numpy, bad)), 5e-4,
                             LOSS_CFG)
    assert m["skipped"] == 1 and not np.isfinite(m["total"])
    assert state_p.step == 2
    for k, v in state_p.model.state_dict().items():
        assert torch.equal(v, before[k])
    for k, v in state_p.optimizer.state_dict()["state"].items():
        for n, t in v.items():
            assert torch.equal(t, adam[k][n])
    _, m_j = step_j(state_j, tuple(map(jnp.asarray, bad)),
                    jnp.asarray(5e-4, jnp.float32))
    assert int(m_j["skipped"]) == 1


def test_eval_sums_and_aggregation_match_jax():
    """Eval over wrap-padded batches (n_valid 1 of 2 in the last): every
    (sum, weight) pair, rtol 1e-5, and the aggregate (loss, rmse, parts)
    equals JAX's, rtol 1e-5; the padded row carries no weight."""
    jm, _, state_j, state_p = _states()
    jds, pds = _dataset()
    sub_j = jax_data.Subset(jds, [0, 3, 5])
    sub_p = port_data.Subset(pds, [0, 3, 5])
    eval_j = jax_steps.make_generator_eval_step(jm.apply, LOSS_CFG)
    acc_j, acc_p = [], []
    for (batch, n_valid) in port_data.eval_batches(sub_p, B):
        acc_p.append(generator_eval_step(
            state_p.model, tuple(map(torch.from_numpy, batch)), n_valid,
            LOSS_CFG))
    for (batch, n_valid) in jax_data.eval_batches(sub_j, B):
        acc_j.append(eval_j(state_j.params, tuple(map(jnp.asarray, batch)),
                            jnp.asarray(n_valid, jnp.int32)))
    assert len(acc_p) == len(acc_j) == 2
    for a, b in zip(acc_p, acc_j):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(
                [float(a[k][0]), float(a[k][1])],
                [float(b[k][0]), float(b[k][1])], rtol=1e-5, err_msg=k)
    assert float(acc_p[1]["conserve"][1]) == 1.0
    got = aggregate_generator_eval(acc_p, LOSS_CFG)
    want = jax_steps.aggregate_generator_eval(acc_j, LOSS_CFG)
    assert set(got) == set(want) == {"loss", "rmse", "point", "conserve",
                                     "smooth", "temporal"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert aggregate_generator_eval([], LOSS_CFG) is None


# ------------------------------------------------------------------- data

def test_synthetic_downscaling_dataset_is_bit_identical():
    """The same seed gives the same arrays, bit for bit, and dtypes; the
    class count and length agree."""
    for kw in (dict(num_days=40, T=5, lr_size=16, scale_factor=8,
                    num_stations=16, seed=0),
               dict(num_days=12, T=3, lr_size=6, scale_factor=3,
                    num_stations=4, num_lu_classes=2, seed=7)):
        j = jax_data.SyntheticDownscalingDataset(**kw)
        p = port_data.SyntheticDownscalingDataset(**kw)
        assert len(p) == len(j) and p.num_lu_classes == j.num_lu_classes
        for i in (0, len(j) - 1):
            for a, b in zip(p[i], j[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_splits_equal_jax():
    """split_dataset_random (seeded) and year_indices /
    split_dataset_by_year (leap years, each year's last T windows dropped)
    give JAX's indices."""
    jds, pds = _dataset(days=40)
    for a, b in zip(port_data.split_dataset_random(pds, seed=42),
                    jax_data.split_dataset_random(jds, seed=42)):
        assert a.indices == b.indices
    jds.start_year, jds.end_year = 2011, 2013
    pds.start_year, pds.end_year = 2011, 2013
    for years in ((2011, 2011), (2012, 2013), (2013, 2013)):
        assert port_data.year_indices(pds, *years) == \
            jax_data.year_indices(jds, *years)
    for a, b in zip(port_data.split_dataset_by_year(
            pds, (2011, 2011), (2012, 2012), (2013, 2013)),
            jax_data.split_dataset_by_year(
            jds, (2011, 2011), (2012, 2012), (2013, 2013))):
        assert a.indices == b.indices
    assert [port_data.days_in_year(y) for y in (1900, 2000, 2012, 2013)] == \
        [365, 366, 366, 365]


def _fenhe_files(tmp_path, multiyear):
    """Tiny Fenhe fixture files (two years, csv station tables with an
    out-of-bounds station and a negative value), as tests/test_data.py
    writes them."""
    import pandas as pd
    rng = np.random.default_rng(0)
    years = (2012, 2013)
    days = sum(port_data.days_in_year(y) for y in years)
    np.save(tmp_path / "rain.npy", rng.random((days, 6, 5)).astype(np.float32))
    np.save(tmp_path / "dem.npy", rng.random((12, 10)).astype(np.float32) * 2e3)
    lucc = rng.integers(1, 4, (2, 12, 10) if multiyear else (12, 10))
    np.save(tmp_path / "lucc.npy", lucc)
    _write_shapefile(str(tmp_path / "basin.shp"))
    pd.DataFrame({"station_id": [1001, 1002, 9999],
                  "lon": [111.0, 112.5, 150.0],
                  "lat": [36.0, 38.0, 36.0]}).to_csv(tmp_path / "meta.csv",
                                                     index=False)
    dates = [(y, 1 + d // 31, 1 + d % 31) for y in years
             for d in range(port_data.days_in_year(y))]
    rain = pd.DataFrame({"year": [d[0] for d in dates],
                         "month": [d[1] for d in dates],
                         "day": [d[2] for d in dates],
                         "1001": rng.random(days).astype(np.float32) * 10,
                         "1002": rng.random(days).astype(np.float32) * 10})
    rain.iloc[5, rain.columns.get_loc("1001")] = -3.0
    rain.iloc[6, rain.columns.get_loc("1001")] = -1.0
    rain.to_csv(tmp_path / "rain_stations.csv", index=False)
    return dict(rain_lr_path=str(tmp_path / "rain.npy"),
                dem_path=str(tmp_path / "dem.npy"),
                lucc_path=str(tmp_path / "lucc.npy"),
                rain_meta_path=str(tmp_path / "meta.csv"),
                rain_station_path=str(tmp_path / "rain_stations.csv"),
                shp_path=str(tmp_path / "basin.shp"), T=5, start_year=2012,
                end_year=2013)


@pytest.mark.parametrize("multiyear", [True, False])
def test_fenhe_dataset_equals_jax(tmp_path, multiyear):
    """The port's FenheDataset on the same files: the same stations (the
    out-of-bounds one skipped), repaired series, class count and items, bit
    for bit; the multi-year LUCC picks the window's middle day's year."""
    kw = _fenhe_files(tmp_path, multiyear)
    p, j = port_data.FenheDataset(**kw), jax_data.FenheDataset(**kw)
    assert len(p) == len(j) == 366 + 365 - 5
    assert p.num_lu_classes == j.num_lu_classes
    np.testing.assert_array_equal(p.s_coords, j.s_coords)
    np.testing.assert_array_equal(p.s_values, j.s_values)
    assert p.s_coords.shape == (2, 2) and (p.s_values >= 0).all()
    for i in (0, 362, len(p) - 1):
        for a, b in zip(p[i], j[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if multiyear:
        np.testing.assert_array_equal(p[400][2], p.lucc_onehot_list[1])
    assert port_data.read_shapefile_extent(kw["shp_path"]) == \
        jax_data.read_shapefile_extent(kw["shp_path"])


def test_fenhe_helpers_equal_jax():
    lucc = np.array([[0, 1, 3], [3, 5, 0]])
    np.testing.assert_array_equal(port_data.lucc_to_onehot(lucc),
                                  jax_data.lucc_to_onehot(lucc))
    for s, sm in (([1.0, -5.0, 3.0, 4.0], [9.0] * 4),
                  ([-1.0, -1.0, -1.0], [9.0, 8.0, 7.0]),
                  ([-1.0], [np.nan])):
        s, sm = np.array(s, np.float32), np.array(sm, np.float32)
        np.testing.assert_array_equal(
            port_data.repair_negative_values(s, sm),
            jax_data.repair_negative_values(s, sm))
