"""Data parallelism in the port over ``torch.distributed`` (gloo, CPU, world 2)
against the port's single-process step on the global batch and the JAX
package's DP steps (``make_dp_*_train_step``) on a 2-device CPU mesh.

This file is also its own worker script, as tests/mp_dp_worker.py is for
the JAX package:

    python tests/test_torch_dp.py <rank> <world> <port> <work dir>

joins a gloo group through the port's own bootstrap
(``parallel.mesh.maybe_init_distributed`` reading torchrun's variables),
runs every case that ``setup.pt`` in the work dir holds on its block of
each global batch with the port's DP steps, checks ``train_group``'s
refusals and the checkpoint writer at world 2, and saves what it got to
``rank<r>.pt``. The worker imports no JAX. The tests below start two
workers with a free port and a timeout each, then compare.

Small size: one 8-channel cell, 16 px (the Generator 8 -> 16 px), float32,
global batch 4 (2 a rank), a few steps; each tolerance is stated where it
is used. The CLI under ``python -m torch.distributed.run`` and
``load_predictor``'s ``data_parallel`` are tested here too.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
B = 4                       # the global batch: 2 rows a rank
HIDDEN = (8,)
FEATURES = (8, 16)
T_IN, T_OUT, SIZE = 2, 3, 16
STEPS = T_IN + T_OUT - 1
LR, D_LR = 1e-3, 2e-3
LAMBDA_ADV = 0.1
GEN = dict(hidden=(8,), T=3, lr_size=8, scale=2, stations=6, lu=3)
LOSS_CFG = dict(lambda_point=1.0, lambda_conserve=1.0, lambda_smooth=0.1,
                lambda_temporal=0.05, use_weighted_loss=True,
                weight_strategy="log")
WORKER_TIMEOUT = 180        # seconds a worker (or a torchrun) may take


# ------------------------------------------------------------ both sides

def _block(a, rank, world):
    """Rank ``rank``'s rows of a global batch array (the port's
    ``_process_slice`` on the row indices)."""
    from pl_convlstm_gan_tpu_torch.data import _process_slice
    return a[_process_slice(np.arange(len(a)), rank, world)]


def _run_case(case, rank, world, group):
    """Run one case's steps with the port: the DP steps on this rank's block
    under ``group``, the single-process steps on the global batch without
    one. Returns the final state dicts, Adam state dicts, metrics and step,
    and, for the NaN-skip case, the state after its first step."""
    from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,
                                                  Discriminator, Generator)
    from pl_convlstm_gan_tpu_torch.parallel import train_parallel as tp
    from pl_convlstm_gan_tpu_torch.train import steps

    fam = case["family"]
    blk = (lambda a: _block(a, rank, world)) if group else (lambda a: a)
    if fam == "generator":
        model = Generator(hidden_dims=GEN["hidden"], lu_channels=GEN["lu"],
                          scale_factor=GEN["scale"])
    else:
        model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    model.load_state_dict(case["init"]["model"])
    if fam.startswith("gan"):
        disc = Discriminator(1, FEATURES)
        disc.load_state_dict(case["init"]["disc"])
        state = steps.GANTrainState(model, disc, steps.make_optimizer(model),
                                    steps.make_optimizer(disc))
        impl = fam.split("_")[1]
        step = (tp.make_dp_gan_train_step(group, impl, LAMBDA_ADV)
                if group else
                lambda st, b, g, d, dr: steps.gan_train_step(
                    st, b, g, d, dr, LAMBDA_ADV, impl=impl))
    else:
        state = steps.TrainState(model, steps.make_optimizer(model), 0)
        if fam == "generator":
            step = (tp.make_dp_generator_train_step(LOSS_CFG, group)
                    if group else
                    lambda st, b, lr: steps.generator_train_step(
                        st, b, lr, LOSS_CFG))
        else:
            step = (tp.make_dp_forecaster_train_step(group) if group
                    else steps.forecaster_train_step)
    out = {"metrics": []}
    for i, batch in enumerate(case["batches"]):
        local = tuple(torch.from_numpy(blk(a)) for a in batch)
        if fam == "generator":
            m = step(state, local, LR)
        else:
            draws = case["draws"][i]
            if draws is not None:
                draws = torch.from_numpy(blk(draws.T).T.copy())
            lrs = (LR, D_LR) if fam.startswith("gan") else (LR,)
            m = step(state, local, *lrs, draws)
        out["metrics"].append(m)
        if fam == "nan_skip" and i == 0:
            out["after_first"] = _snapshot(state)
    out.update(_snapshot(state))
    out["step"] = state.step
    return out


def _snapshot(state):
    copy = lambda sd: {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in sd.items()}
    opt = lambda o: {k: {n: v.clone() for n, v in s.items()}
                     for k, s in o.state_dict()["state"].items()}
    if hasattr(state, "gen"):
        return {"model": copy(state.gen.state_dict()),
                "disc": copy(state.disc.state_dict()),
                "opt": opt(state.gen_optimizer),
                "disc_opt": opt(state.disc_optimizer)}
    return {"model": copy(state.model.state_dict()),
            "opt": opt(state.optimizer)}


# ---------------------------------------------------------------- worker

def _worker(rank, world, port, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK="0")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pl_convlstm_gan_tpu_torch.config import Config
    from pl_convlstm_gan_tpu_torch.parallel.mesh import (
        maybe_init_distributed, train_group)
    from pl_convlstm_gan_tpu_torch.train.checkpoint import (
        CheckpointWriter, restore_checkpoint)
    from pl_convlstm_gan_tpu_torch.train.steps import sum_over_ranks

    # a trainer's train_group joins the group the variables name, with no
    # maybe_init_distributed before it
    assert not dist.is_initialized()
    cfg = Config()
    cfg.training.batch_size = B
    group = train_group(cfg, "cpu").data
    results = {"joined": (group is dist.group.WORLD, dist.get_backend(),
                          dist.get_world_size()),
               "train_group": tuple(None if g is None else
                                    g is dist.group.WORLD
                                    for g in train_group(cfg, "cpu"))}
    assert maybe_init_distributed(device="cpu")
    cases = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    results.update({name: _run_case(case, rank, world, group)
                    for name, case in cases.items()})

    # eval sums above float32's exact integers (2^24): counts stay int64
    results["eval_sums"] = sum_over_ranks(
        {"counts@1": (torch.tensor([2**24 + 1 + rank, 3, 2**40 + rank, 0]),
                      torch.tensor(2.0)),
         "l1": (torch.tensor(1.5 + rank), torch.tensor(2.0))}, group)

    refusals = {}
    for axis, batch in ((0, B), (world, B), (1, B), (3, B), (0, B + 1)):
        cfg = Config()
        cfg.mesh.data_axis, cfg.training.batch_size = axis, batch
        try:
            refusals[f"{axis}/{batch}"] = train_group(cfg).data is group
        except ValueError as e:
            refusals[f"{axis}/{batch}"] = str(e)
    results["refusals"] = refusals

    # every rank saves to one path; rank 0 alone writes it
    ckpt = os.path.join(work, "ckpt")
    writer = CheckpointWriter()
    writer.save(ckpt, {"params": {"w": torch.full((2,), float(rank))},
                       "step": rank}, {"epoch": rank})
    writer.wait()
    results["restored"] = restore_checkpoint(ckpt)[1]
    torch.save(results, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------- parent

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pl_convlstm_gan_tpu.data import batch_iterator as jax_batch_iterator  # noqa: E402
from pl_convlstm_gan_tpu.data import eval_batches as jax_eval_batches  # noqa: E402
from pl_convlstm_gan_tpu.data import SyntheticSequenceDataset as JaxSynth  # noqa: E402
from pl_convlstm_gan_tpu.data import SyntheticDownscalingDataset as JaxDown  # noqa: E402
from pl_convlstm_gan_tpu.data.pipeline import _process_slice as jax_slice  # noqa: E402
from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster  # noqa: E402
from pl_convlstm_gan_tpu.models import Discriminator as JaxDiscriminator  # noqa: E402
from pl_convlstm_gan_tpu.models import Generator as JaxGenerator  # noqa: E402
from pl_convlstm_gan_tpu.parallel import make_mesh, replicate, shard_batch  # noqa: E402
from pl_convlstm_gan_tpu.parallel import train_parallel as jax_tp  # noqa: E402
from pl_convlstm_gan_tpu.train import steps as jax_steps  # noqa: E402
from pl_convlstm_gan_tpu_torch import cli, data as port_data  # noqa: E402
from pl_convlstm_gan_tpu_torch.config import Config  # noqa: E402
from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,  # noqa: E402
                                              Discriminator, Generator)
from pl_convlstm_gan_tpu_torch.predict import load_predictor  # noqa: E402
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer  # noqa: E402
from pl_convlstm_gan_tpu_torch.train.steps import make_optimizer  # noqa: E402
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,  # noqa: E402
                                               optax_adam_state)
from test_torch_gan import disc_params  # noqa: E402
from test_torch_models import flax_params  # noqa: E402

DP_CASES = ("forecaster", "generator", "gan_default", "gan_vjp")


def _seq_batches(seed, n):
    ds = JaxSynth(num_sequences=n * B, input_frames=T_IN,
                  output_frames=T_OUT, image_size=SIZE, seed=seed)
    return list(jax_batch_iterator(ds, B))


def _gen_setup():
    """The JAX Generator's init params and two global batches whose station
    observations hold other NaN patterns in each rank's block: rank 0's
    rows keep one station, rank 1's rows all of them but one time step."""
    ds = JaxDown(num_days=3 * B + GEN["T"], T=GEN["T"],
                 lr_size=GEN["lr_size"], scale_factor=GEN["scale"],
                 num_stations=GEN["stations"], num_lu_classes=GEN["lu"],
                 seed=5)
    batches = []
    for batch in list(jax_batch_iterator(ds, B))[:2]:
        sv = np.array(batch[4])                     # [B, T, N]
        sv[:B // 2, :, 1:] = np.nan
        sv[B // 2:, 0] = np.nan
        batches.append(tuple(batch[:4]) + (sv,))
    model = JaxGenerator(hidden_dims=GEN["hidden"], lu_channels=GEN["lu"],
                         scale_factor=GEN["scale"])
    params = model.init(jax.random.PRNGKey(4),
                        *map(jnp.asarray, batches[0][:3]))
    return model, jax.device_get(params), batches


def _cases():
    """name -> case: the family, the initial flax params (and the port's
    state dicts of them), the global batches, the teacher draws a step
    (None, or [STEPS, B] all true: teacher forcing at prob 1, which JAX
    draws identically on every shard) and JAX's tf_prob a step."""
    seq = _seq_batches(6, 2)
    ones = np.ones((STEPS, B), bool)
    gp, dp = flax_params(7, HIDDEN), disc_params(8, FEATURES)
    gen_model, gen_params, gen_batches = _gen_setup()
    cases = {
        "forecaster": dict(family="forecaster", flax=gp, batches=seq,
                           draws=[ones, None], tf=[1.0, 0.0]),
        "generator": dict(family="generator", flax=gen_params,
                          batches=gen_batches, draws=[None, None],
                          tf=[0.0, 0.0], jax_model=gen_model),
        "gan_default": dict(family="gan_default", flax=gp, disc=dp,
                            batches=seq, draws=[None, ones], tf=[0.0, 1.0]),
        "gan_vjp": dict(family="gan_vjp", flax=gp, disc=dp, batches=seq,
                        draws=[ones, None], tf=[1.0, 0.0]),
    }
    bad = tuple(np.array(a) for a in seq[1])
    bad[0][B - 1, 0, 0, 0, 0] = np.nan            # in rank 1's block only
    cases["nan_skip"] = dict(family="nan_skip", flax=gp,
                             batches=[seq[0], bad], draws=[None, None],
                             tf=[0.0, 0.0])
    for case in cases.values():
        case["init"] = {"model": flax_to_state_dict(case["flax"])}
        if "disc" in case:
            case["init"]["disc"] = flax_to_state_dict(case["disc"])
    return cases


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both workers' results on the cases, and the cases."""
    work = tmp_path_factory.mktemp("dp")
    cases = _cases()
    torch.save({k: {n: v for n, v in c.items()
                    if n in ("family", "init", "batches", "draws")}
                for k, c in cases.items()}, work / "setup.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port), str(work)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a DP worker did not finish in time")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return cases, got, work


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_state(res, family):
    """The port modules and optimizers holding a run's final state."""
    if family == "generator":
        model = Generator(hidden_dims=GEN["hidden"], lu_channels=GEN["lu"],
                          scale_factor=GEN["scale"])
    else:
        model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    model.load_state_dict(res["model"])
    out = [(model, _optimizer(model, res["opt"]))]
    if "disc" in res:
        disc = Discriminator(1, FEATURES)
        disc.load_state_dict(res["disc"])
        out.append((disc, _optimizer(disc, res["disc_opt"])))
    return out


def _optimizer(model, state):
    opt = make_optimizer(model)
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    return opt


def _assert_states_close(got, want, what, tol=1e-5):
    """Params and Adam moments of each module, each tensor within ``tol``
    of its largest magnitude; Adam's counts exactly."""
    for (m_g, o_g), (m_w, o_w) in zip(_port_state(got, got["family"]),
                                      _port_state(want, want["family"])):
        for name, p in m_w.state_dict().items():
            assert _max_rel(m_g.state_dict()[name], p) <= tol, (what, name)
        a_g, a_w = optax_adam_state(o_g, m_g), optax_adam_state(o_w, m_w)
        assert int(a_g["count"]) == int(a_w["count"]), what
        for key in ("mu", "nu"):
            g, w = flax_to_state_dict(a_g[key]), flax_to_state_dict(a_w[key])
            for name in w:
                assert _max_rel(g[name], w[name]) <= tol, (what, key, name)


def _assert_metrics_close(got, want, what, rtol=1e-5):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), what
        for k in w:
            np.testing.assert_allclose(g[k], float(w[k]), rtol=rtol,
                                       atol=1e-7, err_msg=f"{what} {i} {k}")


@pytest.mark.parametrize("name", DP_CASES + ("nan_skip",))
def test_dp_replicas_stay_bit_equal(run, name):
    """Both ranks end with the same params and Adam state, bit for bit (each
    applies the same averaged gradients), the same metrics (the global
    batch's) and the same step count."""
    _, got, _ = run
    a, b = got[0][name], got[1][name]
    assert a["step"] == b["step"] == 2
    np.testing.assert_equal(a["metrics"], b["metrics"])   # NaN == NaN
    for key in ("model", "disc"):
        for n in a.get(key, {}):
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    for key in ("opt", "disc_opt"):
        for k, s in a.get(key, {}).items():
            for n, v in s.items():
                assert torch.equal(v, b[key][k][n]), (key, k, n)


@pytest.mark.parametrize("name", DP_CASES)
def test_dp_step_equals_the_single_process_step(run, name):
    """The DP run at world 2 against the port's single-process steps on the
    whole global batch from the same state: params and Adam moments within
    1e-5 of each tensor's largest magnitude, metrics at rtol 1e-5 (float32:
    the mean of two half-batch gradients against one whole-batch sum). The
    Generator's point term and RMSE use the global station counts, which
    differ between the two blocks here."""
    cases, got, _ = run
    case = dict(cases[name])
    want = _run_case(case, 0, 1, None)
    want["family"] = got[0][name]["family"] = case["family"]
    _assert_metrics_close(got[0][name]["metrics"], want["metrics"], name)
    _assert_states_close(got[0][name], want, name)


def _jax_dp(case):
    """JAX's DP steps over a 2-device mesh of the CPU's devices from the
    case's state: (final state, metrics)."""
    mesh = make_mesh(WORLD)
    fam = case["family"]
    tx = jax_steps.make_optimizer(0.5)
    if fam == "generator":
        model = case["jax_model"]
        step = jax_tp.make_dp_generator_train_step(model.apply, tx, LOSS_CFG,
                                                   mesh)
    else:
        model = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                              output_frames=T_OUT)
    params = case["flax"]
    if fam.startswith("gan"):
        disc = JaxDiscriminator(features=FEATURES)
        dtx = jax_steps.make_optimizer(0.5)
        state = jax_steps.GANTrainState(
            params, case["disc"], tx.init(params), dtx.init(case["disc"]),
            jnp.zeros((), jnp.int32))
        step = jax_tp.make_dp_gan_train_step(
            model.apply, disc.apply, tx, dtx, mesh, LAMBDA_ADV, 1.0,
            impl=fam.split("_")[1])
    else:
        state = jax_steps.TrainState(params, tx.init(params),
                                     jnp.zeros((), jnp.int32))
        if fam != "generator":
            step = jax_tp.make_dp_forecaster_train_step(model.apply, tx, mesh)
    state = replicate(state, mesh)
    metrics = []
    for i, batch in enumerate(case["batches"]):
        gb = shard_batch(tuple(map(jnp.asarray, batch)), mesh)
        lr = jnp.asarray(LR, jnp.float32)
        extra = (jnp.asarray(case["tf"][i], jnp.float32),
                 jax.random.PRNGKey(50 + i))
        if fam == "generator":
            state, m = step(state, gb, lr)
        elif fam.startswith("gan"):
            state, m = step(state, gb, lr, jnp.asarray(D_LR, jnp.float32),
                            *extra)
        else:
            state, m = step(state, gb, lr, *extra)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return jax.device_get(state), metrics


@pytest.mark.parametrize("name", DP_CASES)
def test_dp_step_matches_jax_dp_step(run, name):
    """The port's DP run at world 2 against JAX's make_dp_*_train_step on a
    2-device CPU mesh (shard_map, pmean) from the same state and global
    batches (teacher forcing at prob 0 or 1, where JAX's fold_in draws do
    not matter): metrics at rtol 1e-5; params and Adam moments within 1e-5
    of each tensor's largest magnitude, the counts exactly (float32, sums
    in other orders)."""
    cases, got, _ = run
    case = cases[name]
    state, metrics = _jax_dp(case)
    res = got[0][name]
    _assert_metrics_close(res["metrics"], metrics, name)
    pairs = [("model", "opt", state.params if hasattr(state, "params")
              else state.gen_params,
              state.opt_state if hasattr(state, "opt_state")
              else state.gen_opt_state)]
    if hasattr(state, "disc_params"):
        pairs.append(("disc", "disc_opt", state.disc_params,
                      state.disc_opt_state))
    for (m, o), (_, _, params, opt_state) in zip(
            _port_state(dict(res, family=case["family"]), case["family"]),
            pairs):
        want = flax_to_state_dict(params)
        for n, p in m.state_dict().items():
            assert _max_rel(p, want[n]) <= 1e-5, (name, n)
        adam = optax_adam_state(o, m)
        assert int(adam["count"]) == int(opt_state[1].count) == 2
        for key in ("mu", "nu"):
            g = flax_to_state_dict(adam[key])
            w = flax_to_state_dict(getattr(opt_state[1], key))
            for n in w:
                assert _max_rel(g[n], w[n]) <= 1e-5, (name, key, n)


def test_global_nan_skip_leaves_every_rank_unchanged(run):
    """A non-finite input in rank 1's block only: the global decision skips
    the update on both ranks; each rank's params and Adam state after the
    step equal its state before it bit for bit (and the two ranks equal
    each other: test_dp_replicas_stay_bit_equal), and both report
    skipped 1."""
    _, got, _ = run
    for r in range(WORLD):
        res = got[r]["nan_skip"]
        assert [m["skipped"] for m in res["metrics"]] == [0, 1]
        before = res["after_first"]
        for n, v in before["model"].items():
            assert torch.equal(v, res["model"][n]), (r, n)
        for k, s in before["opt"].items():
            for n, v in s.items():
                assert torch.equal(v, res["opt"][k][n]), (r, k, n)


def test_data_group_refusals_and_one_checkpoint_writer(run):
    """At world 2, train_group takes mesh.data_axis 0 and 2 and refuses 1 and
    3 (a rank cannot sit out the collectives) and a global batch of 5; both
    ranks saved to one path, rank 0 alone wrote it (its epoch, 0, is what
    both ranks restore), and no pending directory is left."""
    _, got, work = run
    for r in range(WORLD):
        ref = got[r]["refusals"]
        assert ref[f"0/{B}"] is True and ref[f"{WORLD}/{B}"] is True
        assert "does not match the 2 ranks" in ref[f"1/{B}"]
        assert "does not match the 2 ranks" in ref[f"3/{B}"]
        assert "not divisible by the 2 ranks" in ref[f"0/{B + 1}"]
        assert got[r]["restored"] == {"epoch": 0}
    assert sorted(os.listdir(work / "ckpt")) == ["host_state.json",
                                                 "state.pt"]
    assert not (work / "ckpt.pending").exists()


def test_data_group_joins_the_group_the_environment_names(run):
    """Each worker had torchrun's variables set and called no
    maybe_init_distributed: train_group (a trainer's first call) joined the
    world-2 gloo group itself and returned it as its data group, so a
    trainer built under torchrun without the CLI trains data-parallel, never
    as one of two independent full-batch runs."""
    _, got, _ = run
    for r in range(WORLD):
        assert got[r]["joined"] == (True, "gloo", WORLD)


def test_train_group_of_data_parallelism_is_world_none_world(run):
    """A trainer's steps take train_group's MeshGroups: data parallelism
    alone is (the world, no model group, the world), so the one step body
    averages every gradient over the world, as the data group did."""
    _, got, _ = run
    for r in range(WORLD):
        assert got[r]["train_group"] == (True, None, True)


def test_eval_sums_over_ranks_keep_int64_counts_exact(run):
    """sum_over_ranks on contingency counts above 2^24 (float32's last
    exact integer; a 16-rank dp_v5e16 batch counts ~3e7 correct
    negatives): the int64 counts are summed as int64, exactly, and the
    float sums as float32."""
    _, got, _ = run
    for r in range(WORLD):
        counts, nv = got[r]["eval_sums"]["counts@1"]
        assert counts.dtype == torch.int64
        assert counts.tolist() == [2**25 + 3, 6, 2**41 + 1, 0]
        assert float(nv) == 4.0
        l1, w = got[r]["eval_sums"]["l1"]
        assert l1.dtype == torch.float32 and float(l1) == 4.0
        assert float(w) == 4.0


def test_batch_and_eval_slices_equal_jax():
    """The port's _process_slice, batch_iterator and eval_batches with
    process_index / process_count give each process the block JAX's give it
    (shuffled and not, 13 items in global batches of 4 and 6, 2 and 3
    processes): the same items in the same order, the same number of
    batches on every process and the same global n_valid."""
    ds = JaxSynth(num_sequences=13, input_frames=1, output_frames=1,
                  image_size=4, seed=2)
    idx = np.arange(12)
    for pc in (2, 3):
        for pi in range(pc):
            np.testing.assert_array_equal(
                port_data._process_slice(idx, pi, pc),
                jax_slice(idx, pi, pc))
            for bs, shuffle in ((4, True), (6, False)):
                if bs % pc:
                    continue
                kw = dict(process_index=pi, process_count=pc)
                got = list(port_data.batch_iterator(ds, bs, shuffle, seed=3,
                                                    epoch=1, **kw))
                want = list(jax_batch_iterator(ds, bs, shuffle, seed=3,
                                               epoch=1, **kw))
                assert len(got) == len(want) == 13 // bs
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(a, b)
                got = list(port_data.eval_batches(ds, bs, **kw))
                want = list(jax_eval_batches(ds, bs, **kw))
                assert len(got) == len(want)
                for (g, nv_g), (w, nv_w) in zip(got, want):
                    assert nv_g == nv_w
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        port_data._process_slice(np.arange(5), 0, 2)


def _cli_config(out_dir, epochs):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 20,
                 "synthetic_image_size": 16},
        "model": {"family": "forecaster", "hidden_dims": [8],
                  "input_frames": 2, "output_frames": 3},
        "training": {"batch_size": 4, "epochs": epochs, "learning_rate": 1e-3,
                     "use_split": True, "use_early_stopping": False,
                     "scheduled_sampling": True, "sampling_decay_epochs": 4,
                     "eval_thresholds": [0.5]},
        "output": {"output_dir": str(out_dir), "log_interval": 100,
                   "save_model_interval": 1},
    })


def _torchrun(args, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), "-m", "pl_convlstm_gan_tpu_torch",
           *args, "--device", "cpu"]
    res = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=WORKER_TIMEOUT)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    return res.stdout


def test_cli_under_torchrun_trains_resumes_and_evaluates(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    pl_convlstm_gan_tpu_torch --device cpu (gloo): train 2 epochs (with
    scheduled sampling: the global draws, each rank its columns), --resume
    to 3 (it starts at epoch 2), then --mode eval at world 1 in this
    process on the world-2 checkpoint. One writer: metrics.jsonl holds one
    line an epoch, rank 0 alone prints; the checkpoints are complete. The
    world-2 run's last validation (3 sequences in one wrap-padded batch of
    4, split 2 + 2 over the ranks: rank 1 holds one valid row) equals the
    validation of its checkpoint at world 1, at rtol 1e-5 (float32 sums
    over other groupings)."""
    out = tmp_path / "out"
    two = tmp_path / "two.yaml"
    three = tmp_path / "three.yaml"
    _cli_config(out, 2).to_yaml(str(two))
    _cli_config(out, 3).to_yaml(str(three))
    log = _torchrun(["--config", str(two), "--mode", "train"], tmp_path)
    assert log.count("Data parallelism over 2 ranks (gloo)") == 1
    assert log.count("Training completed") == 1
    log = _torchrun(["--config", str(three), "--mode", "train", "--resume"],
                    tmp_path)
    assert log.count("Resuming from") == 1
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1, 2]
    history = json.loads((out / "history.json").read_text())
    assert history["epoch"] == [0, 1, 2]
    for name in ("best_model", "latest"):
        assert sorted(os.listdir(out / name)) == ["host_state.json",
                                                  "state.pt"]
        assert not (out / f"{name}.pending").exists()
    metrics = cli.main(["--config", str(three), "--mode", "eval", "--device",
                        "cpu"])
    assert np.isfinite(metrics["l1"]) and np.isfinite(metrics["ssim"])
    cfg = _cli_config(out, 3)
    cfg.training.resume_from = str(out / "latest")
    trainer = SequenceTrainer(config=cfg, device="cpu")
    trainer.setup_data()
    trainer.setup_model()
    val = trainer.validate()
    for key in ("l1", "ssim", "csi@0.5"):
        np.testing.assert_allclose(val[key], lines[2][f"val_{key}"],
                                   rtol=1e-5, err_msg=key)


def test_predictor_data_parallel(tmp_path):
    """load_predictor's data_parallel: 'require' raises on one device (the
    CPU); over two CPU replicas the split path equals the unsplit predictor
    on each half of the batch bit for bit, and on the whole batch at
    atol=rtol=1e-6 (float32 convs over a batch of 4 against two of 2);
    'auto' runs a batch that does not split on the first replica, as the
    unsplit predictor does, and 'require' raises on it; an unknown value is
    refused."""
    cfg = _cli_config(tmp_path, 1)
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    model.load_state_dict(flax_to_state_dict(flax_params(9, HIDDEN)))
    ckpt = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), ckpt)
    frames = np.random.default_rng(10).random((B, T_IN, 1, SIZE, SIZE),
                                              dtype=np.float32)
    with pytest.raises(ValueError, match="more than one device"):
        load_predictor(cfg, ckpt, device="cpu", data_parallel="require")
    with pytest.raises(ValueError, match="auto|off|require"):
        load_predictor(cfg, ckpt, device="cpu", data_parallel="on")
    one = load_predictor(cfg, ckpt, device="cpu", data_parallel="off",
                         devices=["cpu", "cpu"])
    two = load_predictor(cfg, ckpt, device="cpu", data_parallel="require",
                         devices=["cpu", "cpu"])
    split = two(frames)
    assert torch.equal(split, torch.cat([one(frames[:2]), one(frames[2:])]))
    np.testing.assert_allclose(split.numpy(), one(frames).numpy(), atol=1e-6,
                               rtol=1e-6)
    auto = load_predictor(cfg, ckpt, device="cpu", devices=["cpu", "cpu"])
    assert torch.equal(auto(frames[:3]), one(frames[:3]))
    with pytest.raises(ValueError, match="not divisible"):
        two(frames[:3])
