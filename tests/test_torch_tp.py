"""Tensor parallelism in the port over ``torch.distributed`` (gloo, CPU):
the channel-sharded ConvLSTM cells on a 2-D (data, model) layout, against
the JAX package's layout helpers, gate math, explicit-collective cell step
(``make_tp_convlstm_step``), TP forecaster and GSPMD train step on a CPU
mesh, and against the port's own one-process steps on the global batch.

This file is also its own worker script, as tests/test_torch_dp.py is:

    python tests/test_torch_tp.py <rank> <world> <port> <work dir>

joins a gloo group through the port's bootstrap (torchrun's variables), cuts
it with ``parallel.mesh.train_group`` at ``mesh.model_axis`` 2 (world 2:
data 1 x model 2; world 4: data 2 x model 2), runs every case that
``setup.pt`` in the work dir lists for its world, with the collectives
counted a step, checks the layout's refusals, and saves what it got to
``w<world>_rank<r>.pt``. The worker imports no JAX. The tests start the
workers of both worlds together, with a free port and a timeout each.

Small size: 2 cells of 8 channels (one case 1 cell), 16 px, float32, global
batch 4, 2 steps; each tolerance is stated where it is used. The CLI under
``python -m torch.distributed.run`` is tested here too.
"""
import ast
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
B = 4                       # the global batch
HIDDEN = (8, 8)
FEATURES = (8, 16)
T_IN, T_OUT, SIZE = 2, 3, 16
STEPS = T_IN + T_OUT - 1
LR, D_LR = 1e-3, 2e-3
LAMBDA_ADV = 0.1
CLIP = 0.5                  # the configs' grad_clip_norm
CLIP_FIRES = 1e-3           # below every gradient norm here: the clip scales
MODEL_AXIS = 2
WORLDS = (2, 4)             # data 1 x model 2, data 2 x model 2
WORKER_TIMEOUT = 180        # seconds a worker (or a torchrun) may take
CELL = dict(b=2, size=8, cx=3, ch=8)


# ------------------------------------------------------------ both sides

def _block(a, index, count):
    """Data replica ``index``'s rows of a global batch array."""
    from pl_convlstm_gan_tpu_torch.data import _process_slice
    return a[_process_slice(np.arange(len(a)), index, count)]


def _counting_all_reduce():
    """Wrap ``torch.distributed.all_reduce`` (which the port calls through
    the module) to count its calls; returns the counter."""
    import torch.distributed as dist
    count = {"all_reduce": 0}
    inner = dist.all_reduce

    def all_reduce(*args, **kwargs):
        count["all_reduce"] += 1
        return inner(*args, **kwargs)
    dist.all_reduce = all_reduce
    return count


def _run_case(case, group, pos, count=None):
    """One case's steps with the port: under ``group`` (``MeshGroups``) on
    this rank's data replica's rows with the cells' shards, from the
    canonical initial state; without one, the one-process steps on the
    global batch. Returns the canonical final state (gathered over the
    model group), this rank's own tensors, the metrics and the collectives
    of each step, and for the NaN case the state after its first step."""
    from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,
                                                  Discriminator)
    from pl_convlstm_gan_tpu_torch.parallel.tensor_parallel import (
        canonical_state_dict, shard_state_dict)
    from pl_convlstm_gan_tpu_torch.train import steps
    from pl_convlstm_gan_tpu_torch.utils.profiling import counters

    fam = case["family"]
    model_group = None if group is None else group.model
    model = ConvLSTMForecaster(case["hidden"], T_IN, T_OUT,
                               tp_group=model_group)
    init = case["init"]["model"]
    model.load_state_dict(init if group is None else shard_state_dict(
        init, pos.model_index, pos.model_count))
    names = [n for n, _ in model.named_parameters()]
    clip = case["clip"]
    if fam.startswith("gan"):
        disc = Discriminator(1, FEATURES)
        disc.load_state_dict(case["init"]["disc"])
        state = steps.GANTrainState(model, disc, steps.make_optimizer(model),
                                    steps.make_optimizer(disc))
        impl = fam.split("_")[1]
        step = lambda st, b, dr: steps.gan_train_step(
            st, b, LR, D_LR, dr, LAMBDA_ADV, impl=impl, grad_clip_norm=clip,
            group=group)
        gen_opt = state.gen_optimizer
    else:
        state = steps.TrainState(model, steps.make_optimizer(model), 0)
        step = lambda st, b, dr: steps.forecaster_train_step(
            st, b, LR, dr, grad_clip_norm=clip, group=group)
        gen_opt = state.optimizer

    def canonical(sd, opt=False):
        if group is None:
            return {k: v.clone() for k, v in sd.items()} if not opt else sd
        return canonical_state_dict(sd, model_group, names if opt else None)

    def snapshot():
        moments = lambda o: {k: {n: v.clone() for n, v in s.items()}
                             for k, s in o["state"].items()}
        out = {"model": canonical(model.state_dict()),
               "opt": moments(canonical(gen_opt.state_dict(), True)),
               "local": {k: v.clone() for k, v in model.state_dict().items()}}
        if fam.startswith("gan"):
            out["disc"] = {k: v.clone()
                           for k, v in state.disc.state_dict().items()}
            out["disc_opt"] = moments(state.disc_optimizer.state_dict())
        return out

    idx, cnt = pos.data_index, pos.data_count
    out = {"metrics": [], "collectives": []}
    for i, batch in enumerate(case["batches"]):
        local = tuple(torch.from_numpy(_block(a, idx, cnt)) for a in batch)
        draws = case["draws"][i]
        if draws is not None:
            draws = torch.from_numpy(_block(draws.T, idx, cnt).T.copy())
        before = counters()
        if count is not None:
            count["all_reduce"] = 0
        out["metrics"].append(step(state, local, draws))
        after = counters()
        out["collectives"].append(dict(
            gather_h=after["gather_h.calls"] - before["gather_h.calls"],
            copy_in=after["copy_in.calls"] - before["copy_in.calls"],
            all_reduce=None if count is None else count["all_reduce"]))
        if fam == "nan_skip" and i == 0:
            out["after_first"] = snapshot()
    out.update(snapshot())
    out["step"] = state.step
    return out


def _cell_step(cell, group, pos):
    """One TP cell step (``ops.convlstm.convlstm_step_tp``) on this rank's
    shards of a canonical weight: the full h' and the local c'."""
    from pl_convlstm_gan_tpu_torch.ops.convlstm import convlstm_step_tp
    from pl_convlstm_gan_tpu_torch.parallel.tensor_parallel import (
        local_shard, shard_cell_params)
    n, r = pos.model_count, pos.model_index
    w, b = (local_shard(t, r, n) for t in shard_cell_params(
        torch.from_numpy(cell["weight"]), torch.from_numpy(cell["bias"]), n))
    per = CELL["ch"] // n
    c = torch.from_numpy(cell["c"])[..., r * per:(r + 1) * per]
    h, c = convlstm_step_tp(torch.from_numpy(cell["x"]),
                            torch.from_numpy(cell["h"]), c, w, b, group.model)
    return {"h": h, "c": c}


def _forward(fwd, group, pos):
    """The TP forecaster's predictions on ``fwd``'s inputs: free-running
    (teacher_forcing_prob 0) and teacher-forced at every step (prob 1)."""
    from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
    from pl_convlstm_gan_tpu_torch.parallel.tensor_parallel import (
        shard_state_dict)
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, tp_group=group.model)
    model.load_state_dict(shard_state_dict(fwd["init"], pos.model_index,
                                           pos.model_count))
    x, y = (torch.from_numpy(a) for a in fwd["batch"])
    with torch.no_grad():
        return {0.0: model(x), 1.0: model(x, y, torch.ones(STEPS, B,
                                                           dtype=torch.bool))}


REMAT_POLICIES = ("", "save_z", "dots")


def _remat_grads(fwd, group, pos):
    """Per remat policy: the TP forecaster's gradients of the L1 loss on
    ``fwd``'s batch with every step under torch.utils.checkpoint (the
    gather recomputed in the backward), gathered canonical."""
    from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
    from pl_convlstm_gan_tpu_torch.parallel.tensor_parallel import (
        canonical_state_dict, shard_state_dict)
    x, y = (torch.from_numpy(a) for a in fwd["batch"])
    out = {}
    for policy in REMAT_POLICIES:
        model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, tp_group=group.model,
                                   remat=True, remat_policy=policy)
        model.load_state_dict(shard_state_dict(
            fwd["init"], pos.model_index, pos.model_count))
        (model(x) - y).abs().mean().backward()
        out[policy] = canonical_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, group.model)
    return out


def _refusals(world, group):
    """What the layout and the TP cell refuse at this world size (the error
    text), and what they take (True)."""
    import torch.distributed as dist

    from pl_convlstm_gan_tpu_torch.config import Config
    from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
    from pl_convlstm_gan_tpu_torch.parallel.mesh import MeshGroups, train_group
    out = {}
    for key, (m, d, bs) in {"model_axis 3": (3, 0, B),
                            "model_axis 4": (4, 0, B),
                            "data_axis 3": (2, 3, B),
                            "data_axis 2": (2, 2, B),
                            "batch 3": (2, 0, 3)}.items():
        cfg = Config()
        cfg.mesh.model_axis, cfg.mesh.data_axis = m, d
        cfg.training.batch_size = bs
        try:
            out[key] = isinstance(train_group(cfg, "cpu"), MeshGroups)
        except ValueError as e:
            out[key] = str(e)
    for key, kw in {"kernel": dict(hidden_dims=HIDDEN, convlstm_impl="kernel"),
                    "width": dict(hidden_dims=(5, 8))}.items():
        try:
            ConvLSTMForecaster(input_frames=T_IN, output_frames=T_OUT,
                               tp_group=group.model, **kw)
            out[key] = True
        except ValueError as e:
            out[key] = str(e)
    out["ranks"] = {"model": dist.get_process_group_ranks(group.model),
                    "data": (None if group.data is None else
                             dist.get_process_group_ranks(group.data))}
    return out


# ---------------------------------------------------------------- worker

def _worker(rank, world, port, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK="0")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pl_convlstm_gan_tpu_torch.config import Config
    from pl_convlstm_gan_tpu_torch.parallel.mesh import (mesh_position,
                                                         train_group)
    cfg = Config()
    cfg.mesh.model_axis = MODEL_AXIS
    cfg.training.batch_size = B
    group = train_group(cfg, "cpu")       # joins the group torchrun names
    pos = mesh_position(MODEL_AXIS)
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    results = {"position": tuple(pos),
               "refusals": _refusals(world, group)}
    count = _counting_all_reduce()
    for name in setup["worlds"][world]:
        results[name] = _run_case(setup["cases"][name], group, pos, count)
    if world == 2:
        results["cell"] = _cell_step(setup["cell"], group, pos)
        results["forward"] = _forward(setup["forward"], group, pos)
        results["remat"] = _remat_grads(setup["forward"], group, pos)
    torch.save(results, os.path.join(work, f"w{world}_rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------- parent

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from pl_convlstm_gan_tpu.config import Config as JaxConfig  # noqa: E402
from pl_convlstm_gan_tpu.data import SyntheticSequenceDataset as JaxSynth  # noqa: E402
from pl_convlstm_gan_tpu.data import batch_iterator as jax_batch_iterator  # noqa: E402
from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster  # noqa: E402
from pl_convlstm_gan_tpu.ops import convlstm as jax_convlstm  # noqa: E402
from pl_convlstm_gan_tpu.parallel import (batch_sharding, make_mesh_2d,  # noqa: E402
                                          tensor_parallel as jax_tp)
from pl_convlstm_gan_tpu.train import steps as jax_steps  # noqa: E402
from pl_convlstm_gan_tpu_torch import cli  # noqa: E402
from pl_convlstm_gan_tpu_torch.config import Config  # noqa: E402
from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,  # noqa: E402
                                              Discriminator)
from pl_convlstm_gan_tpu_torch.ops.convlstm import (convlstm_gates,  # noqa: E402
                                                    convlstm_gates_tp)
from pl_convlstm_gan_tpu_torch.ops.nn import hwio_from_oihw, oihw_from_hwio  # noqa: E402
from pl_convlstm_gan_tpu_torch.parallel import tensor_parallel as port_tp  # noqa: E402
from pl_convlstm_gan_tpu_torch.parallel.mesh import MeshPosition  # noqa: E402
from pl_convlstm_gan_tpu_torch.predict import load_predictor  # noqa: E402
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer  # noqa: E402
from pl_convlstm_gan_tpu_torch.train.steps import make_optimizer  # noqa: E402
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,  # noqa: E402
                                               load_optax_adam_state,
                                               optax_adam_state)
from test_torch_gan import disc_params  # noqa: E402
from test_torch_models import flax_params  # noqa: E402

ONE = MeshPosition(0, 1, 0, 1)
TRAIN_CASES = ("forecaster", "gan_default", "gan_vjp")


def _seq_batches(seed, n):
    ds = JaxSynth(num_sequences=n * B, input_frames=T_IN,
                  output_frames=T_OUT, image_size=SIZE, seed=seed)
    return list(jax_batch_iterator(ds, B))


def _cases():
    """name -> case: the family, the widths, the clip, the initial flax
    params (and the port's state dicts of them), the global batches and the
    teacher draws a step (None, or [STEPS, B] all true: teacher forcing at
    prob 1, which JAX's GSPMD step draws identically)."""
    seq = _seq_batches(6, 2)
    ones = np.ones((STEPS, B), bool)
    gp, dp = flax_params(7, HIDDEN), disc_params(8, FEATURES)
    base = dict(hidden=HIDDEN, clip=CLIP, flax=gp, batches=seq)
    cases = {
        "forecaster": dict(base, family="forecaster", draws=[ones, None],
                           tf=[1.0, 0.0]),
        "gan_default": dict(base, family="gan_default", disc=dp,
                            draws=[None, ones], tf=[0.0, 1.0]),
        "gan_vjp": dict(base, family="gan_vjp", disc=dp, draws=[ones, None],
                        tf=[1.0, 0.0]),
        # the clip fires: its norm must be the whole model's
        "clip": dict(base, family="forecaster", clip=CLIP_FIRES,
                     draws=[ones, None], tf=[1.0, 0.0]),
        # one cell: the gathered h feeds only the head and its own next step
        "head_only": dict(base, family="forecaster", hidden=(8,),
                          flax=flax_params(9, (8,)), draws=[None, ones],
                          tf=[0.0, 1.0]),
    }
    bad = tuple(np.array(a) for a in seq[1])
    bad[0][B - 1, 0, 0, 0, 0] = np.nan       # in data replica 1's rows only
    cases["nan_skip"] = dict(base, family="nan_skip", batches=[seq[0], bad],
                             draws=[None, None], tf=[0.0, 0.0])
    for case in cases.values():
        case["init"] = {"model": flax_to_state_dict(case["flax"])}
        if "disc" in case:
            case["init"]["disc"] = flax_to_state_dict(case["disc"])
    return cases


CASES_BY_WORLD = {2: TRAIN_CASES + ("clip", "head_only", "nan_skip"),
                  4: TRAIN_CASES + ("clip", "nan_skip")}
RUNS = [(w, n) for w in WORLDS for n in CASES_BY_WORLD[w]]


def _cell_setup():
    rng = np.random.default_rng(11)
    b, s, cx, ch = CELL["b"], CELL["size"], CELL["cx"], CELL["ch"]
    arr = lambda *shape: (rng.random(shape, dtype=np.float32) - 0.5)
    return {"weight": oihw_from_hwio(arr(3, 3, cx + ch, 4 * ch) * 0.4).copy(),
            "bias": arr(4 * ch) * 0.2, "x": arr(b, s, s, cx),
            "h": arr(b, s, s, ch), "c": arr(b, s, s, ch)}


def _forward_setup():
    return {"init": flax_to_state_dict(flax_params(12, HIDDEN)),
            "flax": flax_params(12, HIDDEN),
            "batch": tuple(np.asarray(a) for a in _seq_batches(13, 1)[0])}


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
    """The workers' results of both worlds (started together), and the
    setup."""
    work = tmp_path_factory.mktemp("tp")
    setup = {"cases": _cases(), "cell": _cell_setup(),
             "forward": _forward_setup(), "worlds": CASES_BY_WORLD}
    torch.save({"cases": {k: {n: v for n, v in c.items()
                              if n in ("family", "hidden", "clip", "init",
                                       "batches", "draws")}
                          for k, c in setup["cases"].items()},
                "cell": setup["cell"], "worlds": CASES_BY_WORLD,
                "forward": {k: v for k, v in setup["forward"].items()
                            if k != "flax"}}, work / "setup.pt")
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [(world, subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(port),
             str(work)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    logs = []
    for _, p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            pytest.fail("a TP worker did not finish in time")
    for (world, p), log in zip(procs, logs):
        assert p.returncode == 0, (world, log[-3000:])
    got = {w: [torch.load(work / f"w{w}_rank{r}.pt", weights_only=False)
               for r in range(w)] for w in WORLDS}
    return setup, got


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_states_close(got, want, what, tol=1e-5):
    """Canonical params and Adam moments of G (and D), each tensor within
    ``tol`` of its largest magnitude; Adam's counts exactly."""
    for key, opt in (("model", "opt"), ("disc", "disc_opt")):
        if key not in want:
            continue
        for name, p in want[key].items():
            assert _max_rel(got[key][name], p) <= tol, (what, key, name)
        assert got[opt].keys() == want[opt].keys(), what
        for i, st in want[opt].items():
            assert int(got[opt][i]["step"]) == int(st["step"]), what
            for m in ("exp_avg", "exp_avg_sq"):
                assert _max_rel(got[opt][i][m], st[m]) <= tol, (what, i, m)


# ------------------------------------------------ layout and gates vs JAX

@pytest.mark.parametrize("ch,n", [(8, 2), (8, 4), (16, 2)])
def test_layout_helpers_equal_jax(ch, n):
    """pergate_permutation, shard_cell_params / unshard_cell_params and
    tp_permute_state_dict (params and the Adam moments of an optimizer
    state dict) equal JAX's _pergate_permutation, shard/unshard_cell_params
    and tp_permute_tree on the same numpy arrays, exactly (a permutation);
    local_shard takes each rank's contiguous block."""
    np.testing.assert_array_equal(port_tp.pergate_permutation(ch, n),
                                  jax_tp._pergate_permutation(ch, n))
    rng = np.random.default_rng(ch + n)
    kern = rng.random((3, 3, 5 + ch, 4 * ch), dtype=np.float32)
    bias = rng.random(4 * ch, dtype=np.float32)
    want = jax_tp.shard_cell_params(
        jax_convlstm.ConvLSTMParams(jnp.asarray(kern), jnp.asarray(bias)), n)
    w, b = port_tp.shard_cell_params(torch.from_numpy(oihw_from_hwio(kern)),
                                     torch.from_numpy(bias), n)
    np.testing.assert_array_equal(hwio_from_oihw(w.numpy()), want.kernel)
    np.testing.assert_array_equal(b.numpy(), want.bias)
    back = jax_tp.unshard_cell_params(want, n)
    w0, b0 = port_tp.unshard_cell_params(w, b, n)
    np.testing.assert_array_equal(hwio_from_oihw(w0.numpy()), back.kernel)
    np.testing.assert_array_equal(b0.numpy(), bias)
    rows = 4 * ch // n
    for r in range(n):
        assert torch.equal(port_tp.local_shard(w, r, n),
                           w[r * rows:(r + 1) * rows])

    params = flax_params(ch, (ch, ch))
    noise = lambda tree: jax.tree_util.tree_map(
        lambda a: rng.random(a.shape, dtype=np.float32), tree)
    mu, nu = noise(params), noise(params)
    perm = jax_tp.tp_permute_tree({"params": params, "mu": mu, "nu": nu}, n)
    model = ConvLSTMForecaster((ch, ch), T_IN, T_OUT)
    model.load_state_dict(flax_to_state_dict(params))
    opt = make_optimizer(model)
    load_optax_adam_state(opt, model, {"count": 3, "mu": mu, "nu": nu})
    names = [k for k, _ in model.named_parameters()]
    sd = port_tp.tp_permute_state_dict(model.state_dict(), n)
    osd = port_tp.tp_permute_state_dict(opt.state_dict(), n,
                                        param_names=names)
    for key, got in (("params", sd),
                     ("mu", {k: osd["state"][i]["exp_avg"]
                             for i, k in enumerate(names)}),
                     ("nu", {k: osd["state"][i]["exp_avg_sq"]
                             for i, k in enumerate(names)})):
        want = flax_to_state_dict(perm[key])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=f"{key} {k}")
    assert int(osd["state"][0]["step"]) == 3
    back = port_tp.tp_permute_state_dict(sd, n, inverse=True)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_as_groups_reads_a_steps_group_as_mesh_groups():
    """The steps read ``group`` once as MeshGroups: None as no group at
    all, a bare process group as data parallelism over it, MeshGroups as it
    is."""
    from pl_convlstm_gan_tpu_torch.parallel.mesh import MeshGroups, as_groups
    pg, tp = object(), MeshGroups(None, object(), object())
    assert as_groups(None) == MeshGroups(None, None, None)
    assert as_groups(pg) == MeshGroups(pg, None, pg)
    assert as_groups(tp) is tp


def test_layout_refuses_widths_the_shards_do_not_divide():
    """A hidden width n does not divide raises in every helper (a short
    permutation would silently truncate the 4*Ch axis), and an optimizer
    state dict needs the parameters' names."""
    model = ConvLSTMForecaster((6,), T_IN, T_OUT)
    sd = model.state_dict()
    with pytest.raises(ValueError, match="not divisible"):
        port_tp.pergate_permutation(6, 4)
    with pytest.raises(ValueError, match="not divisible"):
        port_tp.tp_permute_state_dict(sd, 4)
    with pytest.raises(ValueError, match="not divisible"):
        port_tp.shard_state_dict(sd, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        port_tp.shard_cell_params(sd["core.cell_0.weight"],
                                  sd["core.cell_0.bias"], 4)
    with pytest.raises(ValueError, match="param_names"):
        port_tp.tp_permute_state_dict(make_optimizer(model).state_dict(), 2)
    assert port_tp.is_cell_param("core.cell_0.weight")
    assert not port_tp.is_cell_param("core.head.weight")


def test_gates_tp_equal_jax_and_canonical():
    """convlstm_gates_tp on the full shard-major z equals JAX's
    convlstm_gates_tp and the canonical gates on the un-permuted z, within
    1e-6 (float32 transcendental functions of two libraries)."""
    rng = np.random.default_rng(3)
    ch, n = 8, 2
    z = rng.standard_normal((2, 4, 4, 4 * ch)).astype(np.float32)
    c = rng.standard_normal((2, 4, 4, ch)).astype(np.float32)
    zp = z[..., port_tp.pergate_permutation(ch, n)]
    h_tp, c_tp = convlstm_gates_tp(torch.from_numpy(zp), torch.from_numpy(c),
                                   n)
    h_j, c_j = jax_convlstm.convlstm_gates_tp(jnp.asarray(zp), jnp.asarray(c),
                                              n)
    h_0, c_0 = convlstm_gates(torch.from_numpy(z), torch.from_numpy(c))
    for got, want in ((h_tp, h_j), (c_tp, c_j), (h_tp, h_0), (c_tp, c_0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


# --------------------------------------------------- TP at world 2 vs JAX

def test_cell_step_matches_jax_explicit_collective_step(run):
    """convlstm_step_tp at world 2 (each rank its shards, its c and the
    full h; one all-gather) equals JAX's make_tp_convlstm_step on a
    2-device CPU mesh from the same canonical params, within 1e-5
    (float32 convs of two libraries); both ranks hold the same full h'."""
    setup, got = run
    cell = setup["cell"]
    mesh = make_mesh_2d(1, MODEL_AXIS, devices=jax.devices()[:MODEL_AXIS])
    params = jax_tp.shard_cell_params(jax_convlstm.ConvLSTMParams(
        jnp.asarray(hwio_from_oihw(cell["weight"])),
        jnp.asarray(cell["bias"])), MODEL_AXIS)
    h_j, c_j = jax_tp.make_tp_convlstm_step(mesh)(
        params, *(jnp.asarray(cell[k]) for k in ("x", "h", "c")))
    ranks = got[2]
    assert torch.equal(ranks[0]["cell"]["h"], ranks[1]["cell"]["h"])
    c = torch.cat([r["cell"]["c"] for r in ranks], dim=-1)
    np.testing.assert_allclose(ranks[0]["cell"]["h"].numpy(), np.asarray(h_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tf", [0.0, 1.0])
def test_forward_matches_one_process_and_jax_tp(run, tf):
    """The TP forecaster at world 2 (data 1 x model 2) from shards of one
    canonical state equals the port's one-process forward and JAX's TP
    forecaster (tp_shards 2 over a 2-device mesh, params by
    tp_permute_tree) within 1e-5, free-running (prob 0) and
    teacher-forced at every step (prob 1); both ranks predict the same."""
    setup, got = run
    fwd = setup["forward"]
    x, y = fwd["batch"]
    ranks = got[2]
    assert torch.equal(ranks[0]["forward"][tf], ranks[1]["forward"][tf])
    one = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    one.load_state_dict(fwd["init"])
    with torch.no_grad():
        want = (one(torch.from_numpy(x)) if tf == 0.0 else
                one(torch.from_numpy(x), torch.from_numpy(y),
                    torch.ones(STEPS, B, dtype=torch.bool)))
    np.testing.assert_allclose(ranks[0]["forward"][tf].numpy(), want.numpy(),
                               atol=1e-5, rtol=0)
    mesh = make_mesh_2d(1, MODEL_AXIS, devices=jax.devices()[:MODEL_AXIS])
    model = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                          output_frames=T_OUT, tp_shards=MODEL_AXIS,
                          tp_mesh=mesh)
    params = jax.device_put(jax_tp.tp_permute_tree(fwd["flax"], MODEL_AXIS),
                            jax_tp.tp_state_shardings(fwd["flax"], mesh))
    kw = {} if tf == 0.0 else dict(targets=jnp.asarray(y),
                                   teacher_forcing_prob=1.0,
                                   rng=jax.random.PRNGKey(0))
    jax_out = jax.jit(lambda p, a: model.apply(p, a, **kw))(
        params, jax.device_put(jnp.asarray(x), batch_sharding(mesh)))
    np.testing.assert_allclose(ranks[0]["forward"][tf].numpy(),
                               np.asarray(jax_out), atol=1e-5, rtol=0)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_under_tp_matches_one_process_gradients(run, policy):
    """Remat under TP (every step under torch.utils.checkpoint, the
    all-gather recomputed in the backward; save_z keeps the local conv's
    z, tagged as on the canonical cell) gives the one-process gradients
    without remat, within 1e-5 of each tensor's largest magnitude, on both
    ranks."""
    setup, got = run
    fwd = setup["forward"]
    one = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    one.load_state_dict(fwd["init"])
    x, y = (torch.from_numpy(a) for a in fwd["batch"])
    (one(x) - y).abs().mean().backward()
    for rank in got[2]:
        for k, p in one.named_parameters():
            assert _max_rel(rank["remat"][policy][k], p.grad) <= 1e-5, k


# ----------------------------------------------------------- train steps

@pytest.mark.parametrize("world,name", RUNS)
def test_tp_steps_equal_the_one_process_steps(run, world, name):
    """The TP run (world 2: data 1 x model 2; world 4: data 2 x model 2)
    against the port's one-process steps on the whole global batch from the
    same state: the canonical params and Adam moments of G (and D) within
    1e-5 of each tensor's largest magnitude, Adam's counts exactly, metrics
    at rtol 1e-5 (float32 sums in other orders). ``clip`` makes the clip
    fire (its norm is the whole model's), ``head_only`` has one cell (the
    gathered h feeds only the head and its own next step)."""
    setup, got = run
    want = _run_case(setup["cases"][name], None, ONE)
    for rank, ranks in enumerate(got[world]):
        res = ranks[name]
        what = f"{name} world {world} rank {rank}"
        assert res["step"] == want["step"] == 2
        for g, w in zip(res["metrics"], want["metrics"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"{what} {k}")
        _assert_states_close(res, want, what)


def _jax_gspmd(case, n_data):
    """JAX's GSPMD forecaster step (make_forecaster_train_step with the TP
    shardings) on a data x model CPU mesh from the case's state: the final
    canonical params, Adam state and metrics."""
    mesh = make_mesh_2d(n_data, MODEL_AXIS,
                        devices=jax.devices()[:n_data * MODEL_AXIS])
    model = JaxForecaster(hidden_dims=case["hidden"], input_frames=T_IN,
                          output_frames=T_OUT, tp_shards=MODEL_AXIS,
                          tp_mesh=mesh)
    tx = jax_steps.make_optimizer(case["clip"])
    params = jax.tree_util.tree_map(
        jnp.array, jax_tp.tp_permute_tree(case["flax"], MODEL_AXIS))
    state = jax_steps.TrainState(params, tx.init(params),
                                 jnp.zeros((), jnp.int32))
    state_sh = jax_tp.tp_state_shardings(state, mesh)
    state = jax.device_put(state, state_sh)
    rep = NamedSharding(mesh, P())
    step = jax_steps.make_forecaster_train_step(
        model.apply, tx, shardings=(state_sh, batch_sharding(mesh), rep))
    metrics = []
    for i, batch in enumerate(case["batches"]):
        gb = tuple(jax.device_put(jnp.asarray(a), batch_sharding(mesh))
                   for a in batch)
        state, m = step(state, gb, jnp.asarray(LR, jnp.float32),
                        jnp.asarray(case["tf"][i], jnp.float32),
                        jax.random.PRNGKey(50 + i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    state = jax.device_get(state)
    return (jax_tp.tp_permute_tree(state.params, MODEL_AXIS, inverse=True),
            jax_tp.tp_permute_tree(state.opt_state, MODEL_AXIS, inverse=True),
            metrics)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_forecaster_steps_match_jax_gspmd_step(run, world):
    """The port's TP forecaster steps against JAX's GSPMD step
    (make_forecaster_train_step(shardings=...), tests/test_tp.py's path) on
    a data x model CPU mesh from the same state and global batches, teacher
    forcing at prob 1 then 0: losses at rtol 1e-5, the canonical params
    within 1e-6 absolute (tests/test_torch_train.py's bound for the port
    against JAX; the head's one-element bias ends near 0, 6e-4, where a
    bound relative to its own magnitude would measure the cancellation),
    the Adam moments within 1e-5 of each tensor's largest magnitude, the
    counts exactly."""
    setup, got = run
    case = setup["cases"]["forecaster"]
    params, opt_state, metrics = _jax_gspmd(case, world // MODEL_AXIS)
    res = got[world][0]["forecaster"]
    for g, w in zip(res["metrics"], metrics):
        np.testing.assert_allclose(g["total"], w["total"], rtol=1e-5)
    want = flax_to_state_dict(params)
    for k, p in res["model"].items():
        assert float((p - want[k]).abs().max()) <= 1e-6, k
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    model.load_state_dict(res["model"])
    opt = make_optimizer(model)
    opt.load_state_dict({"state": res["opt"],
                         "param_groups": opt.state_dict()["param_groups"]})
    adam = optax_adam_state(opt, model)
    assert int(adam["count"]) == int(opt_state[1].count) == 2
    for key in ("mu", "nu"):
        g = flax_to_state_dict(adam[key])
        w = flax_to_state_dict(getattr(opt_state[1], key))
        for k in w:
            assert _max_rel(g[k], w[k]) <= 1e-5, (key, k)


@pytest.mark.parametrize("world,name", RUNS)
def test_replicas_stay_bit_equal(run, world, name):
    """Replicated parameters (the head, D) and their Adam moments are equal
    bit for bit on every rank, the shards on the ranks of one model index
    (the data replicas), and every rank reports the same metrics; the
    canonical states every rank gathered are equal too."""
    _, got = run
    ranks = got[world]
    pos = [r["position"] for r in ranks]
    np.testing.assert_equal([r[name]["metrics"] for r in ranks],
                            [ranks[0][name]["metrics"]] * world)
    for r, res in enumerate(ranks):
        for k, v in res[name]["local"].items():
            if port_tp.is_cell_param(k):
                twin = next(i for i, p in enumerate(pos)
                            if p[2] == pos[r][2])      # same model index
            else:
                twin = 0
            assert torch.equal(v, ranks[twin][name]["local"][k]), (r, k)
        for key in ("model", "disc"):
            for k, v in res[name].get(key, {}).items():
                assert torch.equal(v, ranks[0][name][key][k]), (r, key, k)
        for i, st in res[name].get("disc_opt", {}).items():
            for m, v in st.items():
                assert torch.equal(v, ranks[0][name]["disc_opt"][i][m])


def test_nan_skip_leaves_every_rank_unchanged(run):
    """A non-finite input in data replica 1's rows (world 4) or in the one
    replica's (world 2): every rank skips the update (world 4: the decision
    over the data group), and its state after the step equals its state
    before it bit for bit."""
    _, got = run
    for world in WORLDS:
        for r, res in enumerate(got[world]):
            case = res["nan_skip"]
            assert [m["skipped"] for m in case["metrics"]] == [0, 1]
            before = case["after_first"]
            for key in ("model", "local"):
                for k, v in before[key].items():
                    assert torch.equal(v, case[key][k]), (world, r, key, k)
            for i, st in before["opt"].items():
                for m, v in st.items():
                    assert torch.equal(v, case["opt"][i][m]), (world, r, i)


def _expected_collectives(name, n_cells, data):
    """Per train step: forward all-gathers (one a cell and step; the GAN
    default step runs G twice), backward all-reduces of copy_in (one a cell
    and step, less cell 0 at step 0, whose input needs no gradient), and
    every all_reduce: those, the clip's norm over the model group, the
    replicated gradients over every rank, and with two data replicas the
    finite-loss decision, the shards' gradient mean and the metrics (the
    GAN: D's decision and replicated mean too)."""
    per_pass = n_cells * STEPS
    gathers = per_pass * (2 if name == "gan_default" else 1)
    copies = per_pass - 1
    if name.startswith("gan"):
        d_side = 1 + (data > 1)                 # D's mean (+ decision)
        g_side = copies + 1 + 1 + 2 * (data > 1)
        return gathers, copies, d_side + g_side + (data > 1)
    return gathers, copies, copies + 2 + 3 * (data > 1)


def test_collectives_a_step_are_counted(run):
    """gather_h and copy_in issue one all-gather a cell and step in the
    forward and at most one all-reduce a cell and step in the backward;
    every all_reduce of a step is counted against _expected_collectives."""
    setup, got = run
    for world, name in RUNS:
        n_cells = len(setup["cases"][name]["hidden"])
        gathers, copies, reduces = _expected_collectives(
            name if name != "nan_skip" else "forecaster", n_cells,
            world // MODEL_AXIS)
        for r, res in enumerate(got[world]):
            steps = res[name]["collectives"]
            if name == "nan_skip":          # a skipped step reduces nothing
                steps = steps[:1]
            for c in steps:
                assert (c["gather_h"], c["copy_in"], c["all_reduce"]) == (
                    gathers, copies, reduces), (world, name, r, c)


def test_layout_refusals_and_positions(run):
    """Rank r sits at data index r // 2 and model index r % 2, its model
    group the 2 ranks of its data index, its data group the ranks of its
    model index (none with one replica); train_group refuses a model axis
    that does not divide the world, a data axis other than world / 2 and a
    batch the replicas cannot split; the TP cell refuses the kernel cell
    and a width the model group does not divide, before any launch."""
    _, got = run
    for world in WORLDS:
        for r, res in enumerate(got[world]):
            assert res["position"] == (r // 2, world // 2, r % 2, 2)
            ref = res["refusals"]
            assert ref["ranks"]["model"] == [r - r % 2, r - r % 2 + 1]
            assert ref["ranks"]["data"] == (
                None if world == 2 else [r % 2, r % 2 + 2])
            assert f"does not divide the {world} ranks" in ref["model_axis 3"]
            assert "tensor parallelism requires the plain cell" in ref["kernel"]
            assert "not divisible by the 2 ranks" in ref["width"]
            assert "does not match" in ref["data_axis 3"]
            if world == 2:
                assert "does not divide the 2 ranks" in ref["model_axis 4"]
                assert "does not match" in ref["data_axis 2"]
                assert ref["batch 3"] is True
            else:
                assert ref["model_axis 4"] is True
                assert ref["data_axis 2"] is True
                assert "not divisible by the 2 data replicas" in ref["batch 3"]


def test_config_validation_refuses_what_tp_cannot_run():
    """validate(training=True) takes mesh.model_axis 2 for the sequence
    families and refuses the Generator, convlstm_impl pallas and hidden
    widths model_axis does not divide, as the JAX package's config does."""
    ok = Config.from_dict({"model": {"family": "gan", "hidden_dims": [8]},
                           "mesh": {"model_axis": 2}})
    ok.validate(training=True)
    for model, match in (({"family": "generator"}, "generator"),
                         ({"family": "forecaster", "hidden_dims": [8],
                           "convlstm_impl": "pallas"}, "xla"),
                         ({"family": "forecaster", "hidden_dims": [5, 8]},
                          "divisible")):
        for cls in (Config, JaxConfig):
            cfg = cls.from_dict({"model": model, "mesh": {"model_axis": 2}})
            with pytest.raises(ValueError, match=match):
                cfg.validate()


# -------------------------------------------------------- checkpoints, CLI

def _cli_config(out_dir, epochs, model_axis):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 20,
                 "synthetic_image_size": SIZE},
        "model": {"family": "forecaster", "hidden_dims": list(HIDDEN),
                  "input_frames": T_IN, "output_frames": T_OUT},
        "training": {"batch_size": B, "epochs": epochs, "learning_rate": 1e-3,
                     "use_split": True, "use_early_stopping": False,
                     "scheduled_sampling": True, "sampling_decay_epochs": 4,
                     "eval_thresholds": [0.5]},
        "mesh": {"model_axis": model_axis},
        "output": {"output_dir": str(out_dir), "log_interval": 100,
                   "save_model_interval": 1},
    })


def _torchrun(args, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MODEL_AXIS), "-m",
           "pl_convlstm_gan_tpu_torch", *args, "--device", "cpu"]
    res = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=WORKER_TIMEOUT)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    return res.stdout


def _one_process(cfg, ckpt):
    trainer = SequenceTrainer(config=cfg, device="cpu")
    trainer.setup_data()
    trainer.setup_model()
    trainer.restore(ckpt)
    return trainer


def test_cli_under_torchrun_trains_resumes_and_evaluates(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    pl_convlstm_gan_tpu_torch --device cpu with mesh.model_axis 2 (data 1 x
    model 2, gloo): train 2 epochs; its canonical checkpoint (full-width
    cells) restores into a one-process trainer whose validation equals the
    TP run's last one, and into load_predictor; a one-process run resumes
    it to 3 epochs, and the TP run resumes that to 4 (one-process ->
    TP); --mode eval under TP equals the one-process test metrics of the
    same checkpoint, at rtol 1e-4 (float32 sums over other groupings).
    One writer: one metrics line an epoch, complete checkpoints, rank 0
    alone prints."""
    out = tmp_path / "out"
    paths = {}
    for name, epochs, m in (("tp2", 2, 2), ("one3", 3, 1), ("tp4", 4, 2)):
        paths[name] = str(tmp_path / f"{name}.yaml")
        _cli_config(out, epochs, m).to_yaml(paths[name])
    log = _torchrun(["--config", paths["tp2"], "--mode", "train"], tmp_path)
    assert log.count("DPxTP layout: {'data': 1, 'model': 2} (gloo)") == 1
    assert log.count("Training completed") == 1
    state = torch.load(out / "latest" / "state.pt", weights_only=False)
    assert state["params"]["core.cell_1.weight"].shape == (32, 16, 3, 3)
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1]
    trainer = _one_process(_cli_config(out, 2, 1), str(out / "latest"))
    val = trainer.validate()
    for key in ("l1", "ssim", "csi@0.5"):
        np.testing.assert_allclose(val[key], lines[1][f"val_{key}"],
                                   rtol=1e-4, err_msg=key)
    frames = np.random.default_rng(5).random((2, T_IN, 1, SIZE, SIZE),
                                             dtype=np.float32)
    predict = load_predictor(_cli_config(out, 2, 1), str(out / "latest"),
                             device="cpu")
    with torch.no_grad():
        want = trainer.model(torch.from_numpy(frames))
    np.testing.assert_allclose(predict(frames).numpy(), want.numpy(),
                               atol=1e-6, rtol=0)

    cli.main(["--config", paths["one3"], "--mode", "train", "--resume",
              "--device", "cpu"])
    log = _torchrun(["--config", paths["tp4"], "--mode", "train",
                     "--resume"], tmp_path)
    assert log.count("Resuming from") == 1
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1, 2, 3]
    assert json.loads((out / "history.json").read_text())["epoch"] == [
        0, 1, 2, 3]
    for name in ("best_model", "latest"):
        assert sorted(os.listdir(out / name)) == ["host_state.json",
                                                  "state.pt"]
        assert not (out / f"{name}.pending").exists()
    log = _torchrun(["--config", paths["tp4"], "--mode", "eval",
                     "--checkpoint", str(out / "latest")], tmp_path)
    said = [x for x in log.splitlines() if x.startswith("Test metrics: ")]
    assert len(said) == 1
    tp_test = ast.literal_eval(said[0][len("Test metrics: "):])
    one_test = _one_process(_cli_config(out, 4, 1),
                            str(out / "latest")).evaluate_test()
    for key in ("l1", "ssim", "csi@0.5"):
        np.testing.assert_allclose(tp_test[key], one_test[key], rtol=1e-4,
                                   err_msg=key)
