"""The training comparison starts each compared step from the program's own
state: a difference that entered at an earlier step (here: signs of
small Adam updates flipped after step 0, as bf16 rounding flips them) does
not reach the later steps' losses and gradients, where a comparison of
two trajectories from one start would carry it on."""
import torch

from bench_cuda import checks, data
from bench_cuda.drivers import train
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import train as ref_train
from bench_cuda.tests import tiny

F32 = ref_convlstm.rounding("f32")


def _setup():
    c = tiny.cell("nowcast_128_bf16.train")
    cfg, mix = c.config, c.mix
    weights = data.weights(tiny.SEED, train.param_shapes(cfg), "cpu")
    return cfg, mix, weights, train.make_pool(cfg, mix, tiny.SEED, "cpu")


def _step(cfg, mix, state, batch):
    t = cfg["training"]
    return ref_train.train_step(cfg["family"], cfg["model"], {}, state,
                                batch, t["learning_rate"],
                                t["grad_clip_norm"], F32)


def _snap(state):
    return {"params": state.params, "exp_avg": state.exp_avg,
            "exp_avg_sq": state.exp_avg_sq, "step": state.step}


def test_earlier_divergence_does_not_reach_later_steps():
    cfg, mix, weights, pool = _setup()
    lr = cfg["training"]["learning_rate"]
    g = torch.Generator().manual_seed(0)
    state = ref_train.TrainState.fresh(weights)
    snaps, losses = [], []
    for k in range(3):
        snaps.append(_snap(state))
        loss, _, state = _step(cfg, mix, state, pool[k])
        losses.append(loss)
        if k == 0:      # flip a tenth of step 0's updates
            params = {}
            for name, p in state.params.items():
                flip = torch.rand(p.shape, generator=g) < 0.1
                move = p - snaps[0]["params"][name]
                params[name] = torch.where(flip, p - 2 * move, p)
            state = ref_train.TrainState(params, state.exp_avg,
                                         state.exp_avg_sq, state.step)
    snaps.append(_snap(state))
    refs = train.reference_steps(cfg, mix, snaps, pool, F32)
    got = checks.train_readings(snaps, losses, refs)
    assert got["loss_rel_gap"] < 1e-6 and got["grad_diff_gap"] < 1e-5

    # the same program held against one trajectory from the start
    ref_state = ref_train.TrainState.fresh(weights)
    drift = []
    for k in range(3):
        loss, _, ref_state = _step(cfg, mix, ref_state, pool[k])
        drift.append(abs(loss - losses[k]) / abs(loss))
    assert max(drift[1:]) > 100 * max(got["loss_rel_gap"], 1e-9)


def test_a_wrong_step_is_still_seen():
    """A step whose update is wrong in itself (twice the move) fails the
    change of the parameters."""
    cfg, mix, weights, pool = _setup()
    state = ref_train.TrainState.fresh(weights)
    snaps, losses = [], []
    for k in range(3):
        snaps.append(_snap(state))
        loss, _, new = _step(cfg, mix, state, pool[k])
        params = {n: 2 * new.params[n] - state.params[n] for n in new.params}
        state = ref_train.TrainState(params, new.exp_avg, new.exp_avg_sq,
                                     new.step)
        losses.append(loss)
    snaps.append(_snap(state))
    refs = train.reference_steps(cfg, mix, snaps, pool, F32)
    got = checks.train_readings(snaps, losses, refs)
    assert got["change_median_gap"] > 0.5
