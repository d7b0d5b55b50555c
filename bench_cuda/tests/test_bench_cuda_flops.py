"""The benchmark's frozen operation and byte counts against the program's
repository: ``rollout_bound_ms`` against ``chip_smoke.rollout_bound_ms``,
and a train step's count against ``utils.profiling.compiled_cost`` at a
small shape (which counts only the gradients a step needs: the first
cell's input gradient at step 0 of the forecaster, and the Generator's
stem and covariate convs, have none)."""
import pytest

from bench_cuda import data, flops
from bench_cuda.drivers import train
from bench_cuda.tests import tiny


@pytest.mark.parametrize("args", [
    (1, 128, 128, 1, (64, 64, 64), 30, 30, 0),
    (1, 128, 128, 1, (64, 64, 64), 1, 1, 1),
    (4, 128, 128, 1, (64, 64, 64), 24, 20, 5),
    (8, 256, 256, 1, (64, 64), 30, 30, 0),
    (2, 32, 32, 3, (16, 32), 4, 2, 3),
])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_rollout_bound_matches_chip_smoke(args, dtype_name):
    chip_smoke = pytest.importorskip("chip_smoke")
    assert flops.rollout_bound_ms(*args, dtype_name=dtype_name) == \
        chip_smoke.rollout_bound_ms(*args, dtype_name=dtype_name)


def test_stream_request_count():
    model = {"image_size": 128, "in_channels": 1, "hidden_dims": [64] * 3}
    ops, bound = flops.stream_request(model, 30)
    assert ops == flops.rollout_flops(1, 128, 128, 1, [64] * 3, 31, 31)
    assert bound == pytest.approx(0.736 + 0.0245, abs=2e-3)


@pytest.mark.parametrize("name", ["nowcast_128_bf16.train",
                                  "generator_default.train"])
def test_train_step_count_against_compiled_cost(name):
    from pl_convlstm_gan_tpu_torch.utils.profiling import compiled_cost
    c = tiny.cell(name)
    cfg, m = c.config, c.config["model"]
    b = cfg["training"]["batch_size"]
    _, step = train.build(cfg, data.weights(1, train.param_shapes(cfg),
                                            "cpu"), "cpu")
    pool = train.make_pool(cfg, c.mix, 1, "cpu")
    counted = compiled_cost(step, pool[0])["flops"]
    if cfg["family"] == "forecaster":
        px = b * m["image_size"] ** 2
        needless = flops.conv_flops(px, 3, m["in_channels"]
                                    + m["hidden_dims"][0],
                                    4 * m["hidden_dims"][0])
    else:
        lo, hi = m["image_size"] ** 2, (m["image_size"] * 8) ** 2
        half = m["hidden_dims"][-1] // 2
        needless = (flops.conv_flops(m["T"] * b * lo, 3, 3,
                                     m["hidden_dims"][0])
                    + flops.conv_flops(b * hi, 3, m["dem_channels"], half)
                    + flops.conv_flops(b * hi, 3, m["lu_channels"], half))
    assert flops.train_step_flops(cfg["family"], m, b) == counted + needless


def test_full_size_step_count():
    """nowcast_128 at B 4: 3 x 2328.0 GFLOP; ``compiled_cost`` read
    6964.490797 GFLOP on the card, the first cell's step-0 input gradient
    (19.6 GFLOP) less."""
    model = {"image_size": 128, "in_channels": 1, "hidden_dims": [64] * 3,
             "input_frames": 5, "output_frames": 20}
    total = flops.train_step_flops("forecaster", model, 4)
    needless = flops.conv_flops(4 * 128 * 128, 3, 65, 256)
    assert (total - needless) / 1e9 == pytest.approx(6964.490797, abs=1e-5)
