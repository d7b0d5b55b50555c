"""The port's batch serving artifacts (``serve.export_model`` /
``load_exported``) against its eager predictor and against the JAX
package's ``jax.export`` artifacts, on the CPU.

Weights are a flax params tree made with numpy from a seed: the port reads
it as an ``.npz``, the JAX package from an orbax checkpoint of the same
tree. Tolerances: an artifact against the port's eager path on the same
path is bit for bit (``torch.equal``: the exported graph runs the same ops
in the same order; the kernel path's op runs the same host loop); port
against JAX float32 atol=rtol=1e-5, the bf16 rollout 1e-3 absolute (the
tolerances of tests/test_torch_predict.py and test_torch_models.py)."""
import io
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pl_convlstm_gan_tpu.config import Config as JaxConfig
from pl_convlstm_gan_tpu.config import load_config as jax_load_config
from pl_convlstm_gan_tpu.serve import export_model as jax_export_model
from pl_convlstm_gan_tpu.serve import load_exported as jax_load_exported
from pl_convlstm_gan_tpu.train.checkpoint import save_checkpoint
from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import Config, load_config
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import kernel_pack
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    pack_weights, rollout_plain)
from pl_convlstm_gan_tpu_torch.predict import build_model, load_predictor
from pl_convlstm_gan_tpu_torch.serve import (export_model, export_streaming,
                                             load_exported)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               state_dict_to_flax)
from test_torch_isolation import BLOCKED
from test_torch_models import T_IN, T_OUT, flax_params, frames_np

REPO = Path(__file__).resolve().parents[1]
HIDDEN = (8, 8)
SIZE = 16
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-3, rtol=0.0)


def model_dict(impl="torch", **model):
    return {"family": "forecaster", "hidden_dims": list(HIDDEN),
            "input_frames": T_IN, "output_frames": T_OUT,
            "rollout_impl": impl, **model}


def port_config(tmp_path, impl="torch", dtype="float32", **model):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_image_size": SIZE,
                 "synthetic_num_sequences": 4},
        "model": model_dict(impl, **model),
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": str(tmp_path / "out")}})


def jax_config(dtype="float32"):
    return JaxConfig.from_dict({
        "data": {"source": "synthetic"}, "model": model_dict("xla"),
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": "/tmp/unused_torch_serve"}})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(.npz for the port, orbax checkpoint for JAX, params) of one seeded
    forecaster."""
    root = tmp_path_factory.mktemp("serve_ckpt")
    params = flax_params(31, HIDDEN)
    npz = root / "params.npz"
    np.savez(npz, **flatten_dict(params, sep="/"))
    save_checkpoint(str(root / "jax_ckpt"), {"params": params},
                    {"epoch": 0, "rmse": 1.0})
    return str(npz), str(root / "jax_ckpt"), params


def graph_ops(blob) -> set:
    ep = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_export_model_equals_eager_and_matches_jax(tmp_path, checkpoints,
                                                   impl, dtype):
    """An artifact exported from a batch-1 example serves batches 2 and 5
    after a fresh load: bit for bit the eager predictor of its path, and
    JAX's load_exported of the same weights within the tolerance."""
    npz, jax_ckpt, _ = checkpoints
    cfg = port_config(tmp_path, impl, dtype)
    frames = frames_np(32, b=5)
    blob = export_model(cfg, npz, (frames[:1],), device="cpu")
    assert isinstance(blob, bytes)
    ops = graph_ops(blob)
    assert ("plcg_torch.rollout.default" in ops) == (impl == "kernel")
    serve = load_exported(blob, device="cpu")
    eager = load_predictor(cfg, npz, device="cpu")
    want = jax_load_exported(jax_export_model(
        jax_config(dtype), jax_ckpt, (frames[:1],), platforms=("cpu",)))
    for b in (2, 5):
        out = serve(frames[:b])
        assert out.shape == (b, T_OUT, 1, SIZE, SIZE)
        assert out.dtype == torch.float32
        assert torch.equal(out, eager(frames[:b]))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(want(jnp.asarray(frames[:b]))),
            **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_artifact_holds_the_op_and_equals_rollout_plain(
        tmp_path, checkpoints, dtype):
    """rollout_impl kernel on the CPU: the graph is the plcg_torch.rollout
    node and nothing of the model, and its output is rollout_plain's bit
    for bit (the op runs the kernel loop, whose wrappers take their plain
    versions on CPU tensors)."""
    npz, _, params = checkpoints
    cfg = port_config(tmp_path, "kernel", dtype)
    blob = export_model(cfg, npz, (frames_np(33)[:1],), device="cpu")
    ops = graph_ops(blob)
    assert "plcg_torch.rollout.default" in ops
    assert not any("convolution" in op for op in ops)
    frames = torch.from_numpy(frames_np(34, b=3))
    cdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    want = rollout_plain(pack_weights(flax_to_state_dict(params), cdtype),
                         frames, T_OUT, cdtype)
    assert torch.equal(load_exported(blob, device="cpu")(frames), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_kernel_artifact_carries_k1_packed_weights(tmp_path, checkpoints,
                                                       dtype):
    """A kernel-path artifact exported on the CPU holds K1's packed weight of
    every cell (kernel_pack of its HWIO weight), as one exported on the card
    does, so that on the card K1 packs nothing at a launch."""
    npz, _, params = checkpoints
    blob = export_model(port_config(tmp_path, "kernel", dtype), npz,
                        (frames_np(33)[:1],), device="cpu")
    buffers = torch.export.load(io.BytesIO(blob)).state_dict
    cdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    cells = pack_weights(flax_to_state_dict(params), cdtype).cells
    for i, (w, _) in enumerate(cells):
        assert torch.equal(buffers[f"weights.cell_{i}_packed"],
                           kernel_pack(w, cdtype))


@pytest.mark.parametrize("entry", ["batch", "stream"])
@pytest.mark.parametrize("dtype, model, rule", [
    ("bfloat16", {"hidden_dims": [4, 4]}, "multiple of 8"),
    ("float32", {"kernel_size": 7}, "kernel sizes")])
def test_cpu_kernel_export_refuses_what_the_card_refuses(tmp_path, entry,
                                                         dtype, model, rule):
    """A kernel-path export on the CPU holds the model to the card's rules
    of K1 (rollout_kernel_misfit on the card), though K1's plain version
    would take it there: an artifact does not depend on the device it was
    exported on."""
    cfg = port_config(tmp_path, "kernel", dtype, **model)
    ckpt = str(tmp_path / "weights.pt")
    torch.save(build_model(cfg).state_dict(), ckpt)
    with pytest.raises(ValueError, match=rule):
        if entry == "batch":
            export_model(cfg, ckpt, (frames_np(33)[:1],), device="cpu")
        else:
            export_streaming(cfg, ckpt, SIZE, SIZE, horizons=(2,),
                             device="cpu")


def test_static_batch_refuses_another_batch(tmp_path, checkpoints):
    npz, _, _ = checkpoints
    frames = frames_np(35, b=4)
    blob = export_model(port_config(tmp_path, "kernel"), npz, (frames[:2],),
                        batch_polymorphic=False, device="cpu")
    serve = load_exported(blob, device="cpu")
    assert serve(frames[:2]).shape[0] == 2
    with pytest.raises(Exception):
        serve(frames)


def test_export_refuses_int8_and_a_wrong_window(tmp_path, checkpoints):
    npz, _, _ = checkpoints
    frames = frames_np(36)
    with pytest.raises(ValueError, match="A13"):
        export_model(port_config(tmp_path, "int8"), npz, (frames,),
                     device="cpu")
    serve = load_exported(export_model(port_config(tmp_path, "kernel"), npz,
                                       (frames,), device="cpu"), device="cpu")
    with pytest.raises(Exception):
        serve(frames[:, :T_IN - 1])


_SERVE_ALONE = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
from pl_convlstm_gan_tpu_torch.serve import load_exported
with open({art!r}, "rb") as f:
    serve = load_exported(f.read(), device="cpu")
np.save({out!r}, serve(np.load({inp!r})).numpy())
"""


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_artifact_is_self_contained(tmp_path, checkpoints, impl):
    """The artifact serves in a process where the checkpoint is gone and
    jax, flax, orbax and the JAX package cannot be imported."""
    npz, _, params = checkpoints
    ckpt = tmp_path / "params.npz"
    ckpt.write_bytes(Path(npz).read_bytes())
    cfg = port_config(tmp_path, impl)
    frames = frames_np(37, b=3)
    want = load_predictor(cfg, str(ckpt), device="cpu")(frames)
    art = tmp_path / "model.pt2"
    art.write_bytes(export_model(cfg, str(ckpt), (frames[:1],),
                                 device="cpu"))
    ckpt.unlink()
    np.save(tmp_path / "in.npy", frames)
    code = _SERVE_ALONE.format(blocked=BLOCKED, art=str(art),
                               out=str(tmp_path / "out.npy"),
                               inp=str(tmp_path / "in.npy"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "out.npy")), want)


def test_generator_export_matches_jax_and_eager(tmp_path):
    """ci_smoke's Generator (LUCC 5 classes), exported on its plain cells
    from a batch-1 example: JAX's artifact of the same params at 1e-5, the
    eager plain-cell predictor bit for bit, at batches 2 and 3."""
    jcfg = jax_load_config("ci_smoke")
    jcfg.model.hidden_dims = [8, 8]
    lu_ch = 5
    rng = np.random.default_rng(38)
    rain = rng.random((3, 3, 1, 8, 8), dtype=np.float32)
    dem = rng.random((3, 1, 8, 8), dtype=np.float32)
    lu = rng.random((3, lu_ch, 8, 8), dtype=np.float32)
    cfg = load_config("ci_smoke")
    cfg.model.hidden_dims = [8, 8]
    # seeded numpy weights in the model's shapes, through the weight bridge
    shapes = build_model(cfg, lu_channels=lu_ch).state_dict()
    params = state_dict_to_flax({
        k: torch.from_numpy(rng.uniform(-0.3, 0.3, tuple(v.shape)).astype(
            np.float32)) for k, v in shapes.items()})
    ckpt = str(tmp_path / "gen_ckpt")
    save_checkpoint(ckpt, {"params": params}, {"epoch": 0, "rmse": 1.0})
    want = jax_load_exported(jax_export_model(
        jcfg, ckpt, (rain[:1], dem[:1], lu[:1]), lu_channels=lu_ch,
        platforms=("cpu",)))
    npz = tmp_path / "gen.npz"
    np.savez(npz, **flatten_dict(params, sep="/"))
    cfg.model.convlstm_impl = "pallas"          # exported on its plain cells
    serve = load_exported(export_model(
        cfg, str(npz), (rain[:1], dem[:1], lu[:1]), lu_channels=lu_ch,
        device="cpu"), device="cpu")
    cfg.model.convlstm_impl = "xla"
    eager = load_predictor(cfg, str(npz), lu_channels=lu_ch, device="cpu")
    for b in (2, 3):
        out = serve(rain[:b], dem[:b], lu[:b])
        assert torch.equal(out, eager(rain[:b], dem[:b], lu[:b]))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(want(rain[:b], dem[:b], lu[:b])), **F32)


def _write_config(tmp_path, impl):
    path = tmp_path / "serve.yaml"
    port_config(tmp_path, impl).to_yaml(str(path))
    return str(path)


@pytest.mark.parametrize("with_input", [True, False])
def test_cli_export_mode(tmp_path, checkpoints, with_input):
    """--mode export writes <output_dir>/model.pt2 (shapes from --input, or
    from the configured dataset without it), served as the eager
    predictor serves."""
    npz, _, _ = checkpoints
    frames = frames_np(39, b=2)
    args = ["--config", _write_config(tmp_path, "kernel"), "--mode",
            "export", "--checkpoint", npz, "--device", "cpu"]
    if with_input:
        np.save(tmp_path / "frames.npy", frames)
        args += ["--input", str(tmp_path / "frames.npy")]
    cli.main(args)
    blob = (tmp_path / "out" / "model.pt2").read_bytes()
    out = load_exported(blob, device="cpu")(frames)
    want = load_predictor(port_config(tmp_path, "kernel"), npz,
                          device="cpu")(frames)
    assert torch.equal(out, want)


def test_cli_export_generator_needs_an_npz(tmp_path):
    cfg = load_config("ci_smoke")
    cfg.output.output_dir = str(tmp_path / "out")
    path = tmp_path / "gen.yaml"
    cfg.to_yaml(str(path))
    with pytest.raises(SystemExit, match="needs --input"):
        cli.main(["--config", str(path), "--mode", "export", "--device",
                  "cpu", "--checkpoint", str(tmp_path / "x.npz")])
