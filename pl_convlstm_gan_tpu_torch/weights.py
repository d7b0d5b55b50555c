"""Carry weights between a flax params tree and the port's ``state_dict``.

The flax side is a tree of numpy arrays, either nested dicts
(``{"params": {"core": {"cell_0": {"kernel": ..., "bias": ...}}}}``) or flat,
keyed by ``/``-joined paths (``params/core/cell_0/kernel``, the layout of
``flax.traverse_util.flatten_dict(params, sep="/")`` saved with
``np.savez``) or by tuples of names. The torch side names each module by its
flax path joined with dots: ``core.cell_0.weight``.

Conv kernels go HWIO -> OIHW by ``transpose(3, 2, 0, 1)`` and back by
``transpose(2, 3, 1, 0)``; biases are unchanged. Gate order (i|f|o|g) and the
``concat(x, h)`` input-channel order are the same on both sides, so nothing
else moves. Both directions copy values and dtypes exactly.

A streaming state crosses the same way (``stream_state_from_numpy`` /
``stream_state_to_numpy``): the JAX and port ``StreamState`` are both NHWC.

The Adam state crosses too (``load_optax_adam_state`` /
``optax_adam_state``): optax's ``chain(clip_by_global_norm, scale_by_adam)``
state is ``(ClipByGlobalNormState(), ScaleByAdamState(count, mu, nu))``,
whose ``mu`` and ``nu`` are params-shaped trees; ``torch.optim.Adam`` keeps
``step``, ``exp_avg`` and ``exp_avg_sq`` per parameter. The moments' conv
kernels go HWIO <-> OIHW like the params; values are copied exactly.

A whole JAX ``GANTrainState`` crosses with both (``load_gan_train_state`` /
``gan_train_state_to_jax``): generator and discriminator params, both Adam
states and the step.

The Generator's tree (``init_conv``, ``recurrence/cell1``, ``upsample_0/
conv``, ``dem_attn/conv_reduce``, ``post_conv1``, ...) crosses as any other.
A checkpoint of the reference PyTorch Generator (``best_model.pth``, its
``model_state_dict``) is renamed onto that tree by ``reference_to_flax``, a
copy of the JAX package's ``tools/import_torch_checkpoint.py`` map:

    reference module                 flax path
    init_conv                        init_conv
    cell{k}.conv                     recurrence/cell{k}
    dem_attn.conv.0 / .conv.2        dem_attn/conv_reduce / conv_gate
    lu_attn.conv.0 / .conv.2         lu_attn/conv_reduce / conv_gate
    upsample_blocks.{i}.conv         upsample_{i}/conv
    post_process.0 / .2              post_conv1 / post_conv2

``load_reference_pth`` reads such a file straight into the port's
``state_dict``; ``reference_state_dict`` is the inverse, the counterpart of
the JAX tool's ``export_state_dict``: the port's Generator ``state_dict``
under the reference's names, which the reference PyTorch Generator loads.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flat_paths(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(key, tuple):
            path = prefix + key
        else:
            path = prefix + tuple(str(key).split("/"))
        if isinstance(value, Mapping):
            flat.update(_flat_paths(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params tree (nested or flat; a leading ``params`` level is
    optional) -> torch state_dict of OIHW conv weights and biases."""
    state = {}
    for path, value in _flat_paths(params).items():
        if path[0] == "params":
            path = path[1:]
        *modules, leaf = path
        if leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: only 4-D conv kernels "
                                 f"are mapped, got shape {value.shape}")
            value, leaf = value.transpose(3, 2, 0, 1), "weight"
        elif leaf != "bias":
            raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")
        state[".".join(modules + [leaf])] = torch.from_numpy(
            np.array(value, order="C"))
    return state


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``flax_to_state_dict``: a nested ``{"params": ...}`` tree of
    numpy arrays with HWIO conv kernels."""
    root: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *modules, leaf = name.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "weight":
            value, leaf = np.ascontiguousarray(value.transpose(2, 3, 1, 0)), "kernel"
        elif leaf != "bias":
            raise ValueError(f"{name}: unknown parameter {leaf!r}")
        node = root
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = value
    return {"params": root}


def _reference_conv(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.asarray(sd[f"{name}.weight"],
                                np.float32).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"], np.float32)
    return out


def reference_to_flax(sd: Mapping) -> Dict[str, Any]:
    """A reference Generator state_dict (numpy arrays or tensors, OIHW) ->
    the ``{"params": ...}`` tree of the JAX Generator (HWIO kernels)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, Any] = {"init_conv": _reference_conv(sd, "init_conv"),
                              "recurrence": {}}
    for cell in sorted({k.split(".")[0] for k in sd if k.startswith("cell")}):
        params["recurrence"][cell] = _reference_conv(sd, f"{cell}.conv")
    for attn in ("dem_attn", "lu_attn"):
        params[attn] = {"conv_reduce": _reference_conv(sd, f"{attn}.conv.0"),
                        "conv_gate": _reference_conv(sd, f"{attn}.conv.2")}
    i = 0
    while f"upsample_blocks.{i}.conv.weight" in sd:
        params[f"upsample_{i}"] = {
            "conv": _reference_conv(sd, f"upsample_blocks.{i}.conv")}
        i += 1
    params["post_conv1"] = _reference_conv(sd, "post_process.0")
    params["post_conv2"] = _reference_conv(sd, "post_process.2")
    return {"params": params}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference Generator checkpoint (a ``.pth`` bundle with
    ``model_state_dict``, or the bare state_dict) as the port's
    ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model_state_dict", obj)
    return flax_to_state_dict(reference_to_flax(
        {k: v.numpy() for k, v in sd.items()}))


# the port's Generator module path -> the reference's, the inverse of
# reference_to_flax's renames (the port names modules by their flax paths)
_REFERENCE_MODULES = (
    (re.compile(r"init_conv"), "init_conv"),
    (re.compile(r"recurrence\.(cell\d+)"), r"\1.conv"),
    (re.compile(r"(dem_attn|lu_attn)\.conv_reduce"), r"\1.conv.0"),
    (re.compile(r"(dem_attn|lu_attn)\.conv_gate"), r"\1.conv.2"),
    (re.compile(r"upsample_(\d+)\.conv"), r"upsample_blocks.\1.conv"),
    (re.compile(r"post_conv1"), "post_process.0"),
    (re.compile(r"post_conv2"), "post_process.2"),
)


def reference_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The port's Generator ``state_dict`` under the reference PyTorch
    Generator's names (OIHW weights and biases as they are, on the CPU):
    the inverse of ``load_reference_pth``, the counterpart of the JAX
    tool's ``export_state_dict``. Raises ValueError on a name that is not
    the Generator's."""
    out = {}
    for name, tensor in state_dict.items():
        module, leaf = name.rsplit(".", 1)
        for pattern, ref in _REFERENCE_MODULES:
            if pattern.fullmatch(module):
                out[f"{pattern.sub(ref, module)}.{leaf}"] = \
                    tensor.detach().cpu().clone()
                break
        else:
            raise ValueError(f"{name}: not a parameter of the Generator")
    return out


def stream_state_from_numpy(cells, prev_out, device, dtype):
    """A JAX ``StreamState`` given as numpy arrays (``cells`` = ((h, c), ...)
    NHWC, ``prev_out`` [B,H,W,C]) -> the port's ``streaming.StreamState`` on
    ``device`` in ``dtype``. The layouts are the same, so nothing moves;
    values pass through float32, which is exact for float32 and bfloat16
    states (numpy has no bfloat16 of its own)."""
    from .streaming import StreamState
    to = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device, dtype)
    return StreamState(tuple((to(h), to(c)) for h, c in cells), to(prev_out))


def stream_state_to_numpy(state):
    """Inverse of ``stream_state_from_numpy``: (((h, c), ...), prev_out) as
    float32 numpy arrays, exact for float32 and bfloat16 states."""
    to = lambda t: t.detach().to("cpu", torch.float32).numpy()
    return tuple((to(h), to(c)) for h, c in state.cells), to(state.prev_out)


def _adam_leaf(opt_state):
    """The ScaleByAdamState inside an optax chain state (the element with
    ``count``, ``mu`` and ``nu``), or the dict ``optax_adam_state``
    returns."""
    if isinstance(opt_state, Mapping) and \
            {"count", "mu", "nu"} <= set(opt_state):
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_leaf(part)
            except ValueError:
                continue
    raise ValueError("no Adam state (count, mu, nu) in the optax state")


def _param_order(optimizer, model):
    """Model parameter names in the order ``optimizer.state_dict()`` numbers
    them."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def load_optax_adam_state(optimizer, model, opt_state) -> None:
    """Load optax's Adam state (the chain state, or ``optax_adam_state``'s
    dict) into ``optimizer`` (a ``torch.optim.Adam`` over ``model``'s
    parameters): step = count, exp_avg = mu, exp_avg_sq = nu."""
    count, mu, nu = _adam_leaf(opt_state)
    mu, nu = flax_to_state_dict(mu), flax_to_state_dict(nu)
    step = float(np.asarray(count))
    state = {i: {"step": torch.tensor(step, dtype=torch.float32),
                 "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for i, name in enumerate(_param_order(optimizer, model))}
    optimizer.load_state_dict({"state": state, "param_groups":
                               optimizer.state_dict()["param_groups"]})


def optax_adam_state(optimizer, model) -> Dict[str, Any]:
    """``optimizer``'s Adam state as {"count": int32, "mu": tree, "nu":
    tree}, the fields of optax's ``ScaleByAdamState`` with params-shaped
    ``{"params": ...}`` trees of numpy arrays (zeros and count 0 before the
    first step)."""
    mu, nu, count = {}, {}, 0
    params = dict(model.named_parameters())
    for i, name in enumerate(_param_order(optimizer, model)):
        st = optimizer.state.get(params[name], {})
        zeros = torch.zeros_like(params[name])
        mu[name] = st.get("exp_avg", zeros)
        nu[name] = st.get("exp_avg_sq", zeros)
        if "step" in st:
            count = int(st["step"])
    return {"count": np.int32(count), "mu": state_dict_to_flax(mu),
            "nu": state_dict_to_flax(nu)}


def _field(state, name):
    """``state.name`` or ``state[name]``: a JAX GANTrainState or a dict."""
    return state[name] if isinstance(state, Mapping) else getattr(state, name)


def load_gan_train_state(state, jax_state) -> None:
    """Load a JAX ``GANTrainState`` (numpy leaves, e.g. after
    ``jax.device_get``; or a dict of its five fields) into the port's
    ``train.steps.GANTrainState``: ``gen_params`` / ``disc_params`` into the
    two modules, ``gen_opt_state`` / ``disc_opt_state`` into their Adams,
    and ``step``."""
    state.gen.load_state_dict(flax_to_state_dict(_field(jax_state,
                                                        "gen_params")))
    state.disc.load_state_dict(flax_to_state_dict(_field(jax_state,
                                                         "disc_params")))
    load_optax_adam_state(state.gen_optimizer, state.gen,
                          _field(jax_state, "gen_opt_state"))
    load_optax_adam_state(state.disc_optimizer, state.disc,
                          _field(jax_state, "disc_opt_state"))
    state.step = int(np.asarray(_field(jax_state, "step")))


def gan_train_state_to_jax(state) -> Dict[str, Any]:
    """Inverse of ``load_gan_train_state``: {"gen_params", "disc_params"
    (``{"params": ...}`` trees), "gen_opt_state", "disc_opt_state" (as
    ``optax_adam_state`` gives them), "step" (int32)}."""
    return {"gen_params": state_dict_to_flax(state.gen.state_dict()),
            "disc_params": state_dict_to_flax(state.disc.state_dict()),
            "gen_opt_state": optax_adam_state(state.gen_optimizer, state.gen),
            "disc_opt_state": optax_adam_state(state.disc_optimizer,
                                               state.disc),
            "step": np.int32(state.step)}
