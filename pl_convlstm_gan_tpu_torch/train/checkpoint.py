"""Checkpoints of the port's trainer: save and restore, with async saves.

The semantics of the JAX package's ``train/checkpoint.py``; the format is the
port's own. A checkpoint is a directory holding ``host_state.json`` (epoch,
metric, history, scheduler and early-stopping state; Python's JSON, which
keeps NaN exactly) and ``state.pt``, a ``torch.save`` of the bundle
``{"params": model state_dict, "opt_state": Adam state_dict, "step": int}``
(a GAN run: ``gen_params``, ``disc_params``, ``gen_opt_state``,
``disc_opt_state``, ``step``).
An orbax checkpoint of the JAX package is not read (orbax is JAX's, and the
port imports none of it): weights cross between the packages as a ``.npz``
of flattened flax params (``weights.py``), the Adam moments through
``weights.optax_adam_state`` / ``load_optax_adam_state``.

Async: ``CheckpointWriter.save`` copies the tensors to the CPU before it
returns (so the next step may update the parameters in place) and writes the
files on a thread while training goes on.

Crash safety, as in the JAX writer: a save goes into ``<path>.pending``;
``state.pt`` is written as ``state.pt.tmp`` and renamed when complete, so its
presence proves the pending save finished. The pending directory is promoted
to ``<path>`` on the next save, an explicit ``wait()`` or interpreter exit,
through ``<path>.old``: the previous checkpoint is never deleted before the
new one is complete. ``recover_checkpoint_dir`` (called by
``restore_checkpoint`` and by ``--resume``) promotes a complete pending save
left by a dead process, or moves ``<path>.old`` back after a crash between
the two renames; a pending save owned by a live writer in this process is
left to that writer.

Data parallelism: the replicas hold the same state, so rank 0 alone writes
a checkpoint and alone touches the checkpoint directories (promotion,
recovery); the other ranks wait at a barrier after each promotion and each
recovery, as the JAX writer's ``sync_global_devices``. The files do not
depend on the world size: a checkpoint written at world 2 restores at world
1 and the other way round.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel.mesh import barrier, is_primary

STATE_FILE = "state.pt"
HOST_FILE = "host_state.json"

# pending dirs owned by live writers in this process: recovery must not
# promote them out from under the writer (its own wait() will)
_LIVE_PENDING: set = set()


def _to_cpu(tree: Any) -> Any:
    """A copy of a nest of dicts/lists/tensors with every tensor on the CPU
    (a copy even where it already lies there)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _write(tmp: str, device_state: Any, host_state: Dict) -> None:
    with open(os.path.join(tmp, HOST_FILE), "w") as f:
        json.dump(host_state, f)
    part = os.path.join(tmp, STATE_FILE + ".tmp")
    torch.save(device_state, part)
    os.replace(part, os.path.join(tmp, STATE_FILE))   # the commit


class CheckpointWriter:
    """Async checkpoint writer; one save in flight at a time per writer.
    Under data parallelism every rank calls ``save`` and ``wait`` in the
    same order; rank 0 writes."""

    def __init__(self):
        self._pending: Optional[Tuple[str, str]] = None  # (tmp_dir, final_dir)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # at exit no barrier: the other ranks may be gone
        atexit.register(self.wait, sync=False)

    def save(self, path: str, device_state: Any, host_state: Dict) -> None:
        """Start a save of ``device_state`` (tensors anywhere) and
        ``host_state`` (JSON) to ``path``. Returns once the tensors are
        copied to the CPU; the files are written on a thread and promoted to
        ``path`` by the next save or ``wait()``."""
        path = os.path.abspath(path)
        self.wait()
        tmp = path + ".pending"
        if not is_primary():
            self._pending = (tmp, path)     # rank 0 writes it
            return
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        snapshot = _to_cpu(device_state)

        def run():
            try:
                _write(tmp, snapshot, host_state)
            except Exception as e:   # raised again by wait() in the caller
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self._pending = (tmp, path)
        _LIVE_PENDING.add(tmp)

    def wait(self, sync: bool = True) -> None:
        """Block until the in-flight save (if any) is promoted to its path;
        with ``sync``, every rank waits for rank 0's promotion."""
        if self._pending is None:
            return
        tmp, path = self._pending
        self._pending = None
        if is_primary():
            self._finish(tmp, path)
        if sync:
            barrier()

    def _finish(self, tmp: str, path: str) -> None:
        self._thread.join()
        _LIVE_PENDING.discard(tmp)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save to {path} failed") from err
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.replace(path, old)
        try:
            os.replace(tmp, path)
        except FileNotFoundError:
            # the pending dir vanished (another process on the same output
            # dir?): roll the previous checkpoint back; never kill a run
            if os.path.exists(old) and not os.path.exists(path):
                os.replace(old, path)
            print(f"WARNING: checkpoint promotion of {path} skipped — "
                  f"pending dir disappeared (concurrent writer?)")
        if os.path.exists(old):
            shutil.rmtree(old)


def recover_checkpoint_dir(path: str) -> bool:
    """Recover a checkpoint stranded by a crash, newest first:
    1. ``<path>.pending`` holds a complete save (``state.pt`` and
       ``host_state.json``) of a process that died before promoting it:
       promote it (it is newer than whatever sits at ``path``);
    2. ``path`` is missing and ``<path>.old`` is there (a crash between the
       two promotion renames): move it back.
    Returns True iff a checkpoint exists at ``path`` afterwards. Rank 0
    alone recovers; every rank then waits at a barrier."""
    path = os.path.abspath(path)
    if is_primary():
        _recover(path)
    barrier()
    return os.path.isdir(path)


def _recover(path: str) -> None:
    old, pending = path + ".old", path + ".pending"
    if pending in _LIVE_PENDING:
        pass       # a live writer in this process owns it
    elif (os.path.isfile(os.path.join(pending, STATE_FILE))
          and os.path.isfile(os.path.join(pending, HOST_FILE))):
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(pending, path)
        print(f"Recovered checkpoint {path} from completed-but-unpromoted "
              f"save ({pending})")
    elif not os.path.isdir(path) and os.path.isdir(old):
        os.replace(old, path)
        print(f"Recovered checkpoint {path} from interrupted promotion ({old})")


def restore_checkpoint(path: str, map_location="cpu") -> Tuple[Any, Dict]:
    """(device_state, host_state) of the checkpoint at ``path``, its tensors
    on ``map_location``. Recovers a stranded save first; a pending save of a
    live writer in this process is left alone (callers that also save to
    ``path`` ``wait()`` first to see the newest state)."""
    path = os.path.abspath(path)
    if not recover_checkpoint_dir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    device_state = torch.load(os.path.join(path, STATE_FILE),
                              map_location=map_location, weights_only=True)
    with open(os.path.join(path, HOST_FILE)) as f:
        host_state = json.load(f)
    return device_state, host_state
