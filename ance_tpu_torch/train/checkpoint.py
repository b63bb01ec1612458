"""Checkpoints and their completeness signal (counterpart of
``ance_tpu/train/checkpoint.py``), with the same directory protocol:

    <dir>/checkpoint-<step>/
        pytorch_model.bin    the model's state dict, HF key names
        optimizer.pt         optimizer and schedule state (optional)
        meta.json            {"step": N, ...extra}
        DONE                 completeness marker, written LAST

The parameters are an HF-layout ``pytorch_model.bin``, the reference's own
checkpoint file: ``models/weights.py::load_pretrained`` loads it strictly,
the JAX package's torch reader (``hf_loader.load_torch_state_dict``) reads
it as it is, and nothing needs converting for export. The directory is
written under a temporary name and renamed into place before DONE, so a
reader that waits for DONE never sees a partial checkpoint.
:class:`AsyncCheckpointer` writes the same files from a background thread
and publishes ``meta.json`` and DONE only at its fence (``wait``).

Checkpoints of the JAX package's trainer load too, in both of its
layouts, parameters and optimizer state alike:

  * msgpack (``params.msgpack`` and ``opt_state.msgpack``, written by
    ``flax.serialization``: warmup, train, DPR, seed-pretrain and the JAX
    ``ance-loop``'s last checkpoint), read by
    :mod:`ance_tpu_torch.train.flax_msgpack`;
  * orbax (``state/`` holding ``{"params", "opt_state"}``, the JAX
    ``AsyncCheckpointer``'s, every checkpoint of the pipelined loop, or
    the legacy ``params/``), read by
    :mod:`ance_tpu_torch.train.orbax_reader` (OCDBT, zarr v2 and zstd on
    the port's own code).

:func:`load_raw_params` and :func:`load_raw_opt_state` return the JAX
trees; ``models/weights.py::state_dict_from_flax`` maps the parameters and
``optim/optax_state.py`` the optimizer state (LAMB or AdamW moments, step
count, rewarmup anchor and horizon) onto the port's, so a run the JAX
package trained resumes here where it stopped.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import threading
from typing import Optional

import torch

DONE_MARKER = "DONE"
MODEL_FILE = "pytorch_model.bin"
OPTIMIZER_FILE = "optimizer.pt"
NATIVE_FILE = "params.msgpack"  # the JAX package's parameters
NATIVE_OPT_FILE = "opt_state.msgpack"  # and its optimizer state


class UnreadableCheckpoint(ValueError):
    """A checkpoint directory the port cannot load; the message names the
    file or directory. The CLI exits with it."""


def checkpoint_no(path: str) -> int:
    """Trailing integer of a checkpoint dirname
    (reference utils/util.py:224-226)."""
    nums = re.findall(r"\d+", os.path.basename(os.path.normpath(path)))
    return int(nums[-1]) if nums else 0


def _to_cpu(obj):
    """A host copy of every tensor in ``obj`` (a copy on the CPU too, so
    later in-place updates of the live tensors do not reach it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str, step: int, model: torch.nn.Module,
                    optimizer_state: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Write ``checkpoint-<step>``: a temporary directory renamed into
    place, then DONE. Tensors are saved from host copies."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"checkpoint-{step}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".ckpt-{step}-")
    try:
        torch.save(_to_cpu(model.state_dict()), os.path.join(tmp, MODEL_FILE))
        if optimizer_state is not None:
            torch.save(_to_cpu(optimizer_state),
                       os.path.join(tmp, OPTIMIZER_FILE))
        meta = {"step": int(step)}
        meta.update(extra or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(final, DONE_MARKER), "w") as f:
        f.write(str(step))
    return final


class AsyncCheckpointer:
    """Checkpoints written off the caller's thread (counterpart of
    ``ance_tpu/train/checkpoint.py::AsyncCheckpointer``, orbax's role
    there).

    :meth:`save` copies the parameters and the optimizer state to the host
    at once (so the train steps after it may update the live tensors in
    place), creates ``checkpoint-<step>/`` and starts a thread that writes
    ``pytorch_model.bin`` and ``optimizer.pt`` into it; the thread touches
    no device tensor. :meth:`wait` joins the thread (re-raising what it
    raised), then writes ``meta.json`` and DONE, so a checkpoint is complete
    (:func:`is_complete`, :func:`get_latest_checkpoint`) only after its
    fence, and its files are :func:`save_checkpoint`'s."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[tuple] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, model: torch.nn.Module,
             optimizer_state: Optional[dict] = None,
             extra: Optional[dict] = None) -> str:
        """Start writing ``checkpoint-<step>``; fences an earlier save
        first. Returns the directory (complete after :meth:`wait`)."""
        self.wait()
        params = _to_cpu(model.state_dict())
        opt = _to_cpu(optimizer_state) if optimizer_state is not None \
            else None
        final = os.path.join(self.directory, f"checkpoint-{step}")
        os.makedirs(self.directory, exist_ok=True)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.makedirs(final)
        meta = {"step": int(step)}
        meta.update(extra or {})
        self._pending = (final, meta)

        def write():
            try:
                torch.save(params, os.path.join(final, MODEL_FILE))
                if opt is not None:
                    torch.save(opt, os.path.join(final, OPTIMIZER_FILE))
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="checkpoint",
                                        daemon=True)
        self._thread.start()
        return final

    def wait(self) -> None:
        """Block until the in-flight save is on disk, then publish its
        ``meta.json`` and DONE marker."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is None:
            return
        final, meta = self._pending
        self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        with open(os.path.join(final, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(final, DONE_MARKER), "w") as f:
            f.write(str(meta["step"]))


def is_complete(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, DONE_MARKER))


def get_latest_checkpoint(training_dir: str,
                          init_model_dir: Optional[str] = None
                          ) -> tuple[Optional[str], int]:
    """Newest COMPLETE checkpoint dir and its step, else
    (init_model_dir, 0) (reference run_ann_data_gen.py:55-71)."""
    if not training_dir or not os.path.isdir(training_dir):
        return init_model_dir, 0
    best_step, best_path = -1, None
    for name in next(os.walk(training_dir))[1]:
        path = os.path.join(training_dir, name)
        if not is_complete(path):
            continue
        step = checkpoint_no(name)
        if step > best_step:
            best_step, best_path = step, path
    if best_path is None:
        return init_model_dir, 0
    return best_path, best_step


def is_native(ckpt_dir: str) -> bool:
    """True for a JAX-package checkpoint: no ``pytorch_model.bin``, but a
    ``params.msgpack`` or an orbax ``state/`` / ``params/`` directory."""
    return not os.path.exists(os.path.join(ckpt_dir, MODEL_FILE)) and (
        os.path.exists(os.path.join(ckpt_dir, NATIVE_FILE))
        or os.path.isdir(os.path.join(ckpt_dir, "state"))
        or os.path.isdir(os.path.join(ckpt_dir, "params")))


def load_raw_params(ckpt_dir: str) -> dict:
    """The flax parameter tree of a JAX-package checkpoint, either layout
    (counterpart of ``ance_tpu/train/checkpoint.py::load_raw_params``):
    nested dicts of numpy arrays, bf16 leaves as ``torch.bfloat16``
    tensors. Raises :class:`UnreadableCheckpoint` naming the file for a
    missing file or bytes the readers do not know."""
    from ance_tpu_torch.train.flax_msgpack import read_msgpack
    from ance_tpu_torch.train.orbax_reader import read_item
    path = os.path.join(ckpt_dir, NATIVE_FILE)
    if os.path.exists(path):
        try:
            return read_msgpack(path)
        except ValueError as e:
            raise UnreadableCheckpoint(str(e)) from None
    state = os.path.join(ckpt_dir, "state")
    if os.path.isdir(state):
        tree = read_item(state, "params")
        if tree is None:
            raise UnreadableCheckpoint(f"{state}: the orbax item holds no "
                                       "params")
        return tree
    if os.path.isdir(os.path.join(ckpt_dir, "params")):
        return read_item(os.path.join(ckpt_dir, "params"))
    raise UnreadableCheckpoint(f"{ckpt_dir}: neither {MODEL_FILE} nor "
                               f"{NATIVE_FILE}")


def load_raw_opt_state(ckpt_dir: str):
    """The JAX optimizer state tree of a JAX-package checkpoint, from
    ``opt_state.msgpack`` or the orbax ``state/`` item's ``opt_state``
    (tuples as dicts keyed ``"0"``, ``"1"``, ...); None when the
    checkpoint has none (the legacy orbax ``params/`` never has)."""
    from ance_tpu_torch.train.flax_msgpack import read_msgpack
    from ance_tpu_torch.train.orbax_reader import read_item
    path = os.path.join(ckpt_dir, NATIVE_OPT_FILE)
    if os.path.exists(path):
        try:
            return read_msgpack(path)
        except ValueError as e:
            raise UnreadableCheckpoint(str(e)) from None
    state = os.path.join(ckpt_dir, "state")
    if os.path.isdir(state):
        return read_item(state, "opt_state")
    return None


def holds_weights(model_dir: str) -> bool:
    """True for a directory that is itself a checkpoint of either layout:
    a torch state dict (the port's ``pytorch_model.bin`` or an HF
    directory's single ``*.bin`` / ``*.pt``, the file rules of
    ``models/weights.py::checkpoint_file``) or a JAX-package one."""
    return os.path.isdir(model_dir) and (is_native(model_dir) or any(
        f.endswith((".bin", ".pt")) and f != "training_args.bin"
        for f in os.listdir(model_dir)))


def state_dict(ckpt_dir: str) -> tuple[dict[str, torch.Tensor], str]:
    """A checkpoint directory's parameters as a port state dict, whichever
    layout holds them, and the file they were read from: the torch state
    dict as saved (a DPR ``CheckpointState``, the reference's single-file
    dict, gives its ``model_dict``), or a JAX-package checkpoint's tree (a
    RobertaDot, BiEncoder or SeedForMaskedLM one, msgpack or orbax) as
    fp32, through :func:`load_raw_params` and ``models/weights.py::
    state_dict_from_flax`` (a note on stderr says so)."""
    from ance_tpu_torch.models.weights import (checkpoint_file,
                                               state_dict_from_flax)
    if not is_native(ckpt_dir):
        path = checkpoint_file(ckpt_dir)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model_dict" in sd:
            sd = sd["model_dict"]  # run_ann_dpr.py:376-392
        return sd, path
    path = _native_source(ckpt_dir)
    tree = load_raw_params(ckpt_dir)
    try:
        sd = state_dict_from_flax(tree)
    except (KeyError, TypeError) as e:
        raise UnreadableCheckpoint(
            f"{path}: not a RobertaDot, BiEncoder or SeedForMaskedLM "
            f"parameter tree (missing {e})") from None
    print(f"note: {ckpt_dir} is a JAX-package checkpoint: its parameters "
          f"are read from {os.path.basename(path)}", file=sys.stderr)
    return sd, path


def _native_source(ckpt_dir: str) -> str:
    """The file or orbax item a JAX-package checkpoint's parameters are
    read from."""
    for name in (NATIVE_FILE, "state", "params"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            return path
    return os.path.join(ckpt_dir, NATIVE_FILE)


def load_params(ckpt_dir: str, model: torch.nn.Module,
                adapt=None) -> str:
    """Load a checkpoint directory's parameters (:func:`state_dict`)
    strictly into ``model``, through ``adapt(state_dict, model)`` first
    where the model's registry entry has one (``seeddot_nll``: a fairseq
    SEED checkpoint imported, a ``seed-pretrain`` one's encoder alone).
    Returns the file loaded."""
    from ance_tpu_torch.models.weights import load_weights
    sd, path = state_dict(ckpt_dir)
    if adapt is not None:
        sd = adapt(sd, model)
    load_weights(model, sd)
    return path


def load_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                    optimizer=None) -> tuple[Optional[dict], dict]:
    """Load the parameters strictly into ``model`` (in place, onto its
    device). Returns (the optimizer state or None, meta): the port's
    ``optimizer.pt`` as saved, or a JAX-package checkpoint's optimizer
    state mapped onto ``optimizer`` (``optim/optax_state.py``; None when
    no ``optimizer`` is given or the checkpoint has no state)."""
    load_params(ckpt_dir, model)
    opt_state = None
    if is_native(ckpt_dir):
        tree = load_raw_opt_state(ckpt_dir) if optimizer is not None \
            else None
        if tree is not None:
            from ance_tpu_torch.optim.optax_state import \
                optimizer_state_from_jax
            try:
                opt_state = optimizer_state_from_jax(tree, optimizer, model)
            except ValueError as e:
                raise UnreadableCheckpoint(f"{ckpt_dir}: {e}") from None
    else:
        opt_path = os.path.join(ckpt_dir, OPTIMIZER_FILE)
        if os.path.exists(opt_path):
            opt_state = torch.load(opt_path, map_location="cpu",
                                   weights_only=True)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    return opt_state, meta


def resume_train_state(training_dir: str, state):
    """Restore the newest complete checkpoint into a ``TrainState``: the
    parameters, and the optimizer (moments, step count, schedule anchor)
    when saved, the JAX package's included (a note on stderr names what
    was restored). Returns (state, resumed step); (state, 0) when there is
    nothing complete."""
    path, step = get_latest_checkpoint(training_dir)
    if path is None or not is_complete(path):
        return state, 0
    opt_state, _ = load_checkpoint(path, state.model, state.optimizer)
    if opt_state is not None:
        state.optimizer.load_state_dict(opt_state)
        if is_native(path):
            restored = f"count {state.optimizer.count}"
            if "rewarmup" in opt_state:
                restored += (f", anchor {opt_state['rewarmup']['anchor']}, "
                             f"horizon {opt_state['rewarmup']['horizon']}")
            print(f"note: {path} is a JAX-package checkpoint: its "
                  f"parameters and its optimizer state ({restored}) are "
                  "restored", file=sys.stderr)
    state.step = step
    return state, step
