"""Self-describing single-file ``.ckpt`` checkpoints, without JAX or optax.

The JAX package writes checkpoints as a pickle of host numpy arrays
({params, batch_stats, opt_state, epoch, ..., args}).  Loading goes
through a restricted Unpickler that resolves only the globals a real
checkpoint needs — numpy array reconstruction and the optax optimizer
state namedtuples — so a crafted file raises ``pickle.UnpicklingError``
instead of running its payload.

The optax namedtuples resolve to plain tuple stand-ins defined here, so
reading a checkpoint never imports optax: serving needs only
``params``/``batch_stats``, and the optimizer state comes back as nested
tuples of numpy arrays under the same class names.
"""

from __future__ import annotations

import importlib
import io
import pickle
import re
from pathlib import Path
from typing import Any, Dict

import numpy as np

CHECKPOINT_SUFFIX = ".ckpt"

# numpy's array/scalar rebuilders; numpy<2 spells its private modules
# ``numpy.core``, numpy>=2 ``numpy._core`` — both load under either.
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}

# optax state namedtuples a training checkpoint holds (add_decayed_weights
# -> EmptyState, scale_by_adam -> ScaleByAdamState, the inject_hyperparams
# wrapper state under the module names it had across optax versions).
_OPTAX_GLOBALS = {
    ("optax._src.base", "EmptyState"),
    ("optax._src.transform", "ScaleByAdamState"),
    ("optax._src.inject", "InjectHyperparamsState"),
    ("optax.schedules._inject", "InjectHyperparamsState"),
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"),
}


class OptaxState(tuple):
    """Plain stand-in for an optax state namedtuple: its fields in order,
    under the original class name (``type(s).__name__``)."""

    __slots__ = ()

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __repr__(self) -> str:
        return f"{type(self).__name__}{tuple.__repr__(self)}"


_STAND_INS = {
    name: type(name, (OptaxState,), {"__slots__": ()})
    for name in {n for _, n in _OPTAX_GLOBALS}
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):  # noqa: D102
        if (module, name) in _NUMPY_GLOBALS:
            return getattr(importlib.import_module(module), name)
        if (module, name) in _OPTAX_GLOBALS:
            return _STAND_INS[name]
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {module}.{name}; "
            f"refusing to load (checkpoints may only contain numpy "
            f"arrays, optax states, and plain python data)"
        )


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """Deserialize a checkpoint without the ability to execute code."""
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def load_checkpoint_bytes(data: bytes) -> Dict[str, Any]:
    """``load_checkpoint`` over an in-memory buffer (same restrictions)."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, OptaxState):
        raise ValueError(
            "optimizer state read without optax cannot be written back; "
            "drop 'opt_state' from the payload"
        )
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "detach"):  # torch tensor
        return tree.detach().cpu().numpy()
    if hasattr(tree, "shape"):
        return np.asarray(tree)
    return tree


def save_checkpoint(path: str | Path, payload: Dict[str, Any]) -> Path:
    """Atomically pickle a checkpoint dict (tensors converted to numpy;
    tmp file + rename, so a crash mid-write never corrupts the target)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return path


def rotate_epoch_checkpoints(results_dir: str | Path, keep: int) -> int:
    """Delete all but the newest ``keep`` per-epoch checkpoints
    (``--keep-checkpoints``; best/final checkpoints are never touched;
    ``keep`` <= 0 keeps all).  Returns the number of files removed."""
    if keep <= 0:
        return 0
    epochs = []
    for p in Path(results_dir).glob(f"checkpoint_epoch_*{CHECKPOINT_SUFFIX}"):
        m = re.search(r"checkpoint_epoch_(\d+)", p.name)
        if m:
            epochs.append((int(m.group(1)), p))
    epochs.sort()
    removed = 0
    for _, p in epochs[: max(0, len(epochs) - keep)]:
        p.unlink(missing_ok=True)
        removed += 1
    return removed
