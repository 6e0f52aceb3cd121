"""The weight bridge between the JAX package's variables and the port's
modules, both ways.

``variables`` is the JAX package's ``{"params", "batch_stats"}`` tree
with numpy leaves (as a ``.ckpt`` holds it).  Layout rules:

- Conv kernel HWIO -> OIHW;
- ConvTranspose kernel HWIO -> IOHW with both spatial dims flipped (Flax's
  ConvTranspose is a fractionally-strided convolution, torch's the conv
  gradient);
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var; GroupNorm scale/bias -> weight/bias;
- the ConvLSTM's fused gate kernel ``[3,3,I+H,4H]`` splits at input
  channel I into ``w_x`` (-> OIHW) and ``w_h`` (kept HWIO).

Both model families go through it: ``VideoAutoencoder`` and the image
model's ``ConvAutoencoder``.

Every key the model needs must be there and every leaf of the tree must
be used; anything else raises.  ``state_dict_to_flax`` inverts each rule,
so a checkpoint the port trains loads into the JAX package's model.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

Path = Tuple[str, ...]
Model = Union[VideoAutoencoder, ConvAutoencoder]


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))  # flip, HWIO -> IOHW


def _conv_inverse(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _conv_transpose_inverse(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]  # IOHW -> HWIO, flip


def _norm_entries(prefix: str, scope: Path, name: str, kind: str) -> List[tuple]:
    flax = ("BatchNorm_" if kind == "batch" else "GroupNorm_") + name
    out = [
        (f"{prefix}.weight", ("params", *scope, flax, "scale"), None),
        (f"{prefix}.bias", ("params", *scope, flax, "bias"), None),
    ]
    if kind == "batch":
        out += [
            (f"{prefix}.running_mean", ("batch_stats", *scope, flax, "mean"), None),
            (f"{prefix}.running_var", ("batch_stats", *scope, flax, "var"), None),
        ]
    return out


def _layer_entries(prefix: str, scope: Path, convert: Callable) -> List[tuple]:
    """A conv's (or ConvTranspose's) kernel and bias at Flax path ``scope``."""
    return [(f"{prefix}.weight", ("params", *scope, "kernel"), convert),
            (f"{prefix}.bias", ("params", *scope, "bias"), None)]


def _image_entries(model: ConvAutoencoder) -> List[Tuple[str, Path, Callable | None]]:
    entries: List[tuple] = []
    for i in range(len(model.encoder.blocks)):
        scope = ("encoder", f"EncoderBlock_{i}")
        for j in (0, 1):
            entries += _layer_entries(f"encoder.blocks.{i}.conv{j + 1}", scope + (f"Conv_{j}",),
                                      _conv)
            entries += _norm_entries(f"encoder.blocks.{i}.norm{j + 1}", scope, str(j),
                                     model.norm)
    for i in range(len(model.decoder.blocks)):
        scope, prefix = ("decoder", f"DecoderBlock_{i}"), f"decoder.blocks.{i}"
        entries += _layer_entries(f"{prefix}.deconv", scope + ("ConvTranspose_0",),
                                  _conv_transpose)
        entries += _norm_entries(f"{prefix}.norm1", scope, "0", model.norm)
        entries += _layer_entries(f"{prefix}.conv", scope + ("Conv_0",), _conv)
        entries += _norm_entries(f"{prefix}.norm2", scope, "1", model.norm)
    entries += _layer_entries("decoder.deconv", ("decoder", "ConvTranspose_0"), _conv_transpose)
    entries += _norm_entries("decoder.norm", ("decoder",), "0", model.norm)
    entries += _layer_entries("decoder.conv", ("decoder", "Conv_0"), _conv)
    return entries


def _entries(model: Model) -> List[Tuple[str, Path, Callable | None]]:
    """(state_dict key, path in the Flax tree, layout conversion)."""
    if isinstance(model, ConvAutoencoder):
        return _image_entries(model)
    entries: List[tuple] = []
    for i in range(len(model.encoder.convs)):
        entries += [
            (f"encoder.convs.{i}.weight", ("params", "encoder", f"Conv_{i}", "kernel"), _conv),
            (f"encoder.convs.{i}.bias", ("params", "encoder", f"Conv_{i}", "bias"), None),
        ]
        entries += _norm_entries(f"encoder.norms.{i}", ("encoder",), str(i), model.norm)
    for i, layer in enumerate(model.convlstm.layers):
        n_in = layer.input_dim
        path = ("params", "convlstm", f"ConvLSTMLayer_{i}")
        entries += [
            (f"convlstm.layers.{i}.w_x", path + ("kernel",), lambda k, n=n_in: _conv(k[:, :, :n])),
            (f"convlstm.layers.{i}.w_h", path + ("kernel",), lambda k, n=n_in: k[:, :, n:]),
            (f"convlstm.layers.{i}.bias", path + ("bias",), None),
        ]
    if model.proj is not None:
        entries += [
            ("proj.weight", ("params", "proj", "kernel"), _conv),
            ("proj.bias", ("params", "proj", "bias"), None),
        ]
    for i in range(len(model.decoder.deconvs)):
        path = ("params", "decoder", f"ConvTranspose_{i}")
        entries += [
            (f"decoder.deconvs.{i}.weight", path + ("kernel",), _conv_transpose),
            (f"decoder.deconvs.{i}.bias", path + ("bias",), None),
        ]
    for i in range(len(model.decoder.norms)):
        entries += _norm_entries(f"decoder.norms.{i}", ("decoder",), str(i), model.norm)
    return entries


def _leaves(tree: Any, prefix: Path = ()) -> List[Path]:
    if isinstance(tree, Mapping):
        out: List[Path] = []
        for k, v in tree.items():
            out += _leaves(v, prefix + (str(k),))
        return out
    return [prefix]


def flax_to_state_dict(model: Model, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict`` (f32 CPU tensors) built from a Flax
    variables tree.  Raises KeyError for a missing key, ValueError for a
    shape mismatch or an unused leaf."""
    reference = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for key, path, convert in _entries(model):
        node: Any = variables
        for i, part in enumerate(path):
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(f"variables lack {'/'.join(path[: i + 1])} (needed for {key})")
            node = node[part]
        used.add(path)
        arr = np.asarray(node, np.float32)
        if convert is not None:
            arr = convert(arr)
        tensor = torch.from_numpy(np.array(arr, np.float32, order="C"))
        if tuple(tensor.shape) != tuple(reference[key].shape):
            raise ValueError(
                f"{'/'.join(path)} gives {key} shape {tuple(tensor.shape)}, "
                f"the model has {tuple(reference[key].shape)}"
            )
        out[key] = tensor
    unused = [p for p in _leaves(variables) if p not in used]
    if unused:
        raise ValueError("variables hold leaves the model does not use: "
                         + ", ".join("/".join(p) for p in unused))
    for key, value in reference.items():
        if key in out:
            continue
        if not key.endswith("num_batches_tracked"):  # the one torch-only buffer
            raise KeyError(f"no Flax variable maps to {key}")
        out[key] = value.detach().cpu().clone()
    return out


def state_dict_to_flax(model: Model) -> Dict[str, Dict]:
    """The model's weights as the JAX package's ``{"params",
    "batch_stats"}`` tree (f32 numpy leaves, on the host), the inverse of
    ``flax_to_state_dict``: OIHW -> HWIO, IOHW -> flipped HWIO, and each
    ConvLSTM layer's ``w_x`` (-> HWIO) and ``w_h`` concatenated back into
    the fused ``[3,3,I+H,4H]`` kernel.  ``batch_stats`` is empty for
    norm='group'."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    fused: Dict[Path, Dict[str, np.ndarray]] = {}
    for key, path, convert in _entries(model):
        arr = sd[key]
        if key.endswith((".w_x", ".w_h")):  # two halves of one Flax kernel
            fused.setdefault(path, {})[key.rsplit(".", 1)[1]] = arr
            if len(fused[path]) < 2:
                continue
            halves = fused.pop(path)
            arr = np.concatenate([_conv_inverse(halves["w_x"]), halves["w_h"]], axis=2)
        elif convert is _conv:
            arr = _conv_inverse(arr)
        elif convert is _conv_transpose:
            arr = _conv_transpose_inverse(arr)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr, np.float32)
    return tree


def load_flax_variables(model: Model, variables: Mapping) -> Model:
    """Fill ``model`` in place (its device and dtype kept) from a Flax
    variables tree; returns the model."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model
