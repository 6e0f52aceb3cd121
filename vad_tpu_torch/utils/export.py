"""Ahead-of-time scoring-step export: ``torch.export`` serving artifacts
(the JAX package's ``vad_tpu/utils/export.py``).

``torch.export`` traces the scoring step into an ATen graph with the
trained weights baked in as the program's state, and ``torch.export.save``
writes it as one ``.pt2`` file that a PyTorch process loads and calls
without the model's Python classes.  Two artifacts cover both serving paths,
with the JAX package's calling conventions:

- **image scorer**: uint8 ``[B, H, W, 3]`` -> float32 ``[B]`` anomaly
  scores.  ``batch=None`` exports a symbolic batch dimension
  (``torch.export.Dim("b", min=1, max=MAX_BATCH)``), so one artifact
  serves any request size; an int pins it, and the loaded program rejects
  any other.
- **video stream step**: ``scores, states = call(frames_u8 [S, T, H, W, 3],
  states, submitted bool [S])``, ``states`` the per-layer ConvLSTM carry
  ``((h0, c0), (h1, c1), ...)``, each f32 ``[S, H/16, W/16, hidden]``
  (start from zeros), ``scores`` f32 ``[S, T]``.  Only submitting slots
  advance their carried (h, c); the others keep it bit for bit, as in
  ``MultiStreamScorer``.

The recurrence is one graph node a layer: the operator
``torch.ops.vad_tpu_torch.convlstm_recurrence`` (``ops/convlstm.py``), whose
CUDA implementation is kernel 1 and whose CPU implementation is its plain
version.  So one artifact runs kernel 1 on the card and still loads on the
CPU (``platforms`` names ``cuda`` and ``cpu``; a TPU artifact comes from the
JAX package).  Loading needs ``vad_tpu_torch``'s operators registered:
``load_artifact`` imports them first.  JAX's StableHLO artifact needs no
package; this one needs the port's ops (ROADMAP Queue 3, by design).

Precision: a bf16 export casts every floating weight and the BatchNorm
statistics to bf16 (JAX's ``cast_floating`` over all variables, the
serving scorer's ``model.to(dtype)``), normalizes the input in bf16 and
returns f32 scores.  An f32 artifact loaded on the card turns TF32 off for
the process (cuDNN's convolutions default to it), as the f32 daemon does.
"""

from __future__ import annotations

import copy
import io
import json
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from vad_tpu_torch.core.device import resolve_device

ARTIFACT_SUFFIX = ".pt2"
_META_FILE = "vad_tpu_torch.json"  # fn_name, platforms and dtype inside the .pt2
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MAX_BATCH = 65535  # a symbolic image batch's bound: CUDA kernels' grid limit


def _platform_list(platforms: Optional[Sequence[str]]) -> Optional[List[str]]:
    """Validated device types (``gpu`` is ``cuda``), in order, without
    repeats; None for none given."""
    if platforms is None:
        return None
    out: List[str] = []
    for name in (str(p).lower() for p in platforms):
        if name == "tpu":
            raise ValueError("the PyTorch port exports for 'cuda' (or 'gpu') and 'cpu'; "
                             "a TPU artifact comes from the JAX package "
                             "(python export_model.py --platforms tpu)")
        if name not in _PLATFORMS:
            raise ValueError(f"unknown platform {name!r}; expected 'cuda', 'gpu' or 'cpu'")
        if _PLATFORMS[name] not in out:
            out.append(_PLATFORMS[name])
    return out or None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _aval(value: Any) -> str:
    """A tensor's type and shape as ``uint8[s0,64,64,3]`` (a symbolic
    dimension by its symbol)."""
    return f"{_dtype_name(value.dtype)}[{','.join(str(d) for d in value.shape)}]"


class Exported:
    """A ``torch.export`` program with the JAX ``Exported``'s surface:
    ``call(*args)``, ``fn_name``, ``platforms``, ``in_avals``,
    ``out_avals``; ``program`` is the ``ExportedProgram``.  ``call`` takes
    tensors on the program's device or numpy arrays (copied there)."""

    def __init__(self, program: torch.export.ExportedProgram, fn_name: str,
                 platforms: Sequence[str], dtype: str) -> None:
        program.example_inputs = None  # the tracing zeros: 59 MB of a video artifact
        self.program, self.fn_name = program, fn_name
        self.platforms, self.dtype = list(platforms), dtype
        self._module = program.module()

    @property
    def device(self) -> torch.device:
        for value in self.program.state_dict.values():
            return value.device
        return torch.device("cpu")

    def _values(self, kind: str) -> List[Any]:
        if kind == "in":
            names = set(self.program.graph_signature.user_inputs)
            return [n.meta["val"] for n in self.program.graph.nodes
                    if n.op == "placeholder" and n.name in names]
        out = next(n for n in self.program.graph.nodes if n.op == "output")
        n_user = len(self.program.graph_signature.user_outputs)
        return [a.meta["val"] for a in out.args[0][-n_user:]]

    @property
    def in_avals(self) -> List[str]:
        return [_aval(v) for v in self._values("in")]

    @property
    def out_avals(self) -> List[str]:
        return [_aval(v) for v in self._values("out")]

    @property
    def uses_shape_polymorphism(self) -> bool:
        """From the input shapes, as the JAX package reads its avals."""
        return any(not isinstance(d, int) for v in self._values("in") for d in v.shape)

    def zero_inputs(self) -> tuple:
        """Zero arguments of the program's input shapes (a symbolic
        dimension at 1) on its device."""
        zeros = [torch.zeros([d if isinstance(d, int) else 1 for d in v.shape], dtype=v.dtype,
                             device=self.device) for v in self._values("in")]
        args, _ = pytree.tree_unflatten(zeros, self.program.call_spec.in_spec)
        return tuple(args)

    def call(self, *args):
        device = self.device
        args = pytree.tree_map_only(np.ndarray, lambda a: torch.as_tensor(a, device=device),
                                    args)
        with torch.no_grad():
            return self._module(*args)


def _serving_copy(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An eval-mode copy of ``model`` whose floating weights and BatchNorm
    statistics are in ``dtype`` and need no gradient (so the recurrence is
    the kernel-1 operator, not the autograd Function)."""
    model = copy.deepcopy(model).eval()
    if dtype != torch.float32:
        model = model.to(dtype)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


class _ImageStep(nn.Module):
    def __init__(self, model: nn.Module, dtype: torch.dtype) -> None:
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, u8: torch.Tensor) -> torch.Tensor:
        x = u8.to(self.dtype) / 127.5 - 1.0
        return self.model.reconstruction_error(x).float()


class _VideoStep(nn.Module):
    def __init__(self, model: nn.Module, dtype: torch.dtype) -> None:
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, u8: torch.Tensor, states, submitted: torch.Tensor):
        x = u8.to(self.dtype) / 127.5 - 1.0
        _, _, scores, new_states = self.model.stream_step(x, states)
        keep = submitted.reshape(-1, 1, 1, 1)
        out_states = tuple(
            (torch.where(keep, h_new, h_old), torch.where(keep, c_new, c_old))
            for (h_new, c_new), (h_old, c_old) in zip(new_states, states))
        return scores.float(), out_states


def _hw(image_size) -> tuple:
    return (tuple(image_size) if isinstance(image_size, (tuple, list))
            else (image_size, image_size))


def export_image_scorer(model: nn.Module, image_size, batch: Optional[int] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        platforms: Optional[Sequence[str]] = None) -> Exported:
    """Export the stateless image scoring step of a ``ConvAutoencoder`` on
    its device.  ``batch=None``: a symbolic batch dimension (any request
    size, 1 included); an int pins it.  ``platforms`` are recorded as the
    artifact's targets (default: the model's device type)."""
    targets = _platform_list(platforms) or [model.device.type]
    hw = _hw(image_size)
    step = _ImageStep(_serving_copy(model, dtype), dtype)
    example = torch.zeros((2 if batch is None else batch, *hw, 3), dtype=torch.uint8,
                          device=model.device)
    if batch is not None:
        with torch.no_grad():
            program = torch.export.export(step, (example,))
    else:
        dynamic = ({0: torch.export.Dim("b", min=1, max=MAX_BATCH)},)
        with torch.no_grad():
            program = torch.export.export(step, (example,), dynamic_shapes=dynamic)
    return Exported(program, "image_score", targets, _dtype_name(dtype))


def export_video_stream_step(model: nn.Module, num_slots: int = 16, chunk: int = 16,
                             image_size=256, dtype: torch.dtype = torch.bfloat16,
                             platforms: Optional[Sequence[str]] = None) -> Exported:
    """Export the state-carrying multi-stream video scoring step of a
    ``VideoAutoencoder`` on its device (calling convention in the module
    docstring: ``scores, states = call(frames_u8, states, submitted)``)."""
    targets = _platform_list(platforms) or [model.device.type]
    hw = _hw(image_size)
    if hw[0] % 16 or hw[1] % 16:
        raise ValueError(f"image size {hw} must be divisible by 16")
    device = model.device
    step = _VideoStep(_serving_copy(model, dtype), dtype)
    example = (torch.zeros((num_slots, chunk, *hw, 3), dtype=torch.uint8, device=device),
               model.zero_state(num_slots, *hw),
               torch.ones(num_slots, dtype=torch.bool, device=device))
    with torch.no_grad():
        program = torch.export.export(step, example)
    return Exported(program, "video_stream_step", targets, _dtype_name(dtype))


def _schema_version() -> List[int]:
    from torch._export.serde.schema import SCHEMA_VERSION

    return list(SCHEMA_VERSION)


def _serialize(exported: Exported) -> bytes:
    buf = io.BytesIO()
    meta = {"fn_name": exported.fn_name, "platforms": exported.platforms,
            "dtype": exported.dtype}
    torch.export.save(exported.program, buf, extra_files={_META_FILE: json.dumps(meta)})
    return buf.getvalue()


def save_artifact(exported: Exported, path, meta: Optional[dict] = None) -> Path:
    """Write ``exported`` to ``path`` (``torch.export.save``'s ``.pt2``,
    atomically through a ``.tmp`` file) and a JSON sidecar ``path +
    '.json'`` with the JAX package's keys and ``meta``."""
    return _write(_serialize(exported), exported, path, meta)


def _write(data: bytes, exported: Exported, path, meta: Optional[dict]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(path)
    sidecar = {
        "fn_name": exported.fn_name,
        "platforms": list(exported.platforms),
        "in_avals": exported.in_avals,
        "out_avals": exported.out_avals,
        "calling_convention_version": _schema_version(),
        "uses_shape_polymorphism": exported.uses_shape_polymorphism,
        "bytes": len(data),
        **(meta or {}),
    }
    path.with_name(path.name + ".json").write_text(json.dumps(sidecar, indent=2) + "\n")
    return path


def _deserialize(source, device, f32_process: bool = True) -> Exported:
    from torch.export.passes import move_to_device_pass

    import vad_tpu_torch.ops.convlstm  # noqa: F401  (registers the recurrence operator)

    extra = {_META_FILE: ""}
    program = torch.export.load(source, extra_files=extra)
    meta = json.loads(extra[_META_FILE] or "{}")
    dev = resolve_device(device)
    program = move_to_device_pass(program, dev)
    dtype = meta.get("dtype", "float32")
    if f32_process and dtype == "float32" and dev.type == "cuda":
        # f32 means f32 for the process, as the f32 daemon scores: cuDNN's
        # convolutions default to TF32 and the flags are process-wide
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return Exported(program, meta.get("fn_name", "forward"), [dev.type], dtype)


def load_artifact(path, device=None) -> Exported:
    """Load a saved artifact onto ``device`` (``None`` means CUDA) as an
    ``Exported``; the port's operators are registered first."""
    return _deserialize(str(path), device)


def export_from_checkpoint(
    checkpoint,
    output,
    *,
    batch: Optional[int] = None,
    num_slots: int = 16,
    chunk: int = 16,
    dtype: str = "bfloat16",
    platforms: Optional[Sequence[str]] = None,
    device=None,
) -> Path:
    """Build the artifact for a checkpoint of either package (image or
    video; the architecture from its ``args``) on ``device`` (``None``
    means CUDA), call it once on each of ``platforms`` (default: that
    device's type) from the serialized bytes, and write it to ``output``.
    The sidecar's ``platforms`` are those calls'."""
    from vad_tpu_torch.core.config import ImageAEConfig, VideoAEConfig
    from vad_tpu_torch.models.autoencoder import ConvAutoencoder
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
    from vad_tpu_torch.utils.checkpoint import load_checkpoint
    from vad_tpu_torch.utils.weights import load_flax_variables

    dev = resolve_device(device)
    targets = _platform_list(platforms) or [dev.type]
    ckpt = load_checkpoint(checkpoint)
    variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    tdtype = DTYPES[dtype]
    if ckpt.get("model_type") == "image":
        cfg = ImageAEConfig.from_args(ckpt.get("args", {}))
        model = load_flax_variables(ConvAutoencoder.from_config(cfg, device=dev), variables)
        exported = export_image_scorer(model, cfg.image_size, batch=batch, dtype=tdtype,
                                       platforms=targets)
        meta = {"kind": "image", "image_size": cfg.image_size, "batch": batch,
                "dtype": dtype}
    else:
        cfg = VideoAEConfig.from_args(ckpt.get("args", {}))
        model = load_flax_variables(VideoAutoencoder.from_config(cfg, device=dev), variables)
        exported = export_video_stream_step(model, num_slots=num_slots, chunk=chunk,
                                            image_size=cfg.image_size, dtype=tdtype,
                                            platforms=targets)
        meta = {"kind": "video", "image_size": cfg.image_size, "num_slots": num_slots,
                "chunk": chunk, "dtype": dtype,
                "state_contract": "only submitted slots advance (h, c)"}
    data = _serialize(exported)
    for target in targets:  # each target runs the artifact once before it is written
        loaded = _deserialize(io.BytesIO(data), target, f32_process=False)
        loaded.call(*loaded.zero_inputs())
    meta["checkpoint"] = str(checkpoint)
    thr = (ckpt.get("score_threshold") if meta["kind"] == "image"
           else ckpt.get("frame_score_threshold"))
    if thr is not None:
        meta["score_threshold"] = float(thr)
    return _write(data, exported, output, meta)
