"""Reference (PyTorch) checkpoints into the port's ``.ckpt`` and back (the
JAX package's ``vad_tpu/utils/torch_import.py``).

A user of the reference brings their trained ``best_model.pth``:

    python -m vad_tpu_torch.utils.torch_import --checkpoint best_model.pth \\
        --out best_model.ckpt

and ``--export`` writes a ``.ckpt`` of either package back as a ``.pth``
that the reference loads with ``strict=True``.  The ``.ckpt`` holds the
JAX package's variables tree (so both packages serve it), mapped from the
reference's module names (models/autoencoder.py: ``encoder.enc1..enc4`` /
``decoder.dec1..dec4``; models/video_autoencoder.py: ``encoder.encoder.N``
/ ``convlstm.cells.K.conv`` / ``proj`` / ``decoder.decoder.N``) with the
JAX package's layout conversions:

- Conv2d weight ``[O, I, kh, kw]`` -> ``[kh, kw, I, O]``;
- ConvTranspose2d weight ``[I, O, kh, kw]`` -> ``[kh, kw, I, O]`` with both
  spatial dims flipped (Flax's ConvTranspose is a fractionally-strided
  convolution, torch's the conv gradient);
- BatchNorm weight/bias -> scale/bias params, running_mean/var ->
  batch_stats;
- the fused ConvLSTM gate conv ``[4H, I+H, k, k]`` -> kernel ``[k, k, I+H,
  4H]`` (the same i, f, g, o gate order).

The port's own modules sit one bridge further (``utils/weights.py``):
``reference_state_dict_to_port`` and ``port_to_reference_state_dict`` go
through the variables tree, so the ConvLSTM's fused gate conv splits into
the port's ``w_x [4H, I, 3, 3]`` and ``w_h [3, 3, H, 4H]`` and back, and a
reference ConvTranspose weight reaches the port's ``ConvTranspose2d``
unchanged (the two flips cancel: both are torch's layer).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _conv_kernel(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def _convT_kernel(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 0, 1))[::-1, ::-1])


def _bn(sd: Mapping, prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _conv(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _conv_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _convT(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _convT_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def import_image_state_dict(sd: Mapping) -> Tuple[Dict, Dict]:
    """Reference ConvAutoencoder state_dict -> (params, batch_stats)."""
    params: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    stats: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    # encoder: enc1..enc4, each Sequential [Conv,BN,LReLU,Conv,BN,LReLU,Pool]
    for i in range(4):
        blk_p: Dict[str, Any] = {}
        blk_s: Dict[str, Any] = {}
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            blk_p[f"Conv_{j}"] = _conv(sd, f"encoder.enc{i + 1}.{ci}")
            blk_p[f"BatchNorm_{j}"], blk_s[f"BatchNorm_{j}"] = _bn(sd, f"encoder.enc{i + 1}.{bi}")
        params["encoder"][f"EncoderBlock_{i}"] = blk_p
        stats["encoder"][f"EncoderBlock_{i}"] = blk_s
    # decoder blocks dec1..dec3: Sequential [ConvT,BN,ReLU,Conv,BN,ReLU]
    for i in range(3):
        blk_p = {"ConvTranspose_0": _convT(sd, f"decoder.dec{i + 1}.0")}
        blk_s = {}
        blk_p["BatchNorm_0"], blk_s["BatchNorm_0"] = _bn(sd, f"decoder.dec{i + 1}.1")
        blk_p["Conv_0"] = _conv(sd, f"decoder.dec{i + 1}.3")
        blk_p["BatchNorm_1"], blk_s["BatchNorm_1"] = _bn(sd, f"decoder.dec{i + 1}.4")
        params["decoder"][f"DecoderBlock_{i}"] = blk_p
        stats["decoder"][f"DecoderBlock_{i}"] = blk_s
    # final block dec4: [ConvT,BN,ReLU,Conv,Tanh]
    params["decoder"]["ConvTranspose_0"] = _convT(sd, "decoder.dec4.0")
    params["decoder"]["BatchNorm_0"], stats["decoder"]["BatchNorm_0"] = _bn(sd, "decoder.dec4.1")
    params["decoder"]["Conv_0"] = _conv(sd, "decoder.dec4.3")
    return params, stats


def import_video_state_dict(sd: Mapping) -> Tuple[Dict, Dict]:
    """Reference VideoAutoencoder state_dict -> (params, batch_stats)."""
    params: Dict[str, Any] = {"encoder": {}, "convlstm": {}, "decoder": {}}
    stats: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    # encoder Sequential: [Conv,BN,LReLU,Pool] x4 -> conv 0,4,8,12; bn 1,5,9,13
    for i in range(4):
        params["encoder"][f"Conv_{i}"] = _conv(sd, f"encoder.encoder.{4 * i}")
        params["encoder"][f"BatchNorm_{i}"], stats["encoder"][f"BatchNorm_{i}"] = _bn(
            sd, f"encoder.encoder.{4 * i + 1}")
    # ConvLSTM cells: fused gate conv [4H, I+H, k, k]
    layer = 0
    while f"convlstm.cells.{layer}.conv.weight" in sd:
        params["convlstm"][f"ConvLSTMLayer_{layer}"] = {
            "kernel": _conv_kernel(sd[f"convlstm.cells.{layer}.conv.weight"]),
            "bias": _np(sd[f"convlstm.cells.{layer}.conv.bias"]),
        }
        layer += 1
    if "proj.weight" in sd:  # 1x1 projection (only when hidden != latent)
        params["proj"] = _conv(sd, "proj")
    # decoder Sequential: [ConvT,BN,ReLU] x3 + [ConvT,Tanh]
    for i in range(3):
        params["decoder"][f"ConvTranspose_{i}"] = _convT(sd, f"decoder.decoder.{3 * i}")
        params["decoder"][f"BatchNorm_{i}"], stats["decoder"][f"BatchNorm_{i}"] = _bn(
            sd, f"decoder.decoder.{3 * i + 1}")
    params["decoder"]["ConvTranspose_3"] = _convT(sd, "decoder.decoder.9")
    return params, stats


def detect_model_type(sd: Mapping) -> str:
    return "video" if any(k.startswith("convlstm.") for k in sd) else "image"


def load_reference(path: str | Path) -> Dict[str, Any]:
    """A reference checkpoint file as a dict (tensors only: ``weights_only``)."""
    return torch.load(str(path), map_location="cpu", weights_only=True)


def import_torch_checkpoint(checkpoint: str | Path | Mapping) -> Dict[str, Any]:
    """Full reference checkpoint (path or loaded dict) -> a ``.ckpt`` payload."""
    if isinstance(checkpoint, (str, Path)):
        checkpoint = load_reference(checkpoint)
    sd = checkpoint.get("model_state_dict", checkpoint)
    model_type = detect_model_type(sd)
    importer = import_video_state_dict if model_type == "video" else import_image_state_dict
    params, batch_stats = importer(sd)
    return {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": None,  # torch Adam moments are not transferable
        "epoch": checkpoint.get("epoch"),
        "train_loss": checkpoint.get("train_loss"),
        "val_loss": checkpoint.get("val_loss"),
        "separation": checkpoint.get("separation"),
        "history": checkpoint.get("history"),
        "args": dict(checkpoint.get("args", {}) or {}),
        "model_type": model_type,
        "imported_from": "pytorch",
    }


# ------------------------------------------------------------- export


def _conv_kernel_to_torch(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))  # HWIO -> OIHW


def _convT_kernel_to_torch(k) -> np.ndarray:
    # invert _convT_kernel: unflip spatial, HWIO -> IOHW
    return np.ascontiguousarray(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def _export_bn(params: Mapping, stats: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(params["scale"])
    out[f"{prefix}.bias"] = np.asarray(params["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
    out[f"{prefix}.running_var"] = np.asarray(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _require_batch_stats(stats: Mapping) -> None:
    if not stats:
        raise ValueError("checkpoint has no batch_stats — models trained with --norm group "
                         "cannot map onto the reference's BatchNorm layers")


def export_image_state_dict(params: Mapping, stats: Mapping) -> dict:
    """(params, batch_stats) -> reference-named state_dict arrays."""
    _require_batch_stats(stats)
    out: dict = {}
    for i in range(4):
        blk_p = params["encoder"][f"EncoderBlock_{i}"]
        blk_s = stats["encoder"][f"EncoderBlock_{i}"]
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            out[f"encoder.enc{i + 1}.{ci}.weight"] = _conv_kernel_to_torch(
                blk_p[f"Conv_{j}"]["kernel"])
            out[f"encoder.enc{i + 1}.{ci}.bias"] = np.asarray(blk_p[f"Conv_{j}"]["bias"])
            _export_bn(blk_p[f"BatchNorm_{j}"], blk_s[f"BatchNorm_{j}"],
                       f"encoder.enc{i + 1}.{bi}", out)
    for i in range(3):
        blk_p = params["decoder"][f"DecoderBlock_{i}"]
        blk_s = stats["decoder"][f"DecoderBlock_{i}"]
        out[f"decoder.dec{i + 1}.0.weight"] = _convT_kernel_to_torch(
            blk_p["ConvTranspose_0"]["kernel"])
        out[f"decoder.dec{i + 1}.0.bias"] = np.asarray(blk_p["ConvTranspose_0"]["bias"])
        _export_bn(blk_p["BatchNorm_0"], blk_s["BatchNorm_0"], f"decoder.dec{i + 1}.1", out)
        out[f"decoder.dec{i + 1}.3.weight"] = _conv_kernel_to_torch(blk_p["Conv_0"]["kernel"])
        out[f"decoder.dec{i + 1}.3.bias"] = np.asarray(blk_p["Conv_0"]["bias"])
        _export_bn(blk_p["BatchNorm_1"], blk_s["BatchNorm_1"], f"decoder.dec{i + 1}.4", out)
    dec = params["decoder"]
    out["decoder.dec4.0.weight"] = _convT_kernel_to_torch(dec["ConvTranspose_0"]["kernel"])
    out["decoder.dec4.0.bias"] = np.asarray(dec["ConvTranspose_0"]["bias"])
    _export_bn(dec["BatchNorm_0"], stats["decoder"]["BatchNorm_0"], "decoder.dec4.1", out)
    out["decoder.dec4.3.weight"] = _conv_kernel_to_torch(dec["Conv_0"]["kernel"])
    out["decoder.dec4.3.bias"] = np.asarray(dec["Conv_0"]["bias"])
    return out


def export_video_state_dict(params: Mapping, stats: Mapping) -> dict:
    """(params, batch_stats) -> reference-named state_dict arrays: the
    module names of the reference's models/video_autoencoder.py
    (``encoder.encoder.N``, ``convlstm.cells.K.conv``, optional ``proj``,
    ``decoder.decoder.N``), so the result loads with ``strict=True``."""
    _require_batch_stats(stats)
    out: dict = {}
    for i in range(4):
        conv = params["encoder"][f"Conv_{i}"]
        out[f"encoder.encoder.{4 * i}.weight"] = _conv_kernel_to_torch(conv["kernel"])
        out[f"encoder.encoder.{4 * i}.bias"] = np.asarray(conv["bias"])
        _export_bn(params["encoder"][f"BatchNorm_{i}"], stats["encoder"][f"BatchNorm_{i}"],
                   f"encoder.encoder.{4 * i + 1}", out)
    layer = 0
    while f"ConvLSTMLayer_{layer}" in params["convlstm"]:
        cell = params["convlstm"][f"ConvLSTMLayer_{layer}"]
        out[f"convlstm.cells.{layer}.conv.weight"] = _conv_kernel_to_torch(cell["kernel"])
        out[f"convlstm.cells.{layer}.conv.bias"] = np.asarray(cell["bias"])
        layer += 1
    if "proj" in params:  # 1x1 projection (only when hidden != latent)
        out["proj.weight"] = _conv_kernel_to_torch(params["proj"]["kernel"])
        out["proj.bias"] = np.asarray(params["proj"]["bias"])
    for i in range(3):
        deconv = params["decoder"][f"ConvTranspose_{i}"]
        out[f"decoder.decoder.{3 * i}.weight"] = _convT_kernel_to_torch(deconv["kernel"])
        out[f"decoder.decoder.{3 * i}.bias"] = np.asarray(deconv["bias"])
        _export_bn(params["decoder"][f"BatchNorm_{i}"], stats["decoder"][f"BatchNorm_{i}"],
                   f"decoder.decoder.{3 * i + 1}", out)
    out["decoder.decoder.9.weight"] = _convT_kernel_to_torch(
        params["decoder"]["ConvTranspose_3"]["kernel"])
    out["decoder.decoder.9.bias"] = np.asarray(params["decoder"]["ConvTranspose_3"]["bias"])
    return out


def _tensors(arrays: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in arrays.items()}


# ------------------------------------------- the port's modules, both ways


def port_model_for(sd: Mapping, device="cpu"):
    """A port model (batch norm, pool stem) shaped like a reference
    state_dict: its input, latent and ConvLSTM widths read from the
    weights."""
    if detect_model_type(sd) == "video":
        layers = 0
        while f"convlstm.cells.{layers}.conv.weight" in sd:
            layers += 1
        return VideoAutoencoder(
            in_channels=sd["encoder.encoder.0.weight"].shape[1],
            latent_dim=sd["encoder.encoder.12.weight"].shape[0],
            lstm_hidden_dim=sd["convlstm.cells.0.conv.weight"].shape[0] // 4,
            lstm_layers=layers, device=device)
    return ConvAutoencoder(in_channels=sd["encoder.enc1.0.weight"].shape[1],
                           latent_dim=sd["encoder.enc4.3.weight"].shape[0], device=device)


def reference_state_dict_to_port(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference state_dict (either family) as the port's ``state_dict``
    (f32 CPU tensors; loads with ``strict=True`` into ``port_model_for(sd)``):
    the reference names to the variables tree, then the port's bridge."""
    sd = sd.get("model_state_dict", sd)
    importer = (import_video_state_dict if detect_model_type(sd) == "video"
                else import_image_state_dict)
    params, stats = importer(sd)
    return flax_to_state_dict(port_model_for(sd), {"params": params, "batch_stats": stats})


def port_to_reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """A port model's weights under the reference's module names (CPU
    tensors; loads with ``strict=True`` into the reference's module)."""
    tree = state_dict_to_flax(model)
    exporter = (export_video_state_dict if isinstance(model, VideoAutoencoder)
                else export_image_state_dict)
    return _tensors(exporter(tree["params"], tree["batch_stats"]))


def export_torch_checkpoint(checkpoint_path: str | Path, out_path: str | Path) -> None:
    """A ``.ckpt`` of either package -> a ``.pth`` the reference loads (both
    families), with the reference's checkpoint schema (epoch,
    model_state_dict, losses, separation, args), so its evaluators rebuild
    the model from ``args``."""
    from vad_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(checkpoint_path)
    is_video = "convlstm" in ckpt["params"]
    exporter = export_video_state_dict if is_video else export_image_state_dict
    payload = {
        "epoch": ckpt.get("epoch"),
        "model_state_dict": _tensors(exporter(ckpt["params"], ckpt.get("batch_stats") or {})),
        "train_loss": ckpt.get("train_loss"),
        "val_loss": ckpt.get("val_loss"),
        "args": ckpt.get("args", {}),
    }
    if is_video:
        for key in ("separation", "normal_err", "anomaly_err", "history"):
            if ckpt.get(key) is not None:
                payload[key] = ckpt[key]
    torch.save(payload, str(out_path))


def check_on_device(sd: Mapping, device) -> None:
    """Load a reference state_dict's weights into the port's model on
    ``device`` with ``strict=True`` (raises on any missing, extra or
    misshapen weight)."""
    model = port_model_for(sd, device)
    model.load_state_dict(reference_state_dict_to_port(sd), strict=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert checkpoints between the port and the torch reference")
    parser.add_argument("--checkpoint", required=True, help="input checkpoint (.pth or .ckpt)")
    parser.add_argument("--out", required=True, help="output path (.ckpt or .pth)")
    parser.add_argument("--export", action="store_true",
                        help="convert a .ckpt to a torch .pth (default: import .pth -> .ckpt)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device on which the port's model takes the converted "
                             "weights (strict) before they are written: cuda or cpu")
    args = parser.parse_args(argv)
    from vad_tpu_torch.core.device import resolve_device
    from vad_tpu_torch.utils.checkpoint import save_checkpoint

    device = resolve_device(args.device)
    if args.export:
        export_torch_checkpoint(args.checkpoint, args.out)
        check_on_device(load_reference(args.out)["model_state_dict"], device)
        print(f"Exported checkpoint -> {args.out}")
        return
    reference = load_reference(args.checkpoint)
    check_on_device(reference.get("model_state_dict", reference), device)
    payload = import_torch_checkpoint(reference)
    save_checkpoint(args.out, payload)
    print(f"Imported {payload['model_type']} checkpoint -> {args.out}")


if __name__ == "__main__":
    main()
