"""Python client for the serving daemon (``python -m vad_tpu_torch.serve``):
a copy of the JAX package's stdlib-and-numpy ``vad_tpu/eval/client.py``,
so a producer needs neither JAX nor headers and body framing.  It speaks
the same REST protocol, so it drives either package's daemon:

    from vad_tpu_torch.eval.client import ScoringClient

    c = ScoringClient("localhost", 8600)
    slot = c.attach()                       # claim a video stream slot
    out = c.score_chunk(slot, frames_u8)    # [T, H, W, 3] uint8 -> scores
    c.detach(slot)

    scores = c.score_images(images_u8)      # [N, H, W, 3] uint8 (image model)
    c.reload("results/run/best_model.ckpt") # zero-downtime weight swap
    c.health(); c.metrics()

Responses are the server's dicts (scores, and the calibrated
``threshold`` with per-score ``anomalous`` flags where the checkpoint has
one).  Errors raise ``ScoringError`` with the HTTP status and the server's
message.
"""

from __future__ import annotations

import http.client
import json
from typing import Dict, Optional

import numpy as np


class ScoringError(RuntimeError):
    """Server-reported request failure (HTTP status + server message)."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ScoringClient:
    """One connection-per-request client (the daemon is ThreadingHTTPServer;
    connection reuse buys nothing at chunk-sized request rates and
    per-request connections make the client trivially thread-safe)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8600,
                 timeout: float = 630.0) -> None:
        # default timeout clears the server's 600 s bound on a chunk
        self.host = host
        self.port = port
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None) -> dict:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            # non-JSON body (reverse-proxy error page, stdlib HTML error):
            # still surface the status as the documented ScoringError
            raise ScoringError(resp.status, raw[:200].decode(errors="replace"))
        if resp.status != 200:
            raise ScoringError(resp.status, payload.get("error", str(payload)))
        return payload

    @staticmethod
    def _frames_headers(frames: np.ndarray) -> Dict[str, str]:
        return {"X-Frames-Shape": ",".join(str(int(d)) for d in frames.shape)}

    # ------------------------------------------------------------- streams

    def attach(self) -> int:
        """Claim a video stream slot; returns the slot id."""
        return int(self._request("POST", "/v1/streams")["slot"])

    def detach(self, slot: int) -> None:
        self._request("DELETE", f"/v1/streams/{slot}")

    def score_chunk(self, slot: int, frames: np.ndarray) -> dict:
        """Score one [chunk, H, W, 3] uint8 chunk on an attached stream.

        Returns the response dict: ``scores`` (per-frame), plus
        ``threshold``/``anomalous`` when the served checkpoint carries a
        calibrated threshold.  The stream's ConvLSTM state persists
        between calls — consecutive chunks are one continuous recurrence.
        """
        frames = np.ascontiguousarray(frames, np.uint8)
        return self._request(
            "POST", f"/v1/streams/{slot}/frames", body=frames.tobytes(),
            headers=self._frames_headers(frames),
        )

    # -------------------------------------------------------------- images

    def score_images(self, images: np.ndarray) -> dict:
        """Score [N, H, W, 3] uint8 images on the image model.

        The server chunks oversize batches internally (up to its
        per-request cap); returns ``scores`` plus optional calibrated
        ``threshold``/``anomalous`` flags.
        """
        images = np.ascontiguousarray(images, np.uint8)
        return self._request(
            "POST", "/v1/images", body=images.tobytes(),
            headers=self._frames_headers(images),
        )

    # ---------------------------------------------------------------- ops

    def reload(self, checkpoint: str) -> dict:
        """Hot-swap the served weights from a checkpoint path on the
        SERVER's filesystem; routes by model kind on dual-model daemons."""
        return self._request(
            "POST", "/v1/reload",
            body=json.dumps({"checkpoint": str(checkpoint)}).encode(),
        )

    def health(self) -> dict:
        return self._request("GET", "/v1/health")

    def metrics(self) -> dict:
        return self._request("GET", "/v1/metrics")
