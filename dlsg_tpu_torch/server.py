"""HTTP serving front end over `serve.Captioner` (counterpart of
`dlsg_tpu/server.py`, with the same protocol).

The reference has no serving story at all — its only inference path is the
evaluation loop inside training (run_gun.py:269-281). This module turns a
trained model into a long-lived captioning service: load once, then caption
pre-extracted feature clips over HTTP. Stdlib-only
(`http.server.ThreadingHTTPServer`) — no web-framework dependency.

Protocol
--------
- ``GET /healthz`` -> ``{"status": "ok", "dataset", "device", "device_name",
  "devices", "beam_size", "warm"}``: the torch device the Captioner runs on,
  its name (the card's, or "cpu") and the number of CUDA cards visible
- ``POST /caption`` with either body format:

  * ``application/x-npz`` (or any non-JSON type): an ``.npz`` payload with
    arrays ``frames`` [N, max_frames, feature_size], ``regions``
    [N, max_frames, >=num_obj, region_feature_size], optional ``video_ids``.
  * ``application/json``: ``{"frames": [...], "regions": [...],
    "video_ids": [...]}`` with nested lists.

  Query string: ``?greedy=1`` selects greedy decode (default: beam).
  Response: ``{"captions": [{"video_id": ..., "caption": ...}, ...],
  "latency_s": t}``. Malformed payloads get a 400 with ``{"error": ...}``.

- ``GET /metrics`` -> Prometheus text exposition: ``dlsg_requests_total``,
  ``dlsg_clips_total``, ``dlsg_errors_total``, a request-latency histogram
  (``dlsg_request_latency_seconds``), ``dlsg_uptime_seconds``, ``dlsg_warm``.

Concurrency: request handling threads serialize around the device via one
lock — the card is already batch-parallel inside a single decode call, so
concurrent decodes would only interleave (and fragment) device work. Clients
get throughput by batching clips per request, not by parallel requests.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from dlsg_tpu_torch.serve import Captioner, jsonable_id

# one request must fit comfortably in host memory; 512 MB of features is
# ~6700 MSR-VTT clips — far beyond one decode batch
MAX_BODY_BYTES = 512 * 1024 * 1024


def _parse_body(body: bytes, content_type: str):
    """Decode a /caption payload -> (frames, regions, video_ids|None)."""
    if "json" in content_type:
        obj = json.loads(body.decode("utf-8"))
        frames = np.asarray(obj["frames"], np.float32)
        regions = np.asarray(obj["regions"], np.float32)
        vids = obj.get("video_ids")
        vids = None if vids is None else np.asarray(vids)
    else:
        data = np.load(io.BytesIO(body), allow_pickle=False)
        frames, regions = data["frames"], data["regions"]
        vids = data["video_ids"] if "video_ids" in data else None
    if frames.ndim != 3 or regions.ndim != 4:
        raise ValueError(
            f"frames must be [N,T,F] and regions [N,T,O,R]; got "
            f"{frames.shape} / {regions.shape}"
        )
    if frames.shape[0] != regions.shape[0]:
        raise ValueError(
            f"frames/regions batch mismatch: {frames.shape[0]} vs {regions.shape[0]}"
        )
    if vids is not None and len(vids) != frames.shape[0]:
        raise ValueError(
            f"{frames.shape[0]} clips but {len(vids)} video_ids"
        )
    return frames, regions, vids


# request-latency histogram bucket bounds (seconds); decode latencies span
# tens of milliseconds (warm small bucket) to seconds (a cold first request)
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class CaptionServer(ThreadingHTTPServer):
    """HTTP server bound to one Captioner. `port=0` picks a free port."""

    daemon_threads = True

    def __init__(self, captioner: Captioner, host: str = "0.0.0.0", port: int = 8000):
        self.captioner = captioner
        self.device_lock = threading.Lock()
        self.stats_lock = threading.Lock()
        self.started = time.time()
        self.requests_total = 0
        self.clips_total = 0
        self.errors_total = 0
        self.latency_sum = 0.0
        self.latency_count = 0
        self.latency_hist = [0] * (len(LATENCY_BUCKETS) + 1)  # +1 for +Inf
        super().__init__((host, port), _Handler)

    def record(self, latency: Optional[float], clips: int = 0, error: bool = False):
        with self.stats_lock:
            self.requests_total += 1
            self.clips_total += clips
            self.errors_total += int(error)
            if latency is not None:
                self.latency_sum += latency
                self.latency_count += 1
                for i, le in enumerate(LATENCY_BUCKETS):
                    if latency <= le:
                        self.latency_hist[i] += 1
                        break
                else:
                    self.latency_hist[-1] += 1

    def metrics_text(self) -> str:
        """Prometheus text exposition (cumulative histogram semantics)."""
        with self.stats_lock:
            lines = [
                "# HELP dlsg_requests_total /caption requests handled",
                "# TYPE dlsg_requests_total counter",
                f"dlsg_requests_total {self.requests_total}",
                "# HELP dlsg_clips_total video clips captioned",
                "# TYPE dlsg_clips_total counter",
                f"dlsg_clips_total {self.clips_total}",
                "# HELP dlsg_errors_total /caption requests rejected (4xx)",
                "# TYPE dlsg_errors_total counter",
                f"dlsg_errors_total {self.errors_total}",
                "# HELP dlsg_request_latency_seconds successful decode latency",
                "# TYPE dlsg_request_latency_seconds histogram",
            ]
            cum = 0
            for le, n in zip(LATENCY_BUCKETS, self.latency_hist):
                cum += n
                lines.append(
                    f'dlsg_request_latency_seconds_bucket{{le="{le}"}} {cum}'
                )
            cum += self.latency_hist[-1]
            lines.append(f'dlsg_request_latency_seconds_bucket{{le="+Inf"}} {cum}')
            lines.append(f"dlsg_request_latency_seconds_sum {self.latency_sum}")
            lines.append(f"dlsg_request_latency_seconds_count {self.latency_count}")
            lines += [
                "# HELP dlsg_uptime_seconds seconds since server start",
                "# TYPE dlsg_uptime_seconds gauge",
                f"dlsg_uptime_seconds {time.time() - self.started:.1f}",
                "# HELP dlsg_warm 1 when every decode bucket has been run once",
                "# TYPE dlsg_warm gauge",
                f"dlsg_warm {int(self.captioner.warm)}",
            ]
        return "\n".join(lines) + "\n"

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class _Handler(BaseHTTPRequestHandler):
    server: CaptionServer

    def log_message(self, fmt, *args):  # quiet by default; stderr is for errors
        pass

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/metrics":
            body = self.server.metrics_text().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path != "/healthz":
            return self._send(404, {"error": f"unknown path {self.path}"})
        cap = self.server.captioner
        dev = cap.device
        self._send(200, {
            "status": "ok",
            "dataset": cap.cfg.dataset,
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "devices": torch.cuda.device_count(),
            "beam_size": cap.cfg.beam_size,
            "warm": cap.warm,
        })

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path != "/caption":
            return self._send(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if not 0 < n <= MAX_BODY_BYTES:
                self.server.record(None, error=True)
                return self._send(413 if n > MAX_BODY_BYTES else 400,
                                  {"error": f"bad Content-Length {n}"})
            body = self.rfile.read(n)
            frames, regions, vids = _parse_body(
                body, self.headers.get("Content-Type", "")
            )
        except Exception as e:  # noqa: BLE001 - malformed client payload -> 400
            self.server.record(None, error=True)
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})
        cfg = self.server.captioner.cfg
        if (
            frames.shape[1:] != (cfg.max_frames, cfg.feature_size)
            or regions.shape[1] != cfg.max_frames
            or regions.shape[2] < cfg.num_obj
            or regions.shape[3] != cfg.region_feature_size
        ):
            self.server.record(None, error=True)
            return self._send(400, {
                "error": "feature dims mismatch: expected frames "
                f"[N,{cfg.max_frames},{cfg.feature_size}] and regions "
                f"[N,{cfg.max_frames},>={cfg.num_obj},"
                f"{cfg.region_feature_size}]; got {frames.shape} / "
                f"{regions.shape}"
            })
        if vids is None:
            vids = np.arange(frames.shape[0])
        greedy = "greedy=1" in query or "greedy=true" in query
        t0 = time.perf_counter()
        try:
            with self.server.device_lock:
                sentences = self.server.captioner.caption(
                    frames, regions, greedy=greedy
                )
        except Exception as e:  # noqa: BLE001 - surface decode failures as 500
            self.server.record(None, error=True)
            return self._send(500, {"error": f"decode failed: {type(e).__name__}: {e}"})
        latency = time.perf_counter() - t0
        self.server.record(latency, clips=len(sentences))
        self._send(200, {
            "captions": [
                {"video_id": jsonable_id(v), "caption": s}
                for v, s in zip(vids, sentences)
            ],
            "latency_s": round(latency, 4),
        })
