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
  "devices", "beam_size", "warm", "world", "mesh"}``: the torch device the
  Captioner runs on, its name (the card's, or "cpu"), the number of CUDA
  cards visible, the number of ranks serving and the Captioner's mesh
  (``{"data": n, "model": m}``)
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

Several cards (one process each, a Captioner with `mesh=` on every rank):
the JAX package serves its whole mesh from one process; here the leader
(rank 0) runs the CaptionServer and every other rank runs `follow`. For each
request the leader broadcasts a header (the arrays' shapes and the greedy
flag), then the frames and regions, and every rank runs `caption` on them
(each decodes its data block; the ids are gathered). `server_close` on the
leader broadcasts a stop header, which ends every `follow`. `/healthz` also
reports the world size and the mesh.
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

from dlsg_tpu_torch.parallel import dist
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


_STOP, _CAPTION = 0, 1
_HEADER = 9  # op, greedy, frames [N, T, F], regions [N, T, O, R]


def _send_request(op: int, frames=None, regions=None, greedy: bool = False) -> None:
    """The leader's half of one request to the followers."""
    header = np.zeros(_HEADER, np.int64)
    header[0], header[1] = op, int(greedy)
    if op == _CAPTION:
        header[2:5], header[5:9] = frames.shape, regions.shape
    dist.broadcast_from_leader(torch.from_numpy(header))
    if op == _CAPTION:
        dist.broadcast_from_leader(torch.from_numpy(np.ascontiguousarray(frames, np.float32)))
        dist.broadcast_from_leader(torch.from_numpy(np.ascontiguousarray(regions, np.float32)))


def follow(captioner: Captioner) -> int:
    """The loop of a rank other than the leader's: receive each request
    the leader broadcasts, caption it with the other ranks, until the stop
    header. Returns the number of requests served."""
    served = 0
    while True:
        header = dist.broadcast_from_leader(torch.zeros(_HEADER, dtype=torch.int64)).numpy()
        if header[0] == _STOP:
            return served
        frames, regions = (dist.broadcast_from_leader(torch.empty(tuple(shape), dtype=torch.float32))
                           .numpy() for shape in (header[2:5], header[5:9]))
        captioner.caption(frames, regions, greedy=bool(header[1]))
        served += 1


# request-latency histogram bucket bounds (seconds); decode latencies span
# tens of milliseconds (warm small bucket) to seconds (a cold first request)
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class CaptionServer(ThreadingHTTPServer):
    """HTTP server bound to one Captioner. `port=0` picks a free port.
    Inside a process group it runs on the leader, with `follow` on every
    other rank (module doc)."""

    daemon_threads = True

    def __init__(self, captioner: Captioner, host: str = "0.0.0.0", port: int = 8000):
        self.captioner = captioner
        self.group_size = dist.world_size()
        if self.group_size > 1 and not dist.is_leader():
            raise RuntimeError("CaptionServer runs on the leader; other ranks run server.follow")
        self._stopped = False
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

    def caption(self, frames, regions, greedy: bool = False):
        """`captioner.caption`, with the followers fed first (module doc).
        Call it under `device_lock`."""
        if self.group_size > 1:
            _send_request(_CAPTION, frames, regions, greedy)
        return self.captioner.caption(frames, regions, greedy=greedy)

    def server_close(self) -> None:
        """Close the socket; inside a process group, stop the followers."""
        with self.device_lock:
            if self.group_size > 1 and not self._stopped:
                _send_request(_STOP)
            self._stopped = True
        super().server_close()

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
            "world": self.server.group_size,
            "mesh": ({"data": cap.mesh.n_data, "model": cap.mesh.n_model}
                     if cap.mesh is not None else {"data": 1, "model": 1}),
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
                sentences = self.server.caption(frames, regions, greedy=greedy)
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
