"""dlsg_tpu_torch's HTTP captioning service (`server.py`) on the CPU: the
cases of tests/test_server.py against the port's CaptionServer, and the same
requests answered alike by dlsg_tpu's CaptionServer over the same weights
(captions equal as strings, ids passed through alike)."""

import concurrent.futures
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.serve import Captioner as JaxCaptioner
from dlsg_tpu.server import CaptionServer as JaxCaptionServer
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.synthetic import make_vocab
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.server import MAX_BODY_BYTES, CaptionServer
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(test_batch_size=4, beam_size=2)


def _start(srv):
    srv.start_background()
    return srv


@pytest.fixture(scope="module")
def servers():
    """(port server, its Captioner, cfg, JAX server over the same weights)."""
    jcfg = jax_tiny(**CFG)
    vocab = make_vocab()
    B = jcfg.test_batch_size
    params = JaxCapGnnModel(jcfg, len(vocab)).init(
        jax.random.PRNGKey(0),
        jnp.zeros((B, jcfg.max_frames, jcfg.feature_size)),
        jnp.zeros((B, jcfg.max_frames, jcfg.num_obj, jcfg.region_feature_size)),
        jnp.zeros((B, jcfg.max_words), jnp.int32),
    )["params"]
    cfg = tiny_test_config(**CFG)
    cap = Captioner.from_params(cfg, vocab, params_from_jax(params), device="cpu")
    srv = _start(CaptionServer(cap, host="127.0.0.1", port=0))  # port 0 -> a free port
    from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab

    jsrv = _start(JaxCaptionServer(JaxCaptioner.from_params(jcfg, jax_make_vocab(), params),
                                   host="127.0.0.1", port=0))
    yield srv, cap, cfg, jsrv
    for s in (srv, jsrv):
        s.shutdown()
        s.server_close()


@pytest.fixture
def server(servers):
    return servers[:3]


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(srv, path, body, content_type):
    req = urllib.request.Request(_url(srv, path), data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def _clips(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(
        np.float32
    )
    return frames, regions


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _scrape(srv):
    with urllib.request.urlopen(_url(srv, "/metrics")) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if ln and not ln.startswith("#")}


def test_healthz(server):
    srv, cap, cfg = server
    with urllib.request.urlopen(_url(srv, "/healthz"), timeout=60) as resp:
        status, payload = resp.status, json.loads(resp.read())
    assert status == 200 and payload["status"] == "ok"
    assert payload["beam_size"] == cfg.beam_size and payload["dataset"] == cfg.dataset
    assert payload["device"] == "cpu" and payload["device_name"] == "cpu"
    assert payload["devices"] == torch.cuda.device_count()
    assert payload["warm"] is False  # the fixture never calls warmup()


def test_caption_npz_body_matches_direct_and_jax(servers):
    srv, cap, cfg, jsrv = servers
    frames, regions = _clips(cfg, 3)
    body = _npz(frames=frames, regions=regions,
                video_ids=np.array(["video7001", "video7002", "video7003"]))
    status, payload = _post(srv, "/caption", body, "application/x-npz")
    assert status == 200
    assert [c["video_id"] for c in payload["captions"]] == ["video7001", "video7002", "video7003"]
    assert [c["caption"] for c in payload["captions"]] == cap.caption(frames, regions)
    assert payload["latency_s"] > 0
    _, jpayload = _post(jsrv, "/caption", body, "application/x-npz")
    assert payload["captions"] == jpayload["captions"]


def test_caption_json_body_and_greedy(servers):
    srv, cap, cfg, jsrv = servers
    frames, regions = _clips(cfg, 2, seed=1)
    body = json.dumps({"frames": frames.tolist(), "regions": regions.tolist()}).encode()
    status, payload = _post(srv, "/caption?greedy=1", body, "application/json")
    assert status == 200
    # no video_ids -> positional ints; greedy=1 -> the greedy decoder
    assert [c["video_id"] for c in payload["captions"]] == [0, 1]
    assert [c["caption"] for c in payload["captions"]] == cap.caption(frames, regions, greedy=True)
    _, jpayload = _post(jsrv, "/caption?greedy=1", body, "application/json")
    assert payload["captions"] == jpayload["captions"]


@pytest.mark.parametrize("body,ctype,frag", [
    (b"not an npz", "application/x-npz", None),           # undecodable
    (b'{"frames": [1]}', "application/json", "regions"),  # missing key
])
def test_caption_malformed_is_400(server, body, ctype, frag):
    srv, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/caption", body, ctype)
    assert ei.value.code == 400
    err = json.loads(ei.value.read())["error"]
    if frag:
        assert frag in err


def test_caption_mismatched_ids_is_400(server):
    srv, _, cfg = server
    frames, regions = _clips(cfg, 3, seed=2)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/caption", _npz(frames=frames, regions=regions, video_ids=np.array([1, 2])),
              "application/x-npz")
    assert ei.value.code == 400
    assert "video_ids" in json.loads(ei.value.read())["error"]


def test_concurrent_requests_all_succeed(server):
    """Parallel clients serialize around the device lock; each request gets
    its own captions."""
    srv, cap, cfg = server
    frames, regions = _clips(cfg, 2, seed=9)
    expected = cap.caption(frames, regions, greedy=True)

    def one(i):
        body = json.dumps({"frames": frames.tolist(), "regions": regions.tolist(),
                           "video_ids": [i * 10, i * 10 + 1]}).encode()
        return _post(srv, "/caption?greedy=1", body, "application/json")

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(one, range(4)))
    for i, (status, payload) in enumerate(results):
        assert status == 200
        assert [c["video_id"] for c in payload["captions"]] == [i * 10, i * 10 + 1]
        assert [c["caption"] for c in payload["captions"]] == expected


def test_unknown_path_is_404(server):
    srv, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/nope", b"x", "application/json")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=60)
    assert ei.value.code == 404


def test_metrics_endpoint(server):
    """/metrics: Prometheus counters that follow the /caption traffic."""
    srv, _, cfg = server
    before = _scrape(srv)
    frames, regions = _clips(cfg, 2, seed=5)
    _post(srv, "/caption", _npz(frames=frames, regions=regions), "application/x-npz")
    with pytest.raises(urllib.error.HTTPError):
        _post(srv, "/caption", b"garbage", "application/json")
    after = _scrape(srv)
    assert after["dlsg_requests_total"] == before["dlsg_requests_total"] + 2
    assert after["dlsg_clips_total"] == before["dlsg_clips_total"] + 2
    assert after["dlsg_errors_total"] == before["dlsg_errors_total"] + 1
    count = "dlsg_request_latency_seconds_count"
    assert after[count] == before[count] + 1
    assert after["dlsg_request_latency_seconds_sum"] > before["dlsg_request_latency_seconds_sum"]
    # cumulative histogram: the +Inf bucket equals the count
    assert after['dlsg_request_latency_seconds_bucket{le="+Inf"}'] == after[count]
    assert after["dlsg_uptime_seconds"] > 0 and after["dlsg_warm"] in (0.0, 1.0)


def test_caption_wrong_feature_dims_is_400_and_counted(server):
    srv, _, cfg = server
    before = _scrape(srv)["dlsg_errors_total"]
    body = _npz(frames=np.zeros((1, cfg.max_frames, cfg.feature_size + 3), np.float32),
                regions=np.zeros((1, cfg.max_frames, cfg.num_obj, cfg.region_feature_size),
                                 np.float32))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/caption", body, "application/x-npz")
    assert ei.value.code == 400
    assert "dims mismatch" in json.loads(ei.value.read())["error"]
    assert _scrape(srv)["dlsg_errors_total"] == before + 1


def test_oversized_body_is_refused_unread(server):
    """A Content-Length above MAX_BODY_BYTES gets a 413 before any read."""
    srv, _, _ = server
    req = urllib.request.Request(
        _url(srv, "/caption"), data=b"x", method="POST",
        headers={"Content-Type": "application/x-npz", "Content-Length": str(MAX_BODY_BYTES + 1)},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 413
