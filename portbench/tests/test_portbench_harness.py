"""The harness on the CPU: the layout found by name, the last line's keys,
the guard against JAX, the exit without a card, the trace's reduction and
the readers, and every run with its timed path broken coming out not
correct (each cell at tiny widths, the look for a card skipped).

Run: JAX_PLATFORMS=cpu python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import control, harness, trace
from portbench.tests.tiny import tiny_run

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_driver(r, **kw):
    return harness.load_module("drivers", r.traffic["driver"]).run(r, **kw)


# ---------------------------------------------------------------- layout


def test_a_new_cell_mix_and_metric_are_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric as new files and entries only; the copy's harness runs the cell
    and reads the metric."""
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.benchmark()
    spec["workloads"].append({"name": "msrvtt-caption-b16", "config": "dlsg-msrvtt",
                              "traffic": "caption-b16", "chips": 1, "why": "a smaller batch"})
    spec["end_to_end"][1]["workloads"].append("msrvtt-caption-b16")
    spec["per_layer"].append({"name": "request_ms.b16", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "serving API",
                              "moves": "captions_per_s", "workloads": ["msrvtt-caption-b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((harness.BENCH / "traffic" / "caption-b128.json").read_text())
    traffic.update(request_clips=4, pool_clips=8, check_clips=4, boxes=10)
    (tmp_path / "portbench" / "traffic" / "caption-b16.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "request_ms.b16.json").write_text(json.dumps(
        {"reader": "span", "args": {"span": "request_s", "stat": "mean", "scale": 1000.0}}))
    script = textwrap.dedent("""
        import json, sys
        from portbench import harness
        from portbench.tests.tiny import tiny_run
        assert harness.BENCH.parent.resolve() == __import__("pathlib").Path.cwd().resolve()
        out = {}
        for t in (0, 1):
            r = tiny_run("msrvtt-caption-b16", trace=t)
            o = harness.load_module("drivers", r.traffic["driver"]).run(r)
            o.trace = {"window_s": 1.0, "busy_s": 0.5, "kernels": {}, "counts": {}, "idle_gaps": {}}
            line, _ = harness.result_line(r, o, {})
            out[t] = sorted(line["metrics"])
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["0"] == ["captions_per_s", "setup_s"]
    assert out["1"] == ["request_ms.b16"]


def test_every_benchmark_entry_has_its_files():
    spec = harness.benchmark()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        t = harness.load_json("traffic", f"{w['traffic']}.json")
        assert (harness.BENCH / "drivers" / f"{t['driver']}.py").exists()
        assert any(c["name"] == w["config"] for c in spec["configs"])
        e2e = {m["name"] for m in harness.metrics_of(spec, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(spec, "per_layer", w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in spec["per_layer"]:
        entry = harness.load_json("metrics", f"{m['name']}.json")
        assert (harness.BENCH / "readers" / f"{entry['reader']}.py").exists()


# ---------------------------------------------------------------- the last line


def test_last_line_has_the_contracts_keys():
    r = tiny_run("msrvtt-caption-b128")
    out = run_driver(r)
    line, lines = harness.result_line(r, out, {"platform": "gpu"})
    assert list(line) == KEYS and line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "captions_per_s"}
    assert lines[0].startswith("check token_mismatch_pct:")
    r = tiny_run("msrvtt-caption-b128", trace=1)
    out.trace = {"window_s": 2.0, "busy_s": 0.5, "kernels": {"k": 0.5}, "counts": {"k": 1},
                 "idle_gaps": {"aten::copy_": 1.5}}
    line, _ = harness.result_line(r, out, {"platform": "gpu"})
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["metrics"]["idle_share.b128"]["value"] == pytest.approx(75.0)
    # nothing to read: the rooflines and the copies are left out, never 0
    assert "k1_roofline.b128" not in line["metrics"] and "h2d_ms.b128" not in line["metrics"]


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxtyping", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "dlsg_tpu_torch_extra", SimpleNamespace())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dlsg_tpu.config", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "jax", SimpleNamespace())
    assert harness.forbidden_modules() == ["dlsg_tpu", "jax"]


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "msrvtt-caption-b128",
                           "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    res = _run_py(ROOT, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run_py(tmp_path, env)
    assert res.returncode != 0 and res.stdout == ""


# ---------------------------------------------------------------- trace and readers


class Ev:
    def __init__(self, name, dev, start, dur, mark=False):
        self._n, self._d, self._s, self._t, self._m = name, dev, start, dur, mark

    def is_user_annotation(self):
        return self._m

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_summary_merges_device_intervals_and_labels_gaps():
    ev = [Ev(trace.WINDOW, False, 0, 1000, True), Ev("aten::copy_", False, 100, 300),
          Ev("k1", True, 0, 100), Ev("k2", True, 50, 100), Ev("k1", True, 500, 100),
          Ev("late", True, 1500, 10), Ev("portbench.request", False, 0, 900, True),
          Ev("portbench.request", True, 0, 900)]  # an annotation mirrored on the device
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(250e-9)  # [0, 150) and [500, 600)
    assert s["counts"] == {"k1": 2, "k2": 1}
    assert s["idle_gaps"] == pytest.approx({"aten::copy_": 350e-9, "portbench.request": 400e-9})
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-9)]


def test_roofline_reader_counts_the_function_once():
    from portbench import work

    rd = harness.load_module("readers", "roofline")
    d = {"rows": 128, "count": 2, "beam": 5, "H": 1536, "V": 10000, "w_bytes": 4, "T": 26,
         "lstm_H": 1024}
    t = {"kernels": {"vh_wgmma_kernel<true>": 1e-3, "merge_kernel": 1e-4, "tf32_split_kernel": 1e-4},
         "counts": {"vh_wgmma_kernel<true>": 10, "merge_kernel": 10, "tf32_split_kernel": 2}}
    got = rd.read({"trace": t, "decodes": d}, "k1", "vh_wgmma_kernel",
                  ["vh_wgmma_kernel", "merge_kernel", "tf32_split_kernel"])
    want = (2 * work.k1(128, 1536, 10000).bound_s() + 8 * work.k1(640, 1536, 10000).bound_s())
    assert got == pytest.approx(100 * want / 1.2e-3)
    assert rd.read({"trace": {"kernels": {}, "counts": {}}, "decodes": d}, "k2",
                   "lstm_scan_kernel", ["lstm_scan_kernel"]) is None


# ---------------------------------------------------------------- broken timed paths


def _altered(orig):
    def caption(self, frames, regions, greedy=False):
        return [" ".join(["w5"] + c.split()[1:]) for c in orig(self, frames, regions, greedy)]
    return caption


def test_a_token_altered_where_captions_are_produced(monkeypatch):
    from dlsg_tpu_torch.serve import Captioner

    r = tiny_run("msrvtt-caption-b128")
    assert run_driver(r).checks[0].ok()
    monkeypatch.setattr(Captioner, "caption", _altered(Captioner.caption))
    out = run_driver(tiny_run("msrvtt-caption-b128", seed=6))
    line, _ = harness.result_line(r, out, {})
    assert line["correct"] is False


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from dlsg_tpu_torch.train import optim

    def still(self, grads):
        self.step += 1
        return self

    monkeypatch.setattr(optim.TrainState, "apply_gradients", still)
    r = tiny_run("msrvtt-gan-b128")
    out = run_driver(r)
    assert {c.name: c.value for c in out.checks}["g_change_gap"] == pytest.approx(1.0)
    assert harness.result_line(r, out, {})[0]["correct"] is False


def test_half_the_batch_left_out(monkeypatch):
    from dlsg_tpu_torch.train import steps

    make = steps.make_gan_train_step

    def halved(gen, disc, cfg):
        inner = make(gen, disc, cfg)

        def step(g, d, lam, batch, key, eps, eps_gp=None):
            n = len(batch["captions"]) // 2
            return inner(g, d, lam, {k: batch[k][:n] for k in
                                     ("frames", "regions", "captions", "lengths")}, key, eps)
        return step

    monkeypatch.setattr(steps, "make_gan_train_step", halved)
    r = tiny_run("msrvtt-gan-b128")
    out = run_driver(r)
    assert not {c.name: c for c in out.checks}["loss_gap"].ok()
    assert harness.result_line(r, out, {})[0]["correct"] is False


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_discriminator_fault(fault):
    """D's substeps with their Wasserstein term over half the batch, or with
    the gradient penalty left out: G's first step is untouched, D's numbers
    fail."""
    r = tiny_run("msrvtt-gan-b128")
    with control.planted(fault):
        out = run_driver(r)
    checks = {c.name: c for c in out.checks}
    assert checks["loss_gap"].ok() and not checks["d_loss_gap"].ok(), out.checks
    assert harness.result_line(r, out, {})[0]["correct"] is False


def test_sound_training_run_is_correct():
    r = tiny_run("msrvtt-gan-b128", seed=11)
    out = run_driver(r)
    assert all(c.ok() for c in out.checks), out.checks
    assert {c.name: c.value for c in out.checks}["lambda_gap"] == 0.0
    assert np.isfinite(out.e2e["train_clips_per_s"])
