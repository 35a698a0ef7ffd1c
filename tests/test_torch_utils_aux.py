"""dlsg_tpu_torch/utils/plots.py::plot_alpha_all, utils/logging.py::
MetricsWriter, utils/profiler.py::Stopwatch and evaluation/results.py::
ResultHandler against dlsg_tpu's, on the inputs of tests/test_utils_aux.py
and tests/test_trainer.py.

plot_alpha_all: the same file name and the same two panels (each row of
the object attention divided by its maximum, the motion attention by the
object panel's row maximum), recorded at `Axes.imshow`, exactly.
MetricsWriter: the same JSONL lines but for the wall-clock `t`. Stopwatch:
the same span counts and report lines but for the times. ResultHandler:
the same save triggers, best values, printed lines and CSV files."""

import json
import os
import re

import numpy as np
import pytest
from matplotlib.axes import Axes

from dlsg_tpu.evaluation.results import ResultHandler as JaxResultHandler
from dlsg_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from dlsg_tpu.utils.plots import plot_alpha_all as jax_plot_alpha_all
from dlsg_tpu.utils.profiler import Stopwatch as JaxStopwatch
from dlsg_tpu_torch.evaluation.results import ResultHandler
from dlsg_tpu_torch.utils.logging import MetricsWriter
from dlsg_tpu_torch.utils.plots import plot_alpha_all
from dlsg_tpu_torch.utils.profiler import Stopwatch


@pytest.fixture
def panels(monkeypatch):
    """The arrays each plot hands to `imshow`, in order."""
    seen = []
    real = Axes.imshow

    def recording(self, data, *args, **kwargs):
        seen.append(np.array(data))
        return real(self, data, *args, **kwargs)

    monkeypatch.setattr(Axes, "imshow", recording)
    return seen


@pytest.mark.parametrize("zero_row", [False, True])
def test_plot_alpha_all_matches_jax(tmp_path, panels, zero_row):
    alpha = np.random.default_rng(0).uniform(size=(2, 9, 12)).astype(np.float32)
    if zero_row:  # a row of zero object attention keeps its values (max 1)
        alpha[0, 3, :6] = 0.0
    kw = dict(num_psl=6, title="t", epoch=1, step=2, vid=3)
    want = jax_plot_alpha_all(alpha, out_dir=str(tmp_path / "jax"), **kw)
    got = plot_alpha_all(alpha, out_dir=str(tmp_path / "port"), **kw)
    assert os.path.basename(got) == os.path.basename(want) == "3_1_2.png"
    assert os.path.exists(got) and os.path.exists(want)
    assert len(panels) == 4
    for g, w in zip(panels[2:], panels[:2]):
        np.testing.assert_array_equal(g, w)
    obj = alpha[0, :, :6]
    rowmax = obj.max(axis=1, keepdims=True)
    rowmax[rowmax == 0] = 1.0
    np.testing.assert_array_equal(panels[2], obj / rowmax)
    np.testing.assert_array_equal(panels[3], alpha[0, :, 6:] / rowmax)


def test_metrics_writer_matches_jax(tmp_path):
    lines = {}
    for name, cls in (("jax", JaxMetricsWriter), ("port", MetricsWriter)):
        w = cls(str(tmp_path / name))
        w.add_scalar("Loss/cap_loss", 3.5, 1)
        w.add_scalar("Loss/cap_loss", 3.1, 2)
        w.add_scalar("results/CIDEr", np.float32(0.25), np.int64(7))
        w.close()
        with open(tmp_path / name / "scalars.jsonl") as f:
            lines[name] = [json.loads(line) for line in f]
    assert lines["port"][0]["tag"] == "Loss/cap_loss"
    assert lines["port"][1]["value"] == pytest.approx(3.1)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "t"} for r in rows]  # noqa: E731
    assert strip(lines["port"]) == strip(lines["jax"])
    assert [sorted(r) for r in lines["port"]] == [sorted(r) for r in lines["jax"]]


def test_disabled_metrics_writer_writes_nothing(tmp_path):
    for cls in (JaxMetricsWriter, MetricsWriter):
        d = tmp_path / cls.__module__.split(".")[0]
        w = cls(str(d), enabled=False)
        w.add_scalar("Loss/cap_loss", 1.0, 0)
        w.close()
        assert not d.exists()


def test_stopwatch_matches_jax():
    reports = {}
    for name, cls in (("jax", JaxStopwatch), ("port", Stopwatch)):
        sw = cls()
        for span in ("a", "a", "b", "c", "a"):
            with sw.span(span):
                pass
        assert dict(sw.counts) == {"a": 3, "b": 1, "c": 1}
        reports[name] = re.sub(r"[0-9.]+s", "Ts", sw.report())
    assert reports["port"] == reports["jax"] and "a: total Ts over 3 spans" in reports["port"]


def test_result_handler_matches_jax(tmp_path, capsys):
    """tests/test_trainer.py:13-26's sequence and a second beam size: the
    triggers, the best values, the printed lines and every CSV file."""
    evals = [
        ([{"Bleu_4": 0.2, "METEOR": 0.1, "CIDEr": 0.3, "ROUGE_L": 0.4},
          {"Bleu_4": 0.1, "METEOR": 0.2, "CIDEr": 0.1, "ROUGE_L": 0.3}],
         [{"1": "a cat", "2": "a dog"}, {"1": "b", "2": "c"}]),
        ([{"Bleu_4": 0.1, "METEOR": 0.05, "CIDEr": 0.1, "ROUGE_L": 0.2},
          {"Bleu_4": 0.3, "METEOR": 0.1, "CIDEr": 0.05, "ROUGE_L": 0.1}],
         [{"1": "b"}, {"1": "x y"}]),
        ([{"Bleu_4": 0.1, "METEOR": 0.3, "CIDEr": 0.5, "ROUGE_L": 0.2},
          {"Bleu_4": 0.0, "METEOR": 0.0, "CIDEr": 0.0, "ROUGE_L": 0.0}],
         [{"3": "z"}, {"3": "w"}]),
    ]
    seen = {}
    for name, cls in (("jax", JaxResultHandler), ("port", ResultHandler)):
        h = cls("exp", results_root=str(tmp_path / name), beam_list=[5, 3], is_debug=False)
        triggers = [h.update_result(m, r, epoch=e) for e, (m, r) in enumerate(evals)]
        h.print_results()
        files = {}
        for dirpath, _, names in os.walk(tmp_path / name):
            for n in names:
                path = os.path.join(dirpath, n)
                with open(path) as f:
                    files[os.path.relpath(path, tmp_path / name)] = f.read()
        seen[name] = (triggers, [h.best(k, i) for k in ("CIDEr", "Bleu_4") for i in (0, 1)],
                      capsys.readouterr().out, files)
    assert seen["port"] == seen["jax"]
    triggers, best, _, files = seen["port"]
    assert triggers == ["CIDEr", "Bleu_4", "CIDEr"] and best[0] == 0.5
    assert "exp/metrics.csv" in files and "exp/captioning/CIDEr_5.csv" in files
