"""Best-result tracking and persistence.

Parity with `utils/utils.py:59-193` (ResultHandler / ResultsRecorder /
DataRecorder): track the best Bleu_4 / METEOR / CIDEr / ROUGE_L per beam size,
write per-metric best-prediction CSVs and a metrics.csv summary, and report
which metric improved so the trainer can checkpoint the model (the reference's
global SAVING_MODEL_NAME handshake, utils.py:110-146, replaced by a return
value). Only the process leader writes (utils.py:70). A copy of
`dlsg_tpu/evaluation/results.py`."""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

TRACKED = ("Bleu_4", "METEOR", "CIDEr", "ROUGE_L")
SAVE_TRIGGERS = ("Bleu_4", "CIDEr")  # utils.py:144-146


class DataRecorder:
    """Per-beam-size best-metric record (utils.py:128-160)."""

    def __init__(self, beam_size: int, path: str):
        self.beam_size = beam_size
        self.path = path
        self.record: Dict[str, float] = {k: 0.0 for k in TRACKED}
        self.record_epoch: Dict[str, int] = {k: 0 for k in TRACKED}

    def update(self, metrics: Dict[str, float], results: Dict[str, str], epoch: int):
        """Returns (should_save_csv, model_save_trigger or None)."""
        should_save = False
        trigger: Optional[str] = None
        for k, v in metrics.items():
            if k in self.record and v > self.record[k]:
                should_save = True
                if k in SAVE_TRIGGERS:
                    trigger = k
                self.record[k] = v
                self.record_epoch[k] = epoch
                os.makedirs(self.path, exist_ok=True)
                with open(
                    os.path.join(self.path, f"{k}_{self.beam_size}.csv"), "w", newline=""
                ) as f:
                    w = csv.writer(f)
                    w.writerow(["vid", "pred"])
                    for vid, pred in results.items():
                        w.writerow([int(vid), pred])
        return should_save, trigger

    def summary_lines(self) -> List[str]:
        out = [f"--------------beam_size = {self.beam_size}"]
        for k in TRACKED:
            out.append(f"{k}:{self.record[k]:.3f}, epoch {self.record_epoch[k]}")
        out.append("--------------")
        return out


class ResultHandler:
    """Trainer-facing result tracker (utils.py:59-125)."""

    def __init__(
        self,
        base_name: str,
        results_root: str = "./results",
        beam_list: Sequence[int] = (5,),
        is_leader: bool = True,
        is_debug: bool = True,
    ):
        self.is_leader = is_leader
        self.save_enabled = not is_debug
        self.path_results = os.path.join(results_root, base_name)
        self.path_captioning = os.path.join(self.path_results, "captioning")
        self.recorders = [DataRecorder(b, self.path_captioning) for b in beam_list]

    def update_result(
        self,
        metrics_list,
        results_list,
        epoch: int = 0,
    ) -> Optional[str]:
        """Record metrics; returns the metric name that triggered a model save
        (Bleu_4 or CIDEr improvement, utils.py:144-146) or None."""
        if not self.is_leader:
            return None
        if not isinstance(metrics_list, list):
            metrics_list, results_list = [metrics_list], [results_list]
        trigger = None
        any_improved = False
        for rec, metrics, results in zip(self.recorders, metrics_list, results_list):
            for k, v in metrics.items():
                print(f"{k}: {v:.6f}")
            improved, trig = rec.update(metrics, results, epoch)
            any_improved = any_improved or improved
            trigger = trig or trigger
        if any_improved:
            self._save_metrics_csv()
        return trigger

    def _save_metrics_csv(self):
        os.makedirs(self.path_results, exist_ok=True)
        rows = [
            {k: round(r.record[k], 4) for k in TRACKED} for r in self.recorders
        ]
        with open(os.path.join(self.path_results, "metrics.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + list(TRACKED))
            for i, row in enumerate(rows):
                w.writerow([i] + [row[k] for k in TRACKED])

    def print_results(self):
        if self.is_leader:
            for r in self.recorders:
                for line in r.summary_lines():
                    print(line)

    def best(self, metric: str = "CIDEr", beam_index: int = 0) -> float:
        return self.recorders[beam_index].record[metric]
