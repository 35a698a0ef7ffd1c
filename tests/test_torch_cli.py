"""dlsg_tpu_torch's command line: `train --synthetic`, `train` on the
reference's on-disk layout then `--resume`, `evaluate --metric`, the flags
of `parse_opt` against dlsg_tpu's, and the commands that are not ported."""

import dataclasses
import os

import pytest

from dlsg_tpu.config import parse_opt as jax_parse_opt
from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.cli import main
from dlsg_tpu_torch.config import parse_opt
from test_cli_realdata import TINY_FLAGS, _fabricate_data_dir
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

PORT_FLAGS = TINY_FLAGS[4:]  # without the mesh flags: one process, one device
assert "--mesh_data_axis" not in PORT_FLAGS and "--train_batch_size" in PORT_FLAGS
SCORES = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


def test_train_synthetic_on_the_cpu(tmp_path, capsys):
    args = ["train", "--synthetic", "--synthetic_videos", "4", "--device", "cpu", "--no_debug",
            "--epoch_num", "1", "--result_dir", str(tmp_path)] + PORT_FLAGS
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "Epoch-0 lr: 0.00016" in out and "CIDEr: " in out
    assert os.path.exists(tmp_path / "checkpoints" / "epoch_0" / ckpt.TRAIN_FILE)


def test_train_resume_and_evaluate_on_reference_layout_files(tmp_path, capsys):
    """The counterpart of tests/test_cli_realdata.py: features h5, region h5,
    caption pickle, the reference's vocab pickle and reference text."""
    _fabricate_data_dir(tmp_path / "data")
    common = ["--dataset", "msvd", "--data_dir", str(tmp_path / "data"),
              "--result_dir", str(tmp_path / "results"), "--device", "cpu"] + PORT_FLAGS
    assert main(["train", "--no_debug", "--epoch_num", "1"] + common) == 0
    ckpt_dir = tmp_path / "results" / "checkpoints"
    assert ckpt.latest_epoch(str(ckpt_dir)) == 0
    capsys.readouterr()
    assert main(["train", "--no_debug", "--epoch_num", "2", "--resume"] + common) == 0
    out = capsys.readouterr().out
    assert "auto-resume: latest checkpoint epoch = 0" in out
    assert "Epoch-1 lr: 0.00016" in out and "Epoch-0 lr" not in out
    assert ckpt.latest_epoch(str(ckpt_dir)) == 1
    base = [d for d in os.listdir(tmp_path / "results") if d.startswith("msvd")][0]
    assert os.path.exists(tmp_path / "results" / base / "logs" / "scalars.jsonl")

    # evaluate the saved best_CIDEr. An eval saves it when CIDEr improves on
    # 0; should no eval of the random model score any CIDEr, the final
    # generator of epoch_1 is saved under that name here, by hand.
    if not (ckpt_dir / "best_CIDEr").exists():
        import torch

        payload = torch.load(ckpt_dir / "epoch_1" / ckpt.TRAIN_FILE, weights_only=True)
        ckpt.save_model(str(ckpt_dir), "best_CIDEr", payload["gen_params"])
    capsys.readouterr()
    assert main(["evaluate", "--metric", "best_CIDEr"] + common) == 0
    lines = capsys.readouterr().out.splitlines()
    printed = dict(ln.split(": ") for ln in lines if ln.split(":")[0] in SCORES)
    assert list(printed) == list(SCORES)
    assert all(0.0 <= float(v) <= 1000.0 for v in printed.values())
    assert lines[-1].startswith("inference time: ")


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "msr-vtt"],
    ["--dataset", "msvd", "--train_batch_size", "8", "--learning_rate", "3e-4", "--use_glove", "true"],
    ["--msvd_test_range", "4", "6", "--use_visual_gan", "no", "--compute_dtype", "bfloat16",
     "--ss_factor", "7", "--result_dir", "results/x", "--use_fused_vocab_head", "on"],
])
def test_parse_opt_matches_jax(argv):
    assert dataclasses.asdict(parse_opt(argv)) == dataclasses.asdict(jax_parse_opt(argv))
    raw, jraw = parse_opt(argv, apply_overrides=False), jax_parse_opt(argv, apply_overrides=False)
    assert dataclasses.asdict(raw) == dataclasses.asdict(jraw)
    for prop in ("vocab_pkl_path", "train_caption_pkl_path", "feature_h5_path",
                 "region_feature_h5_path", "test_reference_txt_path", "checkpoint_dir",
                 "glove_path", "test_prediction_txt_path"):
        assert getattr(raw, prop) == getattr(jraw, prop), prop
    assert raw.base_name() == jraw.base_name()


def test_unported_commands_and_guards_exit_2(tmp_path, capsys):
    for command in ("train-base", "train-legacy", "serve", "export"):
        assert main([command, "--synthetic"]) == 2
        assert "ROADMAP queue 1, item" in capsys.readouterr().err
    assert main(["evaluate", "--synthetic", "--torch_checkpoint", "x.pt", "--device", "cpu"]) == 2
    assert "item 8" in capsys.readouterr().err
    assert main(["evaluate", "--synthetic", "--device", "cpu"]) == 2  # no --metric
    assert "--allow_random_params" in capsys.readouterr().err
    assert main(["bogus"]) == 2
    assert main(["--help"]) == 0 and "--device" in capsys.readouterr().out
