"""dlsg_tpu_torch's command line: `train --synthetic`, `train` on the
reference's on-disk layout then `--resume`, `evaluate --metric`, `export`
then `serve --bundle --features`, `serve` of the eval split and
`evaluate` of a reference `.pt` (`--torch_checkpoint`), `serve --listen`,
the flags of `parse_opt` against dlsg_tpu's, and the guards (the baseline
trainers' commands are in test_torch_baselines_trainer.py)."""

import dataclasses
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import test_convert
from dlsg_tpu.serve import Captioner as JaxCaptioner
from dlsg_tpu.config import parse_opt as jax_parse_opt
from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch import server as server_mod
from dlsg_tpu_torch.cli import main
from dlsg_tpu_torch.config import parse_opt
from dlsg_tpu_torch.convert import capgnn_from_reference
from dlsg_tpu_torch.data.loader import eval_batches
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.serve import Captioner
from test_cli_realdata import TINY_FLAGS, _fabricate_data_dir
from test_torch_parallel import tmp_path  # noqa: F401  (removed when a test ends)
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
    """`train-base`/`train-legacy` with --resume exit 2 (the baseline
    trainers keep no training checkpoints); `serve` and `export` without a
    model (no --metric, --torch_checkpoint or --allow_random_params),
    `serve --bundle` without clips or --listen, and a --torch_checkpoint
    that does not exist exit 2 before reading data."""
    for command in ("train-base", "train-legacy", "serve", "export"):
        resume = ["--resume"] if command.startswith("train") else []
        assert main([command, "--synthetic"] + resume) == 2
        err = capsys.readouterr().err
        if command.startswith("train"):
            assert "is only supported by `train`" in err
        else:
            assert "--allow_random_params" in err
    assert main(["evaluate", "--synthetic", "--torch_checkpoint", "x.pt", "--device", "cpu"]) == 2
    assert "no such file: x.pt" in capsys.readouterr().err
    assert main(["evaluate", "--synthetic", "--device", "cpu"]) == 2  # no --metric
    assert "--allow_random_params" in capsys.readouterr().err
    assert main(["serve", "--bundle", str(tmp_path / "b.npz"), "--device", "cpu"]) == 2
    assert "--features or --listen" in capsys.readouterr().err
    assert main(["bogus"]) == 2
    assert main(["--help"]) == 0 and "--device" in capsys.readouterr().out


def _clips_npz(path, cfg, n, ids):
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(
        np.float32
    )
    np.savez(path, frames=frames, regions=regions, video_ids=ids)
    return frames, regions


def test_export_then_serve_the_bundle_on_the_cpu(tmp_path, capsys):
    """`export` writes a bundle of the (seeded random) model; `serve --bundle
    --features` captions an npz with it, as both packages' Captioner do."""
    bundle = str(tmp_path / "model.dlsg.npz")
    assert main(["export", "--synthetic", "--allow_random_params", "--device", "cpu",
                 "--out", bundle] + PORT_FLAGS) == 0
    assert "export: wrote" in capsys.readouterr().err
    cfg = parse_opt(PORT_FLAGS)
    frames, regions = _clips_npz(tmp_path / "clips.npz", cfg, 5, np.array(["a", "b", "c", "d", "e"]))
    out = tmp_path / "captions.jsonl"
    for greedy in ([], ["--greedy"]):
        assert main(["serve", "--bundle", bundle, "--features", str(tmp_path / "clips.npz"),
                     "--output", str(out), "--device", "cpu"] + greedy) == 0
        lines = [json.loads(ln) for ln in out.read_text().splitlines()]
        assert [ln["video_id"] for ln in lines] == ["a", "b", "c", "d", "e"]
        want = Captioner.from_bundle(bundle, device="cpu").caption(frames, regions, greedy=bool(greedy))
        assert [ln["caption"] for ln in lines] == want
        assert want == JaxCaptioner.from_bundle(bundle).caption(frames, regions, greedy=bool(greedy))


def test_serve_eval_split_and_evaluate_a_reference_checkpoint(tmp_path, capsys, monkeypatch):
    """A reference-schema .pt (tests/test_convert.py's key set) through
    `evaluate --torch_checkpoint` and `serve --torch_checkpoint` of the
    synthetic eval split: the JSON lines are the Captioner's captions of the
    converted weights. The METEOR file flags reach the environment."""
    cfg = parse_opt(PORT_FLAGS)
    vocab = make_vocab()
    monkeypatch.setattr(test_convert, "VOCAB", len(vocab))
    sd = test_convert._reference_capgnn_sd(cfg, np.random.default_rng(3))
    pt = tmp_path / "ref_epoch.pt"
    torch.save({"epoch": 3, "model_state_dict": sd, "cap_list": np.zeros(2)}, str(pt))
    fw = tmp_path / "function_words.txt"
    fw.write_text("a the of\n")
    # main() sets the variable itself: registered here, so that it is
    # removed again after the test (later scorers in this process, JAX's
    # among them, would read the file)
    monkeypatch.setenv("DLSG_METEOR_FUNCTION_WORDS_FILE", "")
    from dlsg_tpu_torch.metrics import meteor

    monkeypatch.setattr(meteor, "_env_table_loaded", {})
    common = ["--synthetic", "--synthetic_videos", "6", "--torch_checkpoint", str(pt),
              "--device", "cpu"] + PORT_FLAGS
    assert main(["evaluate", "--meteor_function_words_file", str(fw)] + common) == 0
    assert os.environ["DLSG_METEOR_FUNCTION_WORDS_FILE"] == str(fw)
    printed = [ln.split(": ")[0] for ln in capsys.readouterr().out.splitlines()]
    assert printed[:len(SCORES)] == list(SCORES)
    assert meteor.get_function_words() == {"a", "the", "of"}
    meteor.set_function_words(None)  # the built-in list again, for later tests
    assert main(["serve"] + common) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    ds = SyntheticDataset(cfg, vocab, num_videos=6)
    captioner = Captioner(cfg, vocab, capgnn_from_reference(sd, cfg), device="cpu")
    want = []
    for batch in eval_batches(ds.eval_view(), cfg.test_batch_size, pad_to_full=False):
        want += [{"video_id": int(v), "caption": c} for v, c in
                 zip(batch["video_ids"], captioner.caption(batch["frames"], batch["regions"]))]
    assert lines == want and len(lines) == 6


def test_serve_listen(tmp_path, monkeypatch, capsys):
    """`serve --listen 127.0.0.1:0 --warmup` answers /healthz and /caption
    until the server is shut down, then returns 0."""
    started = []
    real = server_mod.CaptionServer.serve_forever

    def serve_forever(self, *a, **kw):
        started.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(server_mod.CaptionServer, "serve_forever", serve_forever)
    rc = []
    argv = ["serve", "--synthetic", "--allow_random_params", "--listen", "127.0.0.1:0",
            "--warmup", "--device", "cpu"] + PORT_FLAGS
    t = threading.Thread(target=lambda: rc.append(main(argv)), daemon=True)
    t.start()
    for _ in range(600):
        if started or not t.is_alive():
            break
        t.join(0.1)
    assert started, "the server did not start"
    srv = started[0]
    host, port = srv.server_address[:2]
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["warm"] is True and health["device"] == "cpu"
        cfg = parse_opt(PORT_FLAGS)
        frames, regions = _clips_npz(tmp_path / "c.npz", cfg, 2, np.array([4, 5]))
        req = urllib.request.Request(f"http://{host}:{port}/caption",
                                     data=(tmp_path / "c.npz").read_bytes(),
                                     headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=300) as r:
            payload = json.loads(r.read())
        assert [c["caption"] for c in payload["captions"]] == srv.captioner.caption(frames, regions)
    finally:
        srv.shutdown()
    t.join(60)
    assert rc == [0]
    assert "serve: listening on 127.0.0.1:" in capsys.readouterr().err
