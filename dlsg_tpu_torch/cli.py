"""Command-line entry points (counterpart of `dlsg_tpu/cli.py`):

- `python -m dlsg_tpu_torch.cli train`    <- train_debug.py (GAN / D-LSG training)
- `python -m dlsg_tpu_torch.cli train-base`   <- run_graph.py (CE-only CapBaseline1)
- `python -m dlsg_tpu_torch.cli train-legacy` <- run.py (frames-only CapModel)
- `python -m dlsg_tpu_torch.cli evaluate` <- evaluate.py __main__ (score a saved
  generator on the eval split: `--metric best_CIDEr`)
- `python -m dlsg_tpu_torch.cli serve`    caption clips with a trained model, one
  JSON line per video ({"video_id", "caption"}), no scoring: the eval split,
  `--features clips.npz` (arrays 'frames', 'regions', optional 'video_ids'),
  or as an HTTP service with `--listen HOST:PORT` (server.py). `--bundle
  model.dlsg.npz` serves a single-file bundle (with `--features` or
  `--listen`); `--greedy` decodes greedily; `--fast` is the Captioner's
  fast profile; `--warmup` runs every request bucket before listening.
- `python -m dlsg_tpu_torch.cli export`   write a serving bundle (model,
  vocabulary, config; the format both packages read):
  `export --metric best_CIDEr --out model.dlsg.npz`.

Every config flag of the reference (`utils/opt.py`) is accepted, with the JAX
package's names and defaults, and these:

  --synthetic            the hermetic synthetic dataset instead of the
                         MSVD/MSR-VTT feature files
  --synthetic_videos N   its number of videos (32)
  --synthetic_vocab N    its vocabulary's size: the built-in words, then
                         w0, w1, ... up to N words (default: the built-in
                         words alone)
  --no_debug             save models and checkpoints
  --resume_epoch N|latest, --resume (= --resume_epoch latest); train only:
                         train-base/train-legacy keep no training
                         checkpoints and exit 2 on it
  --metric NAME          evaluate/serve/export: the saved model to load
                         (best_CIDEr, ...)
  --torch_checkpoint PT  evaluate/serve/export a reference-trained .pt
                         (convert.py)
  --allow_random_params  evaluate/serve/export without a trained model
  --output PATH, --out   serve: the JSON lines file (default stdout);
                         export: the bundle (default model.dlsg.npz)
  --meteor_paraphrase_file, --meteor_synonym_file,
  --meteor_function_words_file PATH
                         score METEOR with official resources
                         (metrics/meteor.py; set through the
                         DLSG_METEOR_*_FILE environment variables)
  --device DEV           where to run (cuda); --device cpu runs on the CPU
  --distributed          one process per card, as torchrun starts them
                         (parallel/dist.py; NCCL on cards, gloo with
                         --device cpu), laid out as the mesh of
                         --mesh_data_axis x --mesh_model_axis
                         (parallel/mesh.py; data -1 takes the rest):
                           torchrun --nproc_per_node=N -m dlsg_tpu_torch.cli train --distributed ...
                         train, train-base, train-legacy: each data index
                         trains on its shard with train_batch_size rows a
                         step and evaluates its shard before the gather;
                         a model axis > 1 splits the vocab head over the
                         model peers. evaluate: the same decode. serve:
                         whole parameters on every rank, each request's
                         rows split over the data axis (--listen: rank 0
                         listens, the others follow).
                         export: rank 0 writes the bundle, gathered whole.
                         Only rank 0 prints, logs and saves.
                         --mesh_model_axis > 1 needs --distributed (exit 2)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from dlsg_tpu_torch.config import parse_opt
from dlsg_tpu_torch.device import resolve_device

_TRAINERS = ("train", "train-base", "train-legacy")
_COMMANDS = _TRAINERS + ("evaluate", "serve", "export")
_METEOR_FILES = (
    ("meteor_paraphrase_file", "DLSG_METEOR_PARAPHRASE_FILE"),
    ("meteor_synonym_file", "DLSG_METEOR_SYNONYM_FILE"),
    ("meteor_function_words_file", "DLSG_METEOR_FUNCTION_WORDS_FILE"),
)


def _synthetic_vocab(size):
    from dlsg_tpu_torch.data.synthetic import make_vocab

    return make_vocab(extra_words=max(0, size - len(make_vocab()))) if size else make_vocab()


def _build_datasets(cfg, synthetic: bool, synthetic_videos: int = 32, eval_only: bool = False,
                    synthetic_vocab: int = 0):
    """(vocab, train set, eval set, test references). `eval_only` (serve)
    skips the caption training set and the reference file."""
    if synthetic:
        from dlsg_tpu_torch.data.synthetic import SyntheticDataset

        vocab = _synthetic_vocab(synthetic_vocab)
        train_ds = SyntheticDataset(cfg, vocab, num_videos=synthetic_videos)
        return vocab, train_ds, train_ds.eval_view(), train_ds.references

    from dlsg_tpu_torch.data.datasets import CaptionDataset, EvalVideoDataset
    from dlsg_tpu_torch.metrics.scorer import load_references_txt
    from dlsg_tpu_torch.vocab import Vocabulary

    vocab = Vocabulary.load_reference_pkl(cfg.vocab_pkl_path)
    eval_ds = EvalVideoDataset(cfg)
    if eval_only:
        return vocab, None, eval_ds, None
    train_ds = CaptionDataset(cfg)
    reference = load_references_txt(cfg.test_reference_txt_path)
    return vocab, train_ds, eval_ds, reference


def _vocab_only(cfg, synthetic: bool, synthetic_vocab: int = 0):
    if synthetic:
        return _synthetic_vocab(synthetic_vocab)
    from dlsg_tpu_torch.vocab import Vocabulary

    return Vocabulary.load_reference_pkl(cfg.vocab_pkl_path)


def _device(name: str):
    try:
        return resolve_device(name)
    except RuntimeError:
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        ) from None


def _load_generator(cfg, vocab, extra_ns, device):
    """CapGnnModel with the weights of --torch_checkpoint or --metric (seeded
    random weights with --allow_random_params)."""
    from dlsg_tpu_torch import checkpoint as ckpt
    from dlsg_tpu_torch.models.generator import CapGnnModel

    model = CapGnnModel(cfg, len(vocab), device=device)
    if extra_ns.torch_checkpoint:
        from dlsg_tpu_torch.convert import load_reference_checkpoint

        model.load_state_dict(load_reference_checkpoint(extra_ns.torch_checkpoint, cfg)["generator"])
    elif extra_ns.metric:
        model.load_state_dict(ckpt.restore_model(cfg.checkpoint_dir, extra_ns.metric, device=device))
    return model


def _parser() -> argparse.ArgumentParser:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--synthetic", action="store_true")
    extra.add_argument("--synthetic_videos", type=int, default=32)
    extra.add_argument("--synthetic_vocab", type=int, default=0,
                       help="the synthetic vocabulary's size (default: its built-in words)")
    extra.add_argument("--no_debug", action="store_true", help="enable model saving")
    extra.add_argument(
        "--resume_epoch", type=str, default=None,
        help="resume from a full checkpoint: an epoch number, or 'latest' to "
        "auto-pick the highest epoch_N in checkpoint_dir (fresh start if none)",
    )
    extra.add_argument(
        "--resume", dest="resume_epoch", action="store_const", const="latest",
        help="shorthand for --resume_epoch latest",
    )
    extra.add_argument("--metric", type=str, default=None, help="the saved model: best_METEOR|best_CIDEr")
    extra.add_argument(
        "--allow_random_params", action="store_true",
        help="evaluate/serve/export without a checkpoint (a randomly initialized model)",
    )
    extra.add_argument(
        "--torch_checkpoint", type=str, default=None,
        help="a reference-trained torch .pt (run_gun.py:302-310 schema), through convert.py",
    )
    extra.add_argument("--greedy", action="store_true", help="serve: greedy decode instead of beam")
    extra.add_argument(
        "--output", "--out", type=str, default=None, metavar="PATH",
        help="serve: write the JSON lines here instead of stdout; export: the "
        "bundle path (default model.dlsg.npz)",
    )
    extra.add_argument(
        "--features", type=str, default=None,
        help="serve: caption an .npz of features ('frames' [N,max_frames,feature_size], "
        "'regions' [N,max_frames,>=num_obj,region_feature_size], optional 'video_ids') "
        "instead of the eval split",
    )
    extra.add_argument("--fast", action="store_true", help="serve: the Captioner's fast profile")
    extra.add_argument(
        "--bundle", type=str, default=None, metavar="PATH",
        help="serve: a single-file serving bundle (from `export`) instead of a "
        "checkpoint dir and vocabulary pickle",
    )
    extra.add_argument(
        "--listen", type=str, default=None, metavar="HOST:PORT",
        help="serve: run the HTTP captioning service (GET /healthz, /metrics, "
        "POST /caption; see server.py)",
    )
    extra.add_argument(
        "--warmup", action="store_true",
        help="serve --listen: run every request bucket once before accepting traffic",
    )
    for flag, _ in _METEOR_FILES:
        extra.add_argument(f"--{flag}", type=str, default=None, metavar="PATH",
                           help="an official METEOR resource (metrics/meteor.py)")
    extra.add_argument("--device", type=str, default="cuda")
    extra.add_argument(
        "--distributed", action="store_true",
        help="join the torchrun process group (one process per card), laid out as the "
        "mesh of --mesh_data_axis x --mesh_model_axis",
    )
    return extra


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    command, rest = argv[0], argv[1:]
    if command not in _COMMANDS:
        print(f"unknown command: {command}\n{__doc__}", file=sys.stderr)
        return 2

    extra_ns, cfg_argv = _parser().parse_known_args(rest)
    # through the environment, so every scoring site (evaluate, the trainer's
    # evals) reads them at its first Meteor()
    for flag, var in _METEOR_FILES:
        if getattr(extra_ns, flag):
            os.environ[var] = getattr(extra_ns, flag)

    cfg = parse_opt(cfg_argv)
    serve_bundle = command == "serve" and extra_ns.bundle
    # the guards need only flags: they run before any data is read
    if command not in _TRAINERS and not serve_bundle and not (
        extra_ns.metric or extra_ns.torch_checkpoint or extra_ns.allow_random_params
    ):
        print(
            f"{command}: no --metric given — this would run a RANDOMLY "
            "INITIALIZED model. Pass --metric best_CIDEr (or another saved "
            "checkpoint name), --torch_checkpoint, or --allow_random_params to force.",
            file=sys.stderr,
        )
        return 2
    if command in ("train-base", "train-legacy") and extra_ns.resume_epoch is not None:
        # only the GAN trainer writes/restores full training checkpoints
        # (reference parity: run_gun.py:302-310 — run_graph.py / run.py never
        # checkpoint); silently dropping the flag would fake a resume
        print(
            f"{command}: --resume/--resume_epoch is only supported by `train` "
            "(the baseline trainers keep no full training checkpoints, "
            "matching the reference)",
            file=sys.stderr,
        )
        return 2
    if serve_bundle and not (extra_ns.features or extra_ns.listen):
        print(
            "serve: --bundle requires --features or --listen (the bundle "
            "carries no dataset; give it clips or run it as a service)",
            file=sys.stderr,
        )
        return 2
    if extra_ns.torch_checkpoint and not os.path.isfile(extra_ns.torch_checkpoint):
        print(f"--torch_checkpoint: no such file: {extra_ns.torch_checkpoint}", file=sys.stderr)
        return 2
    if cfg.mesh_model_axis > 1 and not extra_ns.distributed:
        print(
            f"{command}: --mesh_model_axis {cfg.mesh_model_axis} splits the vocab head over "
            "ranks: launch one process per rank with torchrun and pass --distributed",
            file=sys.stderr,
        )
        return 2
    if not extra_ns.distributed:
        return _run(command, cfg, extra_ns, _device(extra_ns.device), None)

    import torch.distributed

    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import make_mesh

    device = dist.init_distributed(_device(extra_ns.device))  # before any model is built
    try:
        try:
            mesh = make_mesh(cfg.mesh_data_axis, cfg.mesh_model_axis)
        except ValueError as e:
            print(f"{command}: {e}", file=sys.stderr)
            return 2
        return _run(command, cfg, extra_ns, device, mesh)
    finally:
        dist.set_mesh(None)
        torch.distributed.destroy_process_group()


def _run(command, cfg, extra_ns, device, mesh) -> int:
    if command in _TRAINERS:
        from dlsg_tpu_torch.train import trainer

        vocab, train_ds, eval_ds, reference = _build_datasets(
            cfg, extra_ns.synthetic, extra_ns.synthetic_videos,
            synthetic_vocab=extra_ns.synthetic_vocab,
        )
        runner_class = {"train": trainer.RunGAN, "train-base": trainer.Run,
                        "train-legacy": trainer.RunLegacy}[command]
        runner = runner_class(
            cfg, vocab, train_ds, eval_ds, reference,
            is_debug=not extra_ns.no_debug, resume_epoch=extra_ns.resume_epoch, device=device,
            mesh=mesh,
        )
        runner.train()  # this data index's shard of each epoch
        return 0
    if command == "evaluate":
        return _evaluate(cfg, extra_ns, device, mesh)
    if command == "export":
        return _export(cfg, extra_ns, device, mesh)
    return _serve(cfg, extra_ns, device, mesh)


def _evaluate(cfg, extra_ns, device, mesh) -> int:
    from dlsg_tpu_torch.data.loader import eval_batches
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.evaluation.evaluate import evaluate
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import shard_params

    vocab, _, eval_ds, reference = _build_datasets(
        cfg, extra_ns.synthetic, extra_ns.synthetic_videos, synthetic_vocab=extra_ns.synthetic_vocab
    )
    model = _load_generator(cfg, vocab, extra_ns, device)
    if mesh is not None:
        shard_params(model, mesh)  # the trainer's layout: the head split over the model axis
    decode_fn = make_decode_fn(model, cfg, device=device)
    # each data index decodes its shard; the gather merges them on every rank
    scores, _, _, t = evaluate(
        decode_fn,
        eval_batches(eval_ds, cfg.test_batch_size, shard_index=dist.data_rank(),
                     num_shards=dist.data_size()),
        vocab, reference, stage_dtype=cfg.stage_dtype,
    )
    if dist.is_leader():
        for k, v in scores.items():
            print(f"{k}: {100 * v:.6f}")
        print(f"inference time: {t:.3f}s")
    return 0


def _export(cfg, extra_ns, device, mesh) -> int:
    from dlsg_tpu_torch.bundle import save_bundle
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import shard_params, whole_state_dict
    from dlsg_tpu_torch.weights import params_to_jax

    vocab = _vocab_only(cfg, extra_ns.synthetic, extra_ns.synthetic_vocab)
    model = _load_generator(cfg, vocab, extra_ns, device)
    if mesh is not None:
        shard_params(model, mesh)  # the trainer's layout, gathered whole again below
    params = whole_state_dict(model)  # every rank joins the gather
    out = extra_ns.output or "model.dlsg.npz"
    if dist.is_leader():
        save_bundle(out, cfg, vocab, params_to_jax(params))
        print(
            f"export: wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB — "
            f"{len(vocab)}-word vocab, {cfg.dataset} config)",
            file=sys.stderr,
        )
    dist.barrier()  # no rank returns before the bundle is written
    return 0


def _serve(cfg, extra_ns, device, mesh) -> int:
    import numpy as np

    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.serve import Captioner, jsonable_id

    leader = dist.is_leader()
    eval_ds = None
    if extra_ns.bundle:
        captioner = Captioner.from_bundle(extra_ns.bundle, fast=extra_ns.fast, device=device,
                                          mesh=mesh)
        cfg = captioner.cfg  # the bundle's config drives serving
    else:
        if extra_ns.features or extra_ns.listen:
            vocab = _vocab_only(cfg, extra_ns.synthetic, extra_ns.synthetic_vocab)
        else:
            vocab, _, eval_ds, _ = _build_datasets(
                cfg, extra_ns.synthetic, extra_ns.synthetic_videos, eval_only=True,
                synthetic_vocab=extra_ns.synthetic_vocab,
            )
        model = _load_generator(cfg, vocab, extra_ns, device)
        captioner = Captioner.from_params(cfg, vocab, model.state_dict(), fast=extra_ns.fast,
                                          device=device, mesh=mesh)
        del model

    if extra_ns.listen:
        from dlsg_tpu_torch.server import CaptionServer, follow

        if extra_ns.warmup:  # every rank: the buckets run split as requests do
            t0 = time.perf_counter()
            n_shapes = captioner.warmup(greedy=extra_ns.greedy)
            if leader:
                print(f"serve: warmed {n_shapes} bucket shapes in "
                      f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        if not leader:
            follow(captioner)  # until the leader's server closes
            return 0
        host, _, port = extra_ns.listen.rpartition(":")
        server = CaptionServer(captioner, host or "0.0.0.0", int(port))
        print(
            f"serve: listening on {server.server_address[0]}:{server.server_address[1]} "
            "(POST /caption, GET /healthz, GET /metrics)",
            file=sys.stderr, flush=True,
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0

    n_done = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        out = sys.stdout if leader else stack.enter_context(open(os.devnull, "w"))
        if extra_ns.output and leader:
            out = stack.enter_context(open(extra_ns.output, "w"))

        def emit(frames, regions, video_ids):
            nonlocal n_done
            vids = np.asarray(video_ids)
            if len(vids) != len(frames):
                raise ValueError(
                    f"serve: {len(frames)} clips but {len(vids)} video_ids "
                    "— refusing to caption misaligned inputs"
                )
            sentences = captioner.caption(frames, regions, greedy=extra_ns.greedy)
            for vid, sent in zip(vids, sentences):
                out.write(json.dumps({"video_id": jsonable_id(vid), "caption": sent}) + "\n")
            out.flush()  # a crash mid-run loses at most one batch
            n_done += len(sentences)

        if extra_ns.features:
            with np.load(extra_ns.features) as data:
                frames, regions = data["frames"], data["regions"]
                vids = data["video_ids"] if "video_ids" in data else np.arange(frames.shape[0])
            emit(frames, regions, vids)
        else:
            from dlsg_tpu_torch.data.loader import eval_batches

            for batch in eval_batches(eval_ds, cfg.test_batch_size, pad_to_full=False):
                emit(batch["frames"], batch["regions"], batch["video_ids"])
    dt = time.perf_counter() - t0
    if leader:
        print(f"serve: {n_done} captions in {dt:.2f}s ({n_done / max(dt, 1e-9):.1f}/s)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
