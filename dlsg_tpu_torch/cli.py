"""Command-line entry points (counterpart of `dlsg_tpu/cli.py`):

- `python -m dlsg_tpu_torch.cli train`    <- train_debug.py (GAN / D-LSG training)
- `python -m dlsg_tpu_torch.cli evaluate` <- evaluate.py __main__ (score a saved
  generator on the eval split: `--metric best_CIDEr`)

Every config flag of the reference (`utils/opt.py`) is accepted, with the JAX
package's names and defaults, and these:

  --synthetic            the hermetic synthetic dataset instead of the
                         MSVD/MSR-VTT feature files
  --synthetic_videos N   its number of videos (32)
  --no_debug             save models and checkpoints
  --resume_epoch N|latest, --resume (= --resume_epoch latest)
  --metric NAME          evaluate: the saved model to load (best_CIDEr, ...)
  --allow_random_params  evaluate without a saved model
  --device DEV           where to run (cuda); --device cpu runs on the CPU

Not ported yet (exit 2): `train-base`, `train-legacy` (ROADMAP queue 1,
item 7), `serve`, `export` and `--torch_checkpoint` (item 8).
"""

from __future__ import annotations

import argparse
import sys

from dlsg_tpu_torch.config import parse_opt
from dlsg_tpu_torch.device import resolve_device

_NOT_PORTED = {
    "train-base": "the CE baseline trainer is not ported yet (ROADMAP queue 1, item 7)",
    "train-legacy": "the frames-only trainer is not ported yet (ROADMAP queue 1, item 7)",
    "serve": "the serve command is not ported yet (ROADMAP queue 1, item 8); "
             "use dlsg_tpu_torch.serve.Captioner",
    "export": "the export command is not ported yet (ROADMAP queue 1, item 8)",
}


def _build_datasets(cfg, synthetic: bool, synthetic_videos: int = 32):
    """(vocab, train set, eval set, test references)."""
    if synthetic:
        from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab

        vocab = make_vocab()
        train_ds = SyntheticDataset(cfg, vocab, num_videos=synthetic_videos)
        return vocab, train_ds, train_ds.eval_view(), train_ds.references

    from dlsg_tpu_torch.data.datasets import CaptionDataset, EvalVideoDataset
    from dlsg_tpu_torch.metrics.scorer import load_references_txt
    from dlsg_tpu_torch.vocab import Vocabulary

    vocab = Vocabulary.load_reference_pkl(cfg.vocab_pkl_path)
    eval_ds = EvalVideoDataset(cfg)
    train_ds = CaptionDataset(cfg)
    reference = load_references_txt(cfg.test_reference_txt_path)
    return vocab, train_ds, eval_ds, reference


def _device(name: str):
    try:
        return resolve_device(name)
    except RuntimeError:
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        ) from None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    command, rest = argv[0], argv[1:]
    if command in _NOT_PORTED:
        print(f"{command}: {_NOT_PORTED[command]}", file=sys.stderr)
        return 2
    if command not in ("train", "evaluate"):
        print(f"unknown command: {command}\n{__doc__}", file=sys.stderr)
        return 2

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--synthetic", action="store_true")
    extra.add_argument("--synthetic_videos", type=int, default=32)
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
    extra.add_argument("--metric", type=str, default=None, help="eval: best_METEOR|best_CIDEr ckpt")
    extra.add_argument(
        "--allow_random_params", action="store_true",
        help="evaluate without a checkpoint (scores a randomly initialized model)",
    )
    extra.add_argument("--torch_checkpoint", type=str, default=None)
    extra.add_argument("--device", type=str, default="cuda")
    extra_ns, cfg_argv = extra.parse_known_args(rest)
    if extra_ns.torch_checkpoint:
        print(
            "--torch_checkpoint: importing a reference .pt is not ported yet "
            "(ROADMAP queue 1, item 8)",
            file=sys.stderr,
        )
        return 2

    cfg = parse_opt(cfg_argv)
    if command == "evaluate" and not extra_ns.metric and not extra_ns.allow_random_params:
        # before any vocab/dataset loading: the guard needs only flags
        print(
            "evaluate: no --metric given — this would run a RANDOMLY "
            "INITIALIZED model. Pass --metric best_CIDEr (or another saved "
            "checkpoint name), or --allow_random_params to force.",
            file=sys.stderr,
        )
        return 2
    device = _device(extra_ns.device)
    vocab, train_ds, eval_ds, reference = _build_datasets(
        cfg, extra_ns.synthetic, extra_ns.synthetic_videos
    )

    if command == "train":
        from dlsg_tpu_torch.train.trainer import RunGAN

        runner = RunGAN(
            cfg, vocab, train_ds, eval_ds, reference,
            is_debug=not extra_ns.no_debug, resume_epoch=extra_ns.resume_epoch, device=device,
        )
        runner.train()
        return 0

    from dlsg_tpu_torch import checkpoint as ckpt
    from dlsg_tpu_torch.data.loader import eval_batches
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.evaluation.evaluate import evaluate
    from dlsg_tpu_torch.models.generator import CapGnnModel

    model = CapGnnModel(cfg, len(vocab), device=device)
    if extra_ns.metric:
        model.load_state_dict(ckpt.restore_model(cfg.checkpoint_dir, extra_ns.metric, device=device))
    decode_fn = make_decode_fn(model, cfg, device=device)
    scores, _, _, t = evaluate(
        decode_fn, eval_batches(eval_ds, cfg.test_batch_size), vocab, reference,
        stage_dtype=cfg.stage_dtype,
    )
    for k, v in scores.items():
        print(f"{k}: {100 * v:.6f}")
    print(f"inference time: {t:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
