"""Evidence that training learns: the JAX package's learning and convergence
experiments (its tests/test_learning.py:27-80 and tests/test_convergence.py:
55-110, 113-192) through this package's API, with their data, step counts
and thresholds.

- `gan_fit`: the GAN system memorizes 8 synthetic videos with fixed
  captions in 60 steps (CE + WGAN-GP, lr 3e-3 / 3e-4, lambda0 0.002);
- `heldout_ce`: CE on StructuredSyntheticDataset (4 classes x 4 videos,
  120 steps) decodes unseen noise draws of the class prototypes to the
  class captions, and the int8 decode of the trained model
  (`decode_quant="int8"`) scores on par with the unquantized one;
- `gan_dynamics`: the critic separates real from fake and the gradient
  penalty stays active and bounded over 100 GAN steps, and the GAN's
  captions are no worse than a CE-only run of the same length.

Each returns its numbers; `check_gan_fit`, `check_heldout_ce` and
`check_gan_dynamics` raise AssertionError where a threshold of the JAX
tests fails. The initial weights are the caller's state dicts (the tests
carry the JAX package's init across with `weights.py`) or this package's
seeded init. The int8 decode's model is built with the int8 config and the
trained weights: the decoder reads `decode_quant` from its model's config.
`chip_smoke.py`'s `learning` phase runs all three on the card.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dlsg_tpu_torch.config import DLSGConfig, tiny_test_config
from dlsg_tpu_torch.data.loader import eval_batches, train_batches
from dlsg_tpu_torch.data.synthetic import StructuredSyntheticDataset, SyntheticDataset, make_vocab
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.evaluation.evaluate import evaluate
from dlsg_tpu_torch.metrics.scorer import COCOScorer
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step

StateDict = Mapping[str, torch.Tensor]

G_LR, D_LR, LAMBDA0 = 3e-3, 3e-4, 0.002
FIT_EPOCHS, HELDOUT_EPOCHS, DYNAMICS_EPOCHS = 60, 60, 50
# step keys (a step's draws come from (key, step)): the JAX tests' PRNGKeys
FIT_KEY, HELDOUT_KEY, GAN_KEY, CE_KEY = 42, 1, 42, 43
HELDOUT_SEED, DYNAMICS_SEED, FIT_SEED = 7, 11, 3


def learning_config(**overrides) -> DLSGConfig:
    """The JAX tests' config: tiny_test_config at widths 64 (words 32), batch
    8, beam 2."""
    return tiny_test_config(
        train_batch_size=8, test_batch_size=8, beam_size=2, visual_hidden_size=64,
        region_projected_size=64, query_hidden_size=64, decode_hidden_size=64, word_size=32,
        **overrides,
    )


def _batch(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: batch[k] for k in ("frames", "regions", "captions", "lengths")}


def _models(cfg: DLSGConfig, V: int, device, gen_params, disc_params):
    gen = CapGnnModel(cfg, V, device=device)
    if gen_params is not None:
        gen.load_state_dict(gen_params)
    disc = DiscV2(cfg, V, device=device)
    if disc_params is not None:
        disc.load_state_dict(disc_params)
    return gen, disc


def score(model, cfg: DLSGConfig, view, references, vocab) -> dict:
    """{"scores", "captions"} of a beam-cfg.beam_size decode of `view`."""
    decode_fn = make_decode_fn(model, cfg, beam_size=cfg.beam_size, device=next(model.parameters()).device)
    scores, result, _, _ = evaluate(decode_fn, eval_batches(view, cfg.test_batch_size), vocab,
                                    references, scorer=COCOScorer())
    return {"scores": scores, "captions": dict(result)}


def gan_fit(cfg: DLSGConfig, device: DeviceLike = None, gen_params: Optional[StateDict] = None,
            disc_params: Optional[StateDict] = None) -> dict:
    """tests/test_learning.py: 60 GAN steps on 8 videos x 1 caption, then
    the beam decode of the same videos scored against their captions."""
    device = resolve_device(device)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=1, seed=FIT_SEED)
    gen, disc = _models(cfg, len(vocab), device, gen_params, disc_params)
    refs = ds.references
    before = score(gen, cfg, ds.eval_view(), refs, vocab)
    gs, dstate = TrainState.create(gen, make_optimizer(G_LR)), TrainState.create(disc, make_optimizer(D_LR))
    lstate = init_lambda_state(LAMBDA0, device=device)
    step = make_gan_train_step(gen, disc, cfg)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(FIT_EPOCHS):
        for batch in train_batches(ds, cfg.train_batch_size, seed=0, epoch=epoch):
            gs, dstate, lstate, m = step(gs, dstate, lstate, _batch(batch), FIT_KEY, 1.0)
            losses.append(float(m["cap_loss"]))
    train_s = time.perf_counter() - t0
    after = score(gen, cfg, ds.eval_view(), refs, vocab)
    return {"steps": len(losses), "train_s": train_s, "first_loss": losses[0], "last_loss": losses[-1],
            "before": before["scores"], "after": after["scores"], "captions": after["captions"],
            "references": refs}


def check_gan_fit(r: dict) -> None:
    before, after = r["before"], r["after"]
    if not r["last_loss"] < 0.5 * r["first_loss"]:
        raise AssertionError(f"the CE loss did not halve: {r['first_loss']} -> {r['last_loss']}")
    if not after["Bleu_1"] > max(0.5, before["Bleu_1"] + 0.3):
        raise AssertionError(f"Bleu_1 {before['Bleu_1']} -> {after['Bleu_1']}")
    if not after["CIDEr"] > before["CIDEr"] + 0.5:
        raise AssertionError(f"CIDEr {before['CIDEr']} -> {after['CIDEr']}")


def heldout_ce(cfg: DLSGConfig, device: DeviceLike = None,
               gen_params: Optional[StateDict] = None) -> dict:
    """tests/test_convergence.py::test_heldout_generalization_ce: 60 epochs
    of CE on 4 classes x 4 videos; scores on the training videos and on 2
    unseen draws a class, before and after, and the trained model's int8
    decode of the unseen draws."""
    device = resolve_device(device)
    vocab = make_vocab()
    V = len(vocab)
    ds = StructuredSyntheticDataset(cfg, vocab, num_classes=4, train_per_class=4,
                                    heldout_per_class=2, noise=0.3, seed=HELDOUT_SEED)
    gen, _ = _models(cfg, V, device, gen_params, None)
    before = score(gen, cfg, ds.heldout_view(), ds.heldout_references, vocab)
    state = TrainState.create(gen, make_optimizer(G_LR))
    step = make_ce_train_step(gen, cfg)
    n = 0
    t0 = time.perf_counter()
    for epoch in range(HELDOUT_EPOCHS):
        for batch in train_batches(ds, cfg.train_batch_size, seed=0, epoch=epoch):
            state, _ = step(state, _batch(batch), HELDOUT_KEY, 1.0)
            n += 1
    train_s = time.perf_counter() - t0
    train_after = score(gen, cfg, ds.eval_view(), ds.references, vocab)
    held_after = score(gen, cfg, ds.heldout_view(), ds.heldout_references, vocab)
    qcfg = replace(cfg, decode_quant="int8")
    q8 = CapGnnModel(qcfg, V, device=device)
    q8.load_state_dict(gen.state_dict())
    held_q8 = score(q8, qcfg, ds.heldout_view(), ds.heldout_references, vocab)
    return {"steps": n, "train_s": train_s, "before": before["scores"],
            "train_after": train_after["scores"], "held_after": held_after["scores"],
            "held_int8": held_q8["scores"], "captions": held_after["captions"],
            "captions_int8": held_q8["captions"], "references": ds.heldout_references}


def check_heldout_ce(r: dict) -> None:
    before, train, held, q8 = r["before"], r["train_after"], r["held_after"], r["held_int8"]
    if not train["Bleu_1"] > 0.7:
        raise AssertionError(f"training videos' Bleu_1 {train['Bleu_1']} <= 0.7")
    if not held["Bleu_1"] > max(0.6, before["Bleu_1"] + 0.3):
        raise AssertionError(f"held-out Bleu_1 {before['Bleu_1']} -> {held['Bleu_1']}")
    if not held["CIDEr"] > before["CIDEr"] + 0.5:
        raise AssertionError(f"held-out CIDEr {before['CIDEr']} -> {held['CIDEr']}")
    if not q8["Bleu_1"] > held["Bleu_1"] - 0.1:
        raise AssertionError(f"int8 held-out Bleu_1 {q8['Bleu_1']} against {held['Bleu_1']}")
    if not q8["CIDEr"] > held["CIDEr"] - 0.5:
        raise AssertionError(f"int8 held-out CIDEr {q8['CIDEr']} against {held['CIDEr']}")


def gan_dynamics(cfg: DLSGConfig, device: DeviceLike = None,
                 gen_params: Optional[StateDict] = None,
                 disc_params: Optional[StateDict] = None) -> dict:
    """tests/test_convergence.py::test_gan_dynamics_and_ce_ablation: 50
    epochs of GAN steps on 4 classes x 4 videos (the Wasserstein estimate
    and gradient penalty of each step), a CE-only run of as many steps from
    the same initial generator, and both decodes of the unseen draws."""
    device = resolve_device(device)
    vocab = make_vocab()
    V = len(vocab)
    ds = StructuredSyntheticDataset(cfg, vocab, num_classes=4, train_per_class=4,
                                    heldout_per_class=2, noise=0.3, seed=DYNAMICS_SEED)
    gen, disc = _models(cfg, V, device, gen_params, disc_params)
    ce_gen, _ = _models(cfg, V, device, {k: v.clone() for k, v in gen.state_dict().items()}, None)
    gs, dstate = TrainState.create(gen, make_optimizer(G_LR)), TrainState.create(disc, make_optimizer(D_LR))
    lstate = init_lambda_state(LAMBDA0, device=device)
    gan_step = make_gan_train_step(gen, disc, cfg)
    ws, gps = [], []
    t0 = time.perf_counter()
    for epoch in range(DYNAMICS_EPOCHS):
        for batch in train_batches(ds, cfg.train_batch_size, seed=0, epoch=epoch):
            gs, dstate, lstate, m = gan_step(gs, dstate, lstate, _batch(batch), GAN_KEY, 1.0)
            ws.append(float(m["wasserstein"]))
            gps.append(float(m["grad_penalty"]))
    gan_s = time.perf_counter() - t0
    ce_state = TrainState.create(ce_gen, make_optimizer(G_LR))
    ce_step = make_ce_train_step(ce_gen, cfg)
    t0 = time.perf_counter()
    for epoch in range(DYNAMICS_EPOCHS):
        for batch in train_batches(ds, cfg.train_batch_size, seed=0, epoch=epoch):
            ce_state, _ = ce_step(ce_state, _batch(batch), CE_KEY, 1.0)
    ce_s = time.perf_counter() - t0
    gan_scores = score(gen, cfg, ds.heldout_view(), ds.heldout_references, vocab)
    ce_scores = score(ce_gen, cfg, ds.heldout_view(), ds.heldout_references, vocab)
    n = len(ws)
    head, tail = slice(0, n // 5), slice(-n // 5, None)
    return {"steps": n, "gan_s": gan_s, "ce_s": ce_s, "wasserstein": ws, "grad_penalty": gps,
            "ws_head": float(np.mean(ws[head])), "ws_tail": float(np.mean(ws[tail])),
            "gp_tail": float(np.mean(gps[tail])), "gan_scores": gan_scores["scores"],
            "ce_scores": ce_scores["scores"], "captions": gan_scores["captions"],
            "references": ds.heldout_references}


def check_gan_dynamics(r: dict) -> None:
    if not r["ws_tail"] > max(5.0, 2 * r["ws_head"]):
        raise AssertionError(f"wasserstein head {r['ws_head']} -> tail {r['ws_tail']}")
    if not 0.01 < r["gp_tail"] < 5.0:
        raise AssertionError(f"gradient penalty tail {r['gp_tail']} outside (0.01, 5)")
    if not (np.isfinite(r["wasserstein"]).all() and np.isfinite(r["grad_penalty"]).all()):
        raise AssertionError("non-finite wasserstein or gradient penalty")
    gan, ce = r["gan_scores"], r["ce_scores"]
    if not gan["CIDEr"] > 0.5 * ce["CIDEr"]:
        raise AssertionError(f"GAN CIDEr {gan['CIDEr']} <= half of CE's {ce['CIDEr']}")
    if not gan["Bleu_1"] > 0.4:
        raise AssertionError(f"GAN Bleu_1 {gan['Bleu_1']} <= 0.4")
