"""Trainers (counterpart of `dlsg_tpu/train/trainer.py`):

- `RunGAN`, the D-LSG adversarial trainer (reference `run_gun.py:RunGAN`):
  dataset hparam overrides, Adam + MultiStepLR for G and D, the adaptive GAN
  lambda, scheduled sampling, mid-epoch eval on a saving schedule,
  best-metric model saving, full-epoch checkpoints, scalar logging and
  resume;
- `Run`, the CE-only baseline trainer over CapBaseline1 (reference
  `run_graph.py:Run`), and `RunLegacy`, the frames-only trainer over
  CapModel (reference `run.py`): G's MultiStepLR, the per-epoch scheduled
  sampling epsilon, evals on the saving schedule, scalar logging. As in the
  reference and the JAX package they save no checkpoint and take no
  resume. Their evals decode with the beam and plot no attention.

Everything here is host-side orchestration; the per-batch work is one call
of a train step (train/steps.py). `use_glove` grafts GloVe vectors into the
word embedding of RunGAN's and Run's generator when it is built
(models/glove.py); `freeze_word_embed` keeps it out of their optimizers.
RunLegacy does neither, as in the JAX package.

A step's random draws come from (cfg.seed, the generator's step counter)
and an epoch's batch order from (cfg.seed, epoch). An `epoch_N` checkpoint
holds the step counters, so a run resumed from it draws exactly what the
uninterrupted run would have.

With `loader_workers > 0` an HDF5 training set is read by that many worker
processes (`data/parallel_loader.py`), as in the JAX package; a dataset
without `spawn_spec` (the synthetic one) is read in-process.

Parallelism: inside a process group (parallel/dist.py, one process per
card as `torchrun` starts them) the ranks form the mesh of
`cfg.mesh_data_axis` x `cfg.mesh_model_axis` (parallel/mesh.py; -1 data
takes the rest of the world), or the mesh passed as `mesh=`. Each data
index trains on its shard of every epoch with the global-batch steps of
train/steps.py and evaluates its shard of the eval set before the gather;
every rank scores the merged set. With a model axis > 1 the generator is
built whole from the seed (and the checkpoint) on every rank and then keeps
its rows of the vocab head and their Adam moments (`shard_train_state`, as
JAX initialises and then lays the state out); model peers hold the same
rows, and the in-training eval decodes with the head split. A vocabulary
that does not divide by the model axis leaves the head replicated, as in
JAX (the leader says so once). Only the leader (rank 0) prints, logs, plots
and traces; a save point gathers the split tensors on every rank and the
leader writes them whole, and every rank waits at a barrier after it.
`train_batch_size` is the batch of one data index, as the per-host batch is
in the JAX package. A model axis > 1 needs a process group (without one the
mesh is 1 x 1 and `make_mesh` raises).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides
from dlsg_tpu_torch.data.loader import eval_batches, train_batches
from dlsg_tpu_torch.data.parallel_loader import WorkerPool
from dlsg_tpu_torch.data.prefetch import prefetch_to_device
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.evaluation.evaluate import evaluate
from dlsg_tpu_torch.evaluation.results import ResultHandler
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapBaseline1, CapGnnModel, CapModel
from dlsg_tpu_torch.models.glove import graft_word_embedding, load_glove_matrix
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_train_state, whole_state_dict
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer, multistep_lr
from dlsg_tpu_torch.train.schedule import saving_schedule, scheduled_sampling_epsilon
from dlsg_tpu_torch.train.steps import (
    make_ce_train_step,
    make_gan_train_step,
    make_legacy_ce_train_step,
)
from dlsg_tpu_torch.utils.logging import MetricsWriter
from dlsg_tpu_torch.utils.plots import plot_alpha_all
from dlsg_tpu_torch.utils.profiler import Stopwatch, start_trace, stop_trace
from dlsg_tpu_torch.vocab import Vocabulary

G_LR_MILESTONES = (4, 7)  # run_gun.py:94
D_LR_MILESTONES = (1, 4)  # run_gun.py:99
LR_GAMMA = 0.5


def _refuse_unsupported(cfg: DLSGConfig) -> None:
    if not dist.is_distributed() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "WORLD_SIZE > 1 but no process group: pass --distributed (or call "
            "parallel.init_distributed) in every process"
        )
    if cfg.use_pallas_lstm:
        raise ValueError(
            "use_pallas_lstm: the lstm_scan kernel has no backward (neither has "
            "the JAX package's); train with it off"
        )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _TrainerBase:
    def __init__(
        self,
        cfg: DLSGConfig,
        vocab: Vocabulary,
        train_dataset,
        eval_dataset,
        test_reference: Dict,
        is_debug: bool = True,
        resume_epoch: Optional[Union[int, str]] = None,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        cfg = apply_dataset_overrides(cfg)
        _refuse_unsupported(cfg)
        if mesh is None:
            mesh = make_mesh(cfg.mesh_data_axis, cfg.mesh_model_axis)
        dist.set_mesh(mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.vocab = vocab
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.test_reference = test_reference
        self.base_name = cfg.base_name()
        self.is_leader = dist.is_leader()
        self.stopwatch = Stopwatch()
        self._worker_pool: Optional[WorkerPool] = None  # started by the first epoch that needs it
        self._trace = None  # the torch.profiler trace of cfg.profile_dir, while on
        self.last_epoch = -1
        # "latest" resolves to the highest epoch_N checkpoint on disk, or a
        # fresh start when there is none
        if resume_epoch == "latest":
            resume_epoch = ckpt.latest_epoch(cfg.checkpoint_dir)
            self._print(
                f"auto-resume: latest checkpoint epoch = {resume_epoch}"
                if resume_epoch is not None
                else "auto-resume: no checkpoint found, starting fresh"
            )
        elif isinstance(resume_epoch, str):
            resume_epoch = int(resume_epoch)
        self.resume_epoch = resume_epoch

        self.result_handler = ResultHandler(
            self.base_name,
            results_root=cfg.result_dir,
            beam_list=[cfg.beam_size],
            is_leader=self.is_leader,
            is_debug=is_debug,
        )
        self.writer = MetricsWriter(
            log_dir=f"{cfg.result_dir}/{self.base_name}/logs", enabled=self.is_leader
        )

    def _print(self, *args) -> None:
        if self.is_leader:
            print(*args)

    def _gen_optimizer(self):
        """Generator optimizer; freezes the word embedding when configured
        (requires_grad=False in the reference, model.py:52-53)."""
        frozen = ("word_embed",) if self.cfg.freeze_word_embed else ()
        return make_optimizer(self.cfg.learning_rate, frozen_paths=frozen)

    def _maybe_graft_glove(self, model) -> None:
        """Replace the decoder's word embedding with GloVe vectors when
        cfg.use_glove (layer.py:307-309,352-386). Only the leader reads the
        file and writes its cache (no two ranks write one file); the others
        get the rows from its broadcast (`_place_generator`)."""
        cfg = self.cfg
        if not cfg.use_glove or not self.is_leader:
            return
        matrix = load_glove_matrix(self.vocab, cfg.word_size, cfg.glove_path, cfg.glove_cache_npy_path)
        model.load_state_dict(graft_word_embedding(model.state_dict(), matrix))
        self._print(f"GloVe embedding grafted from {cfg.glove_path}")

    def _place_generator(self) -> None:
        """Every rank starts from rank 0's generator (equal already: the same
        seed, or the same checkpoint), whole; then keeps its rows of the
        vocab head and of their Adam moments."""
        dist.broadcast_module(self.gen_model)
        if not shard_train_state(self.gen_state, self.mesh) and self.mesh.n_model > 1:
            self._print(
                f"mesh_model_axis={self.mesh.n_model} does not divide the "
                f"{self.gen_model.vocab_size}-word vocabulary: the vocab head stays "
                "replicated (as in the JAX package)"
            )

    def _slice_batch(self, batch):
        """Host-side trim before staging: regions to num_obj, captions to
        max_words (run_gun.py:158-159)."""
        batch = dict(batch)
        batch["regions"] = batch["regions"][:, :, : self.cfg.num_obj, :]
        batch["captions"] = batch["captions"][:, : self.cfg.max_words]
        return batch

    def _host_batches(self, epoch: int):
        """The epoch's host batches of this rank's shard: from the worker pool when
        cfg.loader_workers > 0 and the dataset can be rebuilt in a worker
        (`spawn_spec`), else in-process. The pool starts once and persists
        across epochs; `_close_loader` stops it."""
        cfg = self.cfg
        shard = dict(seed=cfg.seed, epoch=epoch, shard_index=dist.data_rank(),
                     num_shards=dist.data_size())
        if cfg.loader_workers > 0 and hasattr(self.train_dataset, "spawn_spec"):
            if self._worker_pool is None:
                self._worker_pool = WorkerPool(
                    self.train_dataset, cfg.train_batch_size, num_workers=cfg.loader_workers
                )
            return self._worker_pool.epoch_batches(**shard)
        return train_batches(self.train_dataset, cfg.train_batch_size, **shard)

    def _close_loader(self) -> None:
        if self._worker_pool is not None:
            self._worker_pool.close()
            self._worker_pool = None

    def _batches(self, epoch: int, steps: int):
        """The epoch's first `steps` shuffled training batches of this rank's
        shard, prefetched to the device. The caller closes the generator."""
        host = itertools.islice(self._host_batches(epoch), steps)
        host = (self._slice_batch(b) for b in host)
        return prefetch_to_device(host, self.device, stage_dtype=self.cfg.stage_dtype)

    def _run_eval(self, epoch: int, global_step: int):
        with self.stopwatch.span("eval"):
            return self._run_eval_inner(epoch, global_step)

    def _run_eval_inner(self, epoch: int, global_step: int):
        cfg = self.cfg
        t0 = time.time()
        scores, results, alpha_all, infer_time = evaluate(
            self.decode_fn,
            eval_batches(self.eval_dataset, cfg.test_batch_size,
                         shard_index=dist.data_rank(), num_shards=dist.data_size()),
            self.vocab,
            self.test_reference,
            stage_dtype=cfg.stage_dtype,
        )
        self._print(f"evaluate time: {time.time() - t0:.3f}s (inference {infer_time:.3f}s)")
        if alpha_all is not None and self.is_leader:
            # heatmap of the first clip's proposal attention (run_gun.py:455-465)
            first_vid, first_cap = next(iter(results.items()))
            plot_alpha_all(
                alpha_all[:1],
                cfg.num_proposals,
                title=first_cap,
                out_dir=f"{cfg.result_dir}/{self.base_name}/images",
                epoch=epoch,
                step=global_step,
                vid=int(first_vid),
            )
        for tag in ("Bleu_4", "METEOR", "CIDEr", "ROUGE_L"):
            if tag in scores:
                self.writer.add_scalar(f"results/{tag}", scores[tag], global_step)
        trigger = self.result_handler.update_result([scores], [results], epoch)
        return scores, trigger


class RunGAN(_TrainerBase):
    """Full D-LSG adversarial trainer (run_gun.py:19-320). Runs on `device`,
    default `cuda`; pass ``device="cpu"`` for the CPU."""

    def __init__(self, cfg, vocab, train_dataset, eval_dataset, test_reference, **kw):
        super().__init__(cfg, vocab, train_dataset, eval_dataset, test_reference, **kw)
        cfg = self.cfg
        V = len(vocab)
        self.gen_model = CapGnnModel(cfg, V, device=self.device)  # seeded with cfg.seed
        self._maybe_graft_glove(self.gen_model)
        self.use_visual_gan = cfg.use_visual_gan
        self.gen_state = TrainState.create(self.gen_model, self._gen_optimizer())
        self.disc_model = self.disc_state = None
        if self.use_visual_gan:
            self.disc_model = DiscV2(
                cfg, V, generator=torch.Generator().manual_seed(cfg.seed + 1), device=self.device
            )
            self.disc_state = TrainState.create(self.disc_model, make_optimizer(cfg.learning_rate))
            self.gan_step = make_gan_train_step(self.gen_model, self.disc_model, cfg)
        self.ce_step = make_ce_train_step(self.gen_model, cfg)
        self.decode_fn = make_decode_fn(
            self.gen_model, cfg, return_alpha=cfg.plot_attention, device=self.device
        )
        # device-side adaptive lambda state (run_gun.py:210-231 ordering)
        self.lambda_state = init_lambda_state(cfg.lambda_D_visual, device=self.device)

        if self.resume_epoch is not None:  # run_gun.py:53-61
            restored = ckpt.restore_train(
                cfg.checkpoint_dir,
                self.resume_epoch,
                self.gen_state,
                self.disc_state,
                lambda_state=self.lambda_state,
            )
            if restored["gan_lambda_state"] is not None:
                self.lambda_state = restored["gan_lambda_state"]
            self.last_epoch = restored["epoch"]
        if self.disc_model is not None:
            dist.broadcast_module(self.disc_model)
        self._place_generator()

    def _save_point(self, epoch: int, trigger: Optional[str]) -> None:
        """The best model (when the leader's `trigger` names its metric; the
        other ranks get None) and the epoch's train checkpoint: split
        tensors gathered on every rank, written whole by the leader; then a
        barrier."""
        cfg = self.cfg
        if self.result_handler.save_enabled:
            params = whole_state_dict(self.gen_model)  # every rank joins the gather
            if self.is_leader and trigger:
                ckpt.save_model(cfg.checkpoint_dir, f"best_{trigger}", params)
            ckpt.save_train(cfg.checkpoint_dir, epoch, self.gen_state, self.disc_state,
                            lambda_state=self.lambda_state)
        dist.barrier()  # no rank runs ahead of a checkpoint being written

    def train(self) -> ResultHandler:
        """Train from `last_epoch + 1` to `cfg.epoch_num`, inside a process
        group on this rank's shard of every epoch."""
        try:
            return self._train_epochs()
        finally:
            self._close_loader()  # the worker pool, also when a step raises

    def _train_epochs(self) -> ResultHandler:
        cfg = self.cfg
        # every rank runs exactly `steps` steps: a rank whose shard holds one
        # more batch would enter a collective alone and hang
        steps = len(self.train_dataset) // cfg.train_batch_size // dist.data_size()
        total_step = max(1, steps)
        loss_count = loss_count_g = loss_count_d = 0.0

        for epoch in range(self.last_epoch + 1, cfg.epoch_num):
            start_time = time.time()
            # MultiStepLR (run_gun.py:94-104)
            g_lr = multistep_lr(cfg.learning_rate, G_LR_MILESTONES, LR_GAMMA, epoch)
            d_lr = multistep_lr(cfg.learning_rate, D_LR_MILESTONES, LR_GAMMA, epoch)
            self.gen_state.set_learning_rate(g_lr)
            if self.use_visual_gan:
                self.disc_state.set_learning_rate(d_lr)
            self._print(f"Epoch-{epoch} lr: {g_lr}")
            if self.use_visual_gan:
                self._print(f"Epoch-{epoch} lr visual GAN: {d_lr}")
            schedule = saving_schedule(epoch, total_step, cfg.dataset)
            epsilon = scheduled_sampling_epsilon(cfg.ss_factor, epoch, "msvd")

            # One-step-lagged metric consumption: reading step i's metrics
            # (the host sync) waits until step i+1 has been launched, so the
            # copy and the logging overlap the next step's device work. The
            # log and scalars.jsonl come out in the eager loop's order.
            def _consume(p):
                nonlocal loss_count, loss_count_g, loss_count_d
                i, global_step, metrics, vid0, caps = p
                cap_loss = float(metrics["cap_loss"])  # host sync
                if self.use_visual_gan:
                    gan_lambda = float(metrics["gan_lambda"])
                    loss_count_g += float(metrics["loss_G"])
                    loss_count_d += float(metrics["loss_D"])
                    self.writer.add_scalar("Loss/G_v_loss", float(metrics["loss_G"]), global_step)
                    self.writer.add_scalar("Loss/D_loss_visual", float(metrics["loss_D"]), global_step)
                    self.writer.add_scalar(
                        "Loss/wasserstein_visual", float(metrics["wasserstein"]), global_step
                    )
                    self.writer.add_scalar("parameter/gan_lambda", gan_lambda, global_step)
                loss_count += cap_loss
                self.writer.add_scalar("Loss/cap_loss", cap_loss, global_step)

                if i % cfg.log_every == 0:  # run_gun.py:236-261
                    n = float(cfg.log_every)
                    msg = (
                        f"Epoch [{epoch}/{cfg.epoch_num}], Step [{i}/{total_step}], "
                        f"Loss: {loss_count / n:.4f}, "
                        f"Perplexity: {np.exp(loss_count / n):.4f}"
                    )
                    if self.use_visual_gan:
                        msg += f", loss_G: {loss_count_g / n:.4f}, loss_D: {loss_count_d / n:.4f}"
                    loss_count = loss_count_g = loss_count_d = 0.0
                    if self.is_leader:
                        we = self.vocab.decode_tokens(_host(metrics["sample_tokens"]))
                        gt = self.vocab.decode_tokens(_host(caps[0]))
                        print(f"{msg}\n[vid:{vid0}]\nWE: {we}\nGT: {gt}")

            pending = None
            batches = self._batches(epoch, steps)
            try:
                for i, batch in enumerate(batches, start=1):
                    if cfg.dataset == "msr-vtt":  # per-step variant (run_gun.py:149-151)
                        epsilon = scheduled_sampling_epsilon(
                            cfg.ss_factor, epoch, "msr-vtt", i, total_step
                        )
                    global_step = i + epoch * total_step
                    step_batch = {k: batch[k] for k in ("frames", "regions", "captions", "lengths")}

                    # trace of steps 3..5 of the first epoch this run trains
                    if (cfg.profile_dir and self.is_leader and self._trace is None
                            and epoch == self.last_epoch + 1 and i == 3):
                        self._trace = start_trace(cfg.profile_dir)
                    with self.stopwatch.span("train_step"):
                        if self.use_visual_gan:
                            self.gen_state, self.disc_state, self.lambda_state, metrics = self.gan_step(
                                self.gen_state, self.disc_state, self.lambda_state,
                                step_batch, cfg.seed, epsilon,
                            )
                        else:
                            self.gen_state, metrics = self.ce_step(
                                self.gen_state, step_batch, cfg.seed, epsilon
                            )
                        if pending is not None:
                            _consume(pending)  # syncs on step i-1 while i runs
                    pending = (i, global_step, metrics, int(batch["video_ids"][0]), batch["captions"])
                    if self._trace is not None and i >= 5:
                        _consume(pending)  # let step i finish so the trace is whole
                        pending = None
                        self._stop_trace()

                    if i in schedule:  # mid-epoch eval (run_gun.py:262-310)
                        if pending is not None:
                            _consume(pending)
                            pending = None
                        scores, trigger = self._run_eval(epoch, global_step)
                        self._save_point(epoch, trigger)
            finally:
                batches.close()

            if pending is not None:  # flush the last step's lagged metrics
                _consume(pending)
                pending = None
            if self._trace is not None:  # the epoch had < 5 batches
                self._stop_trace()
            self.result_handler.print_results()
            self._print(f"*******One epoch time: {time.time() - start_time:.3f}s*******")
            self._print(self.stopwatch.report() + "\n")
        return self.result_handler

    def _stop_trace(self) -> None:
        stop_trace(self._trace, self.cfg.profile_dir)
        self._trace = None


class Run(_TrainerBase):
    """CE-only baseline trainer over CapBaseline1 (run_graph.py:16-200). Runs
    on `device`, default `cuda`; pass ``device="cpu"`` for the CPU. It
    keeps no training checkpoint, so `resume_epoch` must be None."""

    def __init__(self, cfg, vocab, train_dataset, eval_dataset, test_reference, **kw):
        if kw.get("resume_epoch") is not None:
            raise ValueError(
                f"{type(self).__name__} keeps no training checkpoints (as run_graph.py and "
                "run.py): only RunGAN resumes"
            )
        super().__init__(cfg, vocab, train_dataset, eval_dataset, test_reference, **kw)
        cfg = self.cfg
        self.gen_model = self._build_generator(len(vocab))  # seeded with cfg.seed
        self.gen_state = TrainState.create(self.gen_model, self._optimizer())
        self.ce_step = self._make_step()
        # the reference scores the baselines through the same beam-sized
        # evaluate() as the GAN trainer (run_graph.py:183, beam from opt.py:22)
        self.decode_fn = make_decode_fn(self.gen_model, cfg, beam_size=cfg.beam_size,
                                        device=self.device)
        self._place_generator()

    def _build_generator(self, vocab_size: int):
        model = CapBaseline1(self.cfg, vocab_size, device=self.device)
        self._maybe_graft_glove(model)
        return model

    def _optimizer(self):
        return self._gen_optimizer()

    def _make_step(self):
        return make_ce_train_step(self.gen_model, self.cfg)

    def train(self) -> ResultHandler:
        """Train epochs 0 to `cfg.epoch_num`, inside a process group on this
        rank's shard of every epoch."""
        try:
            return self._train_epochs()
        finally:
            self._close_loader()  # the worker pool, also when a step raises

    def _train_epochs(self) -> ResultHandler:
        cfg = self.cfg
        steps = len(self.train_dataset) // cfg.train_batch_size // dist.data_size()  # RunGAN's rule
        total_step = max(1, steps)
        loss_count = 0.0
        for epoch in range(self.last_epoch + 1, cfg.epoch_num):
            start = time.time()
            lr = multistep_lr(cfg.learning_rate, G_LR_MILESTONES, LR_GAMMA, epoch)
            self.gen_state.set_learning_rate(lr)
            self._print(f"Epoch-{epoch} lr: {lr}")
            epsilon = scheduled_sampling_epsilon(cfg.ss_factor, epoch)
            schedule = saving_schedule(epoch, total_step, cfg.dataset)

            # RunGAN's one-step-lagged metric consumption
            def _consume(p):
                nonlocal loss_count
                i, metrics = p
                cap_loss = float(metrics["cap_loss"])  # host sync
                loss_count += cap_loss
                self.writer.add_scalar("Loss/cap_loss", cap_loss, i + epoch * total_step)
                if i % cfg.log_every == 0:
                    n = float(cfg.log_every)
                    self._print(
                        f"Epoch [{epoch}/{cfg.epoch_num}], Step [{i}/{total_step}], "
                        f"Loss: {loss_count / n:.4f}, Perplexity: {np.exp(loss_count / n):.4f}"
                    )
                    loss_count = 0.0

            pending = None
            batches = self._batches(epoch, steps)
            try:
                for i, batch in enumerate(batches, start=1):
                    with self.stopwatch.span("train_step"):
                        self.gen_state, metrics = self.ce_step(self.gen_state, batch, cfg.seed, epsilon)
                        if pending is not None:
                            _consume(pending)  # syncs on step i-1 while i runs
                    pending = (i, metrics)
                    if i in schedule:
                        _consume(pending)
                        pending = None
                        self._run_eval(epoch, i + epoch * total_step)
            finally:
                batches.close()
            if pending is not None:
                _consume(pending)
            self.result_handler.print_results()
            self._print(f"*******One epoch time: {time.time() - start:.3f}s*******\n")
        return self.result_handler


class RunLegacy(Run):
    """Frames-only legacy trainer over CapModel (reference run.py:16-128):
    Run's schedule with CapModel's own step, and an optimizer that freezes
    nothing; no GloVe."""

    def _build_generator(self, vocab_size: int):
        return CapModel(self.cfg, vocab_size, device=self.device)

    def _optimizer(self):
        return make_optimizer(self.cfg.learning_rate)

    def _make_step(self):
        return make_legacy_ce_train_step(self.gen_model, self.cfg)
