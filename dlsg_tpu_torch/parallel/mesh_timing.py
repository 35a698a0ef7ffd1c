"""Time RunGAN on a mesh of ranks: its GAN steps, the collectives inside
them and the split vocab head's merges in the eval decode. A measurement,
not a path of the package.

    torchrun --nproc_per_node=4 -m dlsg_tpu_torch.parallel.mesh_timing \\
        --mesh_data_axis 2 --mesh_model_axis 2

One process per card over NCCL (gloo with `--device cpu`). RunGAN at
MSR-VTT widths: fp32 compute, the fused vocab head, a 10 000-word synthetic
vocabulary, `--videos` synthetic videos x 2 captions with `--batch` rows a
data index (2 GAN steps of 64 by default), one eval after the last step,
learning rate 1e-7. Each GAN step, each all-gather and each all-reduce
inside a step (over the model group and over the data group apart) and each
merge of the split head's top-k is timed with the device synced before and
after it, so the timed run carries those syncs. Rank 0 prints one JSON line
with every rank's numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as tdist

from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.evaluation import decode as decode_mod
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.parallel.mesh import Mesh, make_mesh
from dlsg_tpu_torch.train import trainer as trainer_mod

VOCAB = 10000
HEAD = ("decoder.step.word_restore.weight", "decoder.step.word_restore.bias")


@contextlib.contextmanager
def synced_timer(obj, name: str, log: List[float], sync: Callable[[], None],
                 keep=lambda *a, **kw: True):
    """Replace `obj.name` while the block runs with a wrapper that appends
    the milliseconds of each call `keep` accepts, `sync` run before and
    after it."""
    real = getattr(obj, name)

    def wrapper(*args, **kw):
        if not keep(*args, **kw):
            return real(*args, **kw)
        sync()
        t = time.perf_counter()
        out = real(*args, **kw)
        sync()
        log.append(1e3 * (time.perf_counter() - t))
        return out

    setattr(obj, name, wrapper)
    try:
        yield
    finally:
        setattr(obj, name, real)


def msr_vtt_config(result_dir: str, n_model: int, batch: int, lr: float = 1e-7) -> DLSGConfig:
    """The measured configuration (module doc)."""
    return apply_dataset_overrides(DLSGConfig(
        dataset="msr-vtt", compute_dtype="float32", use_fused_vocab_head="on", epoch_num=1,
        train_batch_size=batch, test_batch_size=batch, learning_rate=lr,
        mesh_model_axis=n_model, result_dir=result_dir))


def timed_run_gan(result_dir: str, device, mesh: Optional[Mesh], videos: int = 64,
                  batch: int = 64) -> dict:
    """One epoch of RunGAN (module doc) in this process, on `mesh` (None:
    one process without a group). Returns the eval's token ids, each GAN
    step's ms, the steps' collectives (ms per step, calls per step), the
    merges' ms, the step counters, peak device memory, the head's rows and
    a digest of the replicated parameters."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = msr_vtt_config(result_dir, 1 if mesh is None else mesh.n_model, batch)
    vocab = make_vocab(extra_words=VOCAB - len(make_vocab()))
    ds = SyntheticDataset(cfg, vocab, num_videos=videos, captions_per_video=2)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = trainer_mod.RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, is_debug=False,
                             device=device, mesh=mesh)
    step_ms, gather_ms, model_ms, data_ms, merge_ms, ids = [], [], [], [], [], []
    real_decode = run.decode_fn

    def decode(*args):
        out = real_decode(*args)
        ids.append((out[0] if isinstance(out, tuple) else out).cpu())  # (ids, alpha) with plot_attention
        return out

    in_step = [False]  # the collectives timed are the GAN steps' own
    real_step = run.gan_step

    def gan_step(*args):
        in_step[0] = True
        try:
            return real_step(*args)
        finally:
            in_step[0] = False

    run.decode_fn, run.gan_step = decode, gan_step
    split = mesh is not None and mesh.n_model > 1

    def on_model(*a, group=None, **kw):
        return in_step[0] and split and group is mesh.model_group

    def on_data(*a, group=None, **kw):
        return in_step[0] and not on_model(group=group)

    real_schedule = trainer_mod.saving_schedule
    trainer_mod.saving_schedule = lambda epoch, total, dataset: {total}
    try:
        with synced_timer(run, "gan_step", step_ms, sync), \
                synced_timer(dist, "all_gather_tensors", gather_ms, sync, lambda *a: in_step[0]), \
                synced_timer(tdist, "all_reduce", model_ms, sync, on_model), \
                synced_timer(tdist, "all_reduce", data_ms, sync, on_data), \
                synced_timer(decode_mod, "sharded_vocab_head_topk", merge_ms, sync):
            run.train()
    finally:
        trainer_mod.saving_schedule = real_schedule
    wr = run.gen_model.decoder.step.word_restore
    st = run.gen_state.optimizer.state[wr.weight]
    digest = hashlib.sha256()
    for model in (run.gen_model, run.disc_model):
        for k, t in model.state_dict().items():
            if k not in HEAD:
                digest.update(t.detach().cpu().numpy().tobytes())
    n = max(len(step_ms), 1)
    return {
        "ids": torch.cat(ids) if ids else None, "steps_g_d": [run.gen_state.step, run.disc_state.step],
        "step_ms": step_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "gather_ms_per_step": sum(gather_ms) / n,
        "model_all_reduce_ms_per_step": sum(model_ms) / n,
        "data_all_reduce_ms_per_step": sum(data_ms) / n,
        "calls_per_step": {"all_gather": len(gather_ms) / n, "model_all_reduce": len(model_ms) / n,
                           "data_all_reduce": len(data_ms) / n},
        "merge_ms_per_beam_step": sum(merge_ms) / len(merge_ms) if merge_ms else None,
        "merges": len(merge_ms),
        "head_rows": [wr.weight.shape[0], st["exp_avg"].shape[0], st["exp_avg_sq"].shape[0]],
        "out_shard": wr.out_shard, "replicated_digest": digest.hexdigest(),
        "checkpoint_dir": cfg.checkpoint_dir,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh_data_axis", type=int, default=-1)
    p.add_argument("--mesh_model_axis", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--videos", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    args = p.parse_args(argv)
    device = dist.init_distributed(args.device)
    try:
        mesh = make_mesh(args.mesh_data_axis, args.mesh_model_axis)
        with tempfile.TemporaryDirectory(prefix="mesh_timing_") as work:  # the leader's checkpoints
            t = time.perf_counter()
            res = timed_run_gan(work, device, mesh, args.videos, args.batch)
            res["seconds"] = time.perf_counter() - t
        res.pop("ids")
        res.pop("checkpoint_dir")
        res["rank"], res["mesh_index"] = dist.rank(), [mesh.data_index, mesh.model_index]
        ranks = [None] * dist.world_size()
        tdist.all_gather_object(ranks, res)
        if dist.is_leader():
            info = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                    "backend": tdist.get_backend(), "mesh": mesh.shape, "videos": args.videos,
                    "batch_per_data_index": args.batch}
            print(json.dumps({"mesh_timing": info, "ranks": ranks}), flush=True)
    finally:
        dist.set_mesh(None)
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
