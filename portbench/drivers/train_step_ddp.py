"""The WGAN-GP train step data-parallel over `ranks` cards, as `RunGAN`
runs under `torchrun --nproc_per_node=<ranks>`: one process a card in one
process group (NCCL on cards, gloo on the CPU), the whole world the data
axis, each rank's gradients summed by `all_reduce_grads` before every
update.

This process is rank 0; it starts ranks 1.. as processes of this file
(`python3 portbench/drivers/train_step_ddp.py <job.json>`, the job the run's
arguments, configuration and traffic), each on its own card. Every rank
builds `make_gan_train_step` from the seed's weights, which rank 0's copy
then overwrites on every rank (`broadcast_module`), and is fed by
`prefetch_to_device` from its block of `batch` rows of each of
`distinct_batches` global batches of `ranks` x `batch` distinct clips.

Set-up runs the first `first_steps` steps on the global batches' first
ones; what rank 0 recorded of them is held to the plain reference's steps
over the global batches (`training.check`), its per-row draws laid out as
`rank_block_rand` lays the ranks' blocks (`rank_layout`). The window: steps back to back
until rank 0's clock passes `--seconds`; rank 0's decision reaches the
others by a broadcast that each reads a step later, where the trainer's
lagged read of the loss waits anyway, so every rank runs the same steps.
End-to-end: train_clips_per_s, ranks x batch x the steps of the window
over its seconds on rank 0's clock, every rank synchronised at its end.
Under `--trace 1` the same loop runs a window untraced before the traced
one, which rank 0 traces.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:  # started as a rank's process
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import harness, inputs, training, work  # noqa: E402
from portbench.harness import Outcome, Run, free, peak_bytes, quarters, sync  # noqa: E402
from portbench.trace import Tracer  # noqa: E402

JOIN_SECONDS = 300  # how long a rank waits for the others at a collective


def global_batch(r: Run, i: int, device, rows: slice = slice(None)) -> Dict[str, np.ndarray]:
    """Global batch `i`, ranks x batch distinct clips and their captions,
    or its `rows`, on the host."""
    tr, md = r.traffic, r.model_dict("training")
    n, T = tr["ranks"] * tr["batch"], md["max_frames"]
    fr, rg = inputs.clip_pool(n, (T, md["a_feature_size"] + md["m_feature_size"]),
                              (T, md["num_obj"], md["region_feature_size"]), r.seed, device, i)
    caps, lens = inputs.caption_batch(n, md["max_words"], r.config["vocab_size"],
                                      r.config["mean_caption_words"], r.seed, i)
    out = {"frames": fr[rows].cpu().numpy(), "regions": rg[rows].cpu().numpy(),
           "captions": caps[rows], "lengths": lens[rows]}
    del fr, rg
    free(device)
    return out


@contextlib.contextmanager
def rank_layout(world: int, rows: int):
    """The reference's draws laid out as `rank_block_rand` lays the ranks'
    blocks. A draw over `rows` global rows already is: one draw of
    (world, rows / world, ...) is one of (rows, ...). D's grouped pass runs
    over real | fake, 2 x `rows` rows, where each rank draws (world, 2 x
    rows / world, ...) and keeps its block of its own real rows then its
    own fake ones; here that draw is laid out back into real | fake."""
    import torch

    from portbench.reference import model as ref

    orig = ref.Draws.rand

    def rand(self, shape, device):
        if world == 1 or not shape or shape[0] != 2 * rows:
            return orig(self, shape, device)
        per, rest = rows // world, tuple(shape[1:])
        d = torch.rand((world, 2 * per, *rest), generator=self.gen, device=device)
        return torch.cat([d[:, :per].reshape(rows, *rest), d[:, per:].reshape(rows, *rest)])

    ref.Draws.rand = rand
    try:
        yield
    finally:
        ref.Draws.rand = orig


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def start_ranks(r: Run, port: int, job: str) -> List[subprocess.Popen]:
    """Ranks 1.. as processes of this file, given the run in the file
    `job`, their output on this one's standard error."""
    world = r.traffic["ranks"]
    with open(job, "w") as f:
        json.dump({"args": vars(r.args), "cell": r.cell, "config": r.config, "traffic": r.traffic,
                   "device": r.device.type}, f)
    procs = []
    for k in range(1, world):
        env = dict(os.environ, **_rank_env(k, world, port))
        if r.device.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen([sys.executable, __file__, job], env=env, cwd=str(ROOT),
                                      stdout=sys.stderr.fileno(), stderr=sys.stderr.fileno()))
    return procs


def train_rank(r: Run, rank: int) -> SimpleNamespace:
    """One rank's part: join the group, build, run the first steps and the
    window(s). Rank 0 returns what its run records; the others None."""
    import datetime

    import torch

    from dlsg_tpu_torch.data.prefetch import prefetch_to_device
    from dlsg_tpu_torch.parallel import dist

    tr, md = r.traffic, r.model_dict("training")
    dev = dist.init_distributed("cpu" if r.device.type == "cpu" else None,
                                timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    r.device = dev
    r.log(f"rank {rank} of {dist.world_size()} joined on {dev}")
    B, world = tr["batch"], tr["ranks"]
    mine = slice(rank * B, (rank + 1) * B)
    batches = [global_batch(r, i, dev, mine) for i in range(tr["distinct_batches"])]
    cfg = r.program_config("training")
    prog = training.Program(r, cfg, dev)
    dist.broadcast_module(prog.gen)
    dist.broadcast_module(prog.disc)
    feed = prefetch_to_device(itertools.cycle(batches), dev, stage_dtype=cfg.stage_dtype)
    key, eps = r.seed, md["epsilon"]
    first = []
    for i in range(tr["first_steps"]):
        m = prog.step(next(feed), key, eps)
        first.append({k: float(v) for k, v in m.items() if k != "sample_tokens"})
        if i == 0 and rank == 0:
            prog.record_first_grads()
    if rank == 0:
        prog.record_changes()
        r.log(f"first steps: {first}")
    sync(dev)
    peak_setup = peak_bytes(dev, reset=True)

    ends: List[float] = []
    pending = None

    def train(seconds: float, tracer: Tracer):
        """Steps back to back until rank 0 has seen `seconds` pass, every
        rank synchronised at the end: (the window's seconds, its steps)."""
        nonlocal pending
        start, t0 = len(ends), time.perf_counter()
        seen = None
        while True:
            with tracer.span("portbench.next_batch"):
                batch = next(feed)
            with tracer.span("portbench.train_step"):
                m = prog.step(batch, key, eps)
                if pending is not None:  # the trainer's lagged read of the step before
                    float(pending["cap_loss"])
            pending = m
            ends.append(time.perf_counter())
            done = rank == 0 and time.perf_counter() - t0 >= seconds
            flag = torch.tensor([int(done)], dtype=torch.int32, device=dev)
            torch.distributed.broadcast(flag, src=0)
            if seen is not None and int(seen):  # rank 0's word of the step before
                break
            seen = flag
        float(pending["cap_loss"])
        dist.barrier()
        sync(dev)
        window = time.perf_counter() - t0
        r.log(f"window {window:.3f}s: {len(ends) - start} steps; step seconds by quarter of "
              f"the run {quarters(ends[start:], t0)}")
        return window, len(ends) - start

    step_flops = work.gan_step_flops(md, B * world, r.config["vocab_size"])
    tracer = Tracer(bool(r.args.trace) and rank == 0, dev)
    if rank == 0:
        r.window_started()
    counters = {}
    if r.args.trace:  # the same window untraced first: the profiler slows the host
        plain_s, plain_steps = train(r.window_seconds(), Tracer(False))
        counters.update(plain_window_s=plain_s, plain_model_flops=step_flops * plain_steps)
    tracer.start()
    window, steps = train(r.window_seconds(), tracer)
    tracer.stop()
    window_peak = peak_bytes(dev)
    feed.close()
    torch.distributed.destroy_process_group()
    if rank != 0:
        return None
    counters.update(steps=steps, clips=steps * B * world, window_s=window,
                    model_flops=step_flops * steps, peak_mem_gb=window_peak / 1e9)
    out = SimpleNamespace(attempted=len(ends), e2e={"train_clips_per_s": steps * B * world / window},
                          records={"counters": counters}, program_view=prog.view(first),
                          memory_peak_bytes=max(peak_setup, window_peak), trace=tracer.summary())
    del prog, feed
    free(dev)
    return out


def run(r: Run) -> Outcome:
    world = r.traffic["ranks"]
    port = _free_port()
    env = {k: os.environ.get(k) for k in _rank_env(0, world, port)}
    os.environ.update(_rank_env(0, world, port))
    fd, job = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    procs: List[subprocess.Popen] = []
    try:
        procs = start_ranks(r, port, job)
        mine = train_rank(r, 0)
        key, eps = r.seed, r.model_dict("training")["epsilon"]
        batches = [global_batch(r, i, r.device) for i in range(r.traffic["first_steps"])]
        with rank_layout(world, world * r.traffic["batch"]):
            checks = training.check(r, batches, mine.program_view, key, eps, r.device)
        for p in procs:
            p.wait(timeout=JOIN_SECONDS)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(job)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    failed = [k + 1 for k, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} ended with an error")
    return Outcome(attempted=mine.attempted, failed=0, e2e=mine.e2e, records=mine.records,
                   checks=checks, memory_peak_bytes=mine.memory_peak_bytes, trace=mine.trace)


def _rank_main(job_path: str) -> int:
    harness.cache_env()
    with open(job_path) as f:
        job = json.load(f)
    rank = int(os.environ["RANK"])
    device = "cpu" if job["device"] == "cpu" else f"cuda:{rank}"
    r = Run(SimpleNamespace(**job["args"]), harness.benchmark(), job["cell"], time.perf_counter(),
            device=device, config=job["config"], traffic=job["traffic"])
    train_rank(r, rank)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))
