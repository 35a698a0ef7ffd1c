"""One rank of a dlsg_tpu_torch mesh job on the CPU (gloo), for
tests/test_torch_tensor_parallel.py and tests/test_torch_mesh.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/helpers/torch_tp_worker.py JOB IN_DIR OUT_FILE

(without RANK in the environment: one process and no process group)

Imports dlsg_tpu_torch only (no jax, no dlsg_tpu). Jobs:

- tp (data 1 x model 2): from IN_DIR's weights and inputs, the
  teacher-forced logits, beam-5 ids with the fused head off and on, the
  int8 decode's (decode_quant="int8": each rank quantizes its columns of the
  head) first beam-step logits and beam-5 ids with the fused head off and
  on, one GAN step and one CE step (dropout off, epsilon 1, the penalty's
  mixing weights given), then the same forward and GAN step with dropout on,
  and those steps again with `decoder_remat="full"`;
- int8 (one process without a group): the same int8 decode with the whole
  head quantized at once, the tp job's reference;
- steps: the GAN and CE steps on this data index's rows of the global
  batch, on a (data 2 x model 2) mesh of 4 ranks, a (data 2) mesh of 2, or
  one process without a group;
- trainer (data 1 x model 2, or one process without a group): RunGAN for
  one synthetic epoch, then (with a group) resumed from its checkpoint for
  one more;
- mesh (4 ranks): meshes, their groups, the data-axis helpers and the
  model-axis autograd functions;
- serve (data 2): Captioner(mesh=) captions, then a CaptionServer on the
  leader (the other rank following) answering an .npz and a greedy request.

Each rank writes its results with torch.save to OUT_FILE.
"""

from __future__ import annotations

import datetime
import io
import json
import os
import sys
import urllib.request

import numpy as np
import torch

V = 40
KEY = 2
LR = 1e-4
BEAM = 5


def _clone(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def _no_dropout():
    from dlsg_tpu_torch.ops import linear

    saved = linear.dropout
    linear.dropout = lambda x, rate, rng: x
    return lambda: setattr(linear, "dropout", saved)


def _state(state):
    """A TrainState's parameters and first moments, local and whole."""
    from dlsg_tpu_torch.parallel.mesh import whole_optimizer_state, whole_state_dict

    opt = whole_optimizer_state(state)
    mu = {n: opt["state"][i]["exp_avg"] for i, n in enumerate(state.names) if i in opt["state"]}
    return {"params": _clone(state.module.state_dict()), "mu": _clone(state.first_moments()),
            "whole_params": _clone(whole_state_dict(state.module)), "whole_mu": _clone(mu),
            "step": state.step}


def _models(cfg, weights, mesh):
    from dlsg_tpu_torch.models.discriminator import DiscV2
    from dlsg_tpu_torch.models.generator import CapGnnModel
    from dlsg_tpu_torch.parallel.mesh import shard_params

    g, d = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
    g.load_state_dict(weights["gen"])
    d.load_state_dict(weights["disc"])
    if mesh is not None:
        shard_params(g, mesh)
    return g, d


def _steps(cfg, weights, data, mesh, rows):
    """One GAN step and one CE step on `rows` of the global batch."""
    from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
    from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
    from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step

    batch = {k: data[k][rows] for k in ("frames", "regions", "captions", "lengths")}
    out = {}
    g, d = _models(cfg, weights, mesh)
    gs, ds = TrainState.create(g, make_optimizer(LR)), TrainState.create(d, make_optimizer(LR))
    gs, ds, lstate, m = make_gan_train_step(g, d, cfg)(
        gs, ds, init_lambda_state(0.01, device="cpu"), batch, KEY, 1.0,
        eps_gp=torch.from_numpy(data["eps_gp"][:, rows]))
    out["gan"] = {"g": _state(gs), "d": _state(ds),
                  "metrics": {k: v.detach().clone() for k, v in m.items()},
                  "lambda": {k: v.clone() for k, v in lstate.items()}}
    g, _ = _models(cfg, weights, mesh)
    gs = TrainState.create(g, make_optimizer(LR))
    gs, m = make_ce_train_step(g, cfg)(gs, batch, KEY, 1.0)
    out["ce"] = {"g": _state(gs), "metrics": {k: v.detach().clone() for k, v in m.items()}}
    return out


def int8_decode(weights, frames, regions, mesh=None) -> dict:
    """The int8 decode of `weights` (its generator; the head split over
    `mesh`'s model axis when given): the raw logits of the first beam step
    from <start>, gathered whole, and the beam-5 ids with the fused head off
    and on."""
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.vocab import START_ID

    qcfg = tiny_test_config(dropout=0.0, beam_size=BEAM, decode_quant="int8")
    g, _ = _models(qcfg, weights, mesh)
    out = {}
    with torch.inference_mode():
        state, pre = g.decoder_init_beam_state(*g.encode(frames, regions))
        start = torch.full((frames.shape[0],), START_ID, dtype=torch.int64)
        out["int8_logits"] = g.decoder_beam_step(start, state, pre)[0].clone()
    for head in ("off", "on"):
        hcfg = tiny_test_config(dropout=0.0, beam_size=BEAM, decode_quant="int8",
                                use_fused_vocab_head=head)
        out[f"int8_ids_{head}"] = make_decode_fn(g, hcfg, device="cpu")(frames, regions)
    return out


def int8_job(in_dir: str) -> dict:
    """One process without a group: the int8 decode of IN_DIR's weights and
    clips with the whole head quantized at once, the split head's
    reference."""
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    data = dict(np.load(os.path.join(in_dir, "batch.npz")))
    return int8_decode(weights, torch.from_numpy(data["frames"]), torch.from_numpy(data["regions"]))


def tp_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=1, n_model=2)
    cfg = tiny_test_config(dropout=0.0, beam_size=BEAM)
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    data = dict(np.load(os.path.join(in_dir, "batch.npz")))
    frames, regions = torch.from_numpy(data["frames"]), torch.from_numpy(data["regions"])
    caps = torch.from_numpy(data["captions"]).long()
    out = {"shard_rows": None}

    restore = _no_dropout()
    try:
        g, _ = _models(cfg, weights, mesh)
        out["shard_rows"] = g.decoder.step.word_restore.weight.shape[0]
        out["out_shard"] = g.decoder.step.word_restore.out_shard
        with torch.no_grad():
            out["logits"] = g(frames, regions, caps)[0].clone()
        for head in ("off", "on"):
            hcfg = tiny_test_config(dropout=0.0, beam_size=BEAM, use_fused_vocab_head=head)
            out[f"ids_{head}"] = make_decode_fn(g, hcfg, device="cpu")(data["frames"], data["regions"])
        out.update(int8_decode(weights, frames, regions, mesh))
        out.update(_steps(cfg, weights, data, mesh, slice(None)))
    finally:
        restore()

    # dropout on: model peers draw the same masks, so their logits and their
    # replicated parameters after a step agree bitwise
    g, _ = _models(cfg, weights, mesh)
    g.train()
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        out["logits_dropout"] = g(frames, regions, caps, 0.5, rng=gen)[0].clone()
    out["dropout_step"] = _steps(tiny_test_config(beam_size=BEAM), weights, data, mesh, slice(None))
    # the same steps with the decoder's scan rematerialized: the recompute
    # runs the logits all-gather again in the backward
    out["dropout_step_remat"] = _steps(tiny_test_config(beam_size=BEAM, decoder_remat="full"),
                                       weights, data, mesh, slice(None))
    return out


def steps_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_model=2 if dist.world_size() == 4 else 1)
    cfg = tiny_test_config(dropout=0.0, beam_size=BEAM)
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    data = dict(np.load(os.path.join(in_dir, "batch.npz")))
    b = data["captions"].shape[0] // mesh.n_data
    d = mesh.data_index
    restore = _no_dropout()
    try:
        return {"mesh": (mesh.data_index, mesh.model_index),
                **_steps(cfg, weights, data, mesh, slice(d * b, (d + 1) * b))}
    finally:
        restore()


def trainer_job(in_dir: str) -> dict:
    from dlsg_tpu_torch import checkpoint as ckpt
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train.trainer import RunGAN

    tp = dist.is_distributed()
    vocab = make_vocab(extra_words=1)  # 40 words: the head splits over model 2
    root = os.path.join(in_dir, "trainer_tp" if tp else "trainer_single")

    def runner(epoch_num, resume=None):
        cfg = tiny_test_config(epoch_num=epoch_num, result_dir=root, train_batch_size=4,
                               test_batch_size=4, beam_size=2, dropout=0.0,
                               mesh_model_axis=2 if tp else 1)
        ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
        return RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, is_debug=False,
                      resume_epoch=resume, device="cpu")

    run = runner(1)
    out = {"layout_before": tuple(run.gen_model.decoder.step.word_restore.weight.shape)}
    run.train()
    wr = run.gen_model.decoder.step.word_restore
    mu = run.gen_state.first_moments()["decoder.step.word_restore.weight"]
    out.update(layout_after=tuple(wr.weight.shape), mu_rows=mu.shape[0],
               nu_rows=run.gen_state.optimizer.state[wr.weight]["exp_avg_sq"].shape[0],
               params=_clone(run.gen_model.state_dict()), steps=run.gen_state.step,
               best=run.result_handler.best("CIDEr"),
               checkpoint=os.path.join(run.cfg.checkpoint_dir, "epoch_0", ckpt.TRAIN_FILE))
    if tp:  # a model-axis resume continues the run from its checkpoint
        dist.barrier()
        run = runner(2, resume="latest")
        out["resumed_from"] = run.last_epoch
        out["resumed_rows"] = run.gen_model.decoder.step.word_restore.weight.shape[0]
        run.train()
        out["steps_after_resume"] = run.gen_state.step
        out["epoch1_checkpoint"] = os.path.join(run.cfg.checkpoint_dir, "epoch_1", ckpt.TRAIN_FILE)
    return out


def mesh_job(in_dir: str) -> dict:
    import torch.distributed as tdist

    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for shape in ((2, 2), (-1, 2), (4, 1), (1, 4)):
        m = make_mesh(*shape)
        x = torch.tensor([float(dist.rank())])
        in_model, in_data = x.clone(), x.clone()
        if m.n_model > 1:
            tdist.all_reduce(in_model, group=m.model_group)
            tdist.all_reduce(in_data, group=m.data_group)
        out[shape] = {"index": (m.data_index, m.model_index), "shape": m.shape,
                      "model_sum": float(in_model), "data_sum": float(in_data),
                      "data_size": dist.data_size(), "data_rank": dist.data_rank()}
    try:
        make_mesh(3, 1)
    except ValueError as e:
        out["bad_product"] = str(e)

    m = make_mesh(2, 2)
    gen = torch.Generator().manual_seed(4)
    out["block_rand"] = dist.rank_block_rand((3, 2), gen, "cpu")
    out["global_sum"] = dist.global_sum(torch.tensor([1.0 + dist.rank()]))
    ids = np.full((1 + m.data_index, 2), dist.rank(), np.int64)
    out["gather_eval"] = dist.gather_eval(ids, np.arange(ids.shape[0]) + 10 * m.data_index, None)

    # the column-split product through copy_to_model / gather_from_model:
    # y = x @ W.T, split by W's rows, against the whole product, to the
    # second derivative
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, generator=g, dtype=torch.float64)
    w = torch.randn(6, 4, generator=g, dtype=torch.float64)
    w_local = w[m.model_index * 3:(m.model_index + 1) * 3]

    def f(xx, split):
        if not split:
            return torch.tanh(xx @ w.t())
        return torch.tanh(dist.gather_from_model(dist.copy_to_model(xx) @ w_local.t()))

    res = {}
    for split in (False, True):
        xx = x.clone().requires_grad_(True)
        y = f(xx, split)
        (gx,) = torch.autograd.grad((y ** 2).sum(), xx, create_graph=True)
        (ggx,) = torch.autograd.grad((gx ** 2).sum(), xx)
        res[split] = (y.detach(), gx.detach(), ggx)
    out["tp_autograd"] = res
    return out


def serve_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.data.synthetic import make_vocab
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import make_mesh
    from dlsg_tpu_torch.serve import Captioner
    from dlsg_tpu_torch.server import CaptionServer, follow

    mesh = make_mesh(n_data=2)
    vocab = make_vocab()
    cfg = tiny_test_config(beam_size=BEAM, use_fused_vocab_head="on")
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    data = dict(np.load(os.path.join(in_dir, "clips.npz")))
    cap = Captioner(cfg, vocab, weights, device="cpu", mesh=mesh)
    out = {n: cap.caption(data["frames"][:n], data["regions"][:n]) for n in (5, 8)}
    out["greedy_5"] = cap.caption(data["frames"][:5], data["regions"][:5], greedy=True)
    if not dist.is_leader():
        out["followed"] = follow(cap)
        return out
    server = CaptionServer(cap, "127.0.0.1", 0)
    thread = server.start_background()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        buf = io.BytesIO()
        np.savez(buf, frames=data["frames"][:5], regions=data["regions"][:5])
        for path, key in (("/caption", "http_npz"), ("/caption?greedy=1", "http_greedy")):
            req = urllib.request.Request(url + path, data=buf.getvalue(), method="POST",
                                         headers={"Content-Type": "application/x-npz"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out[key] = [c["caption"] for c in json.loads(resp.read())["captions"]]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            out["healthz"] = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()  # stops the follower
        thread.join(timeout=60)
    return out


JOBS = {"tp": tp_job, "int8": int8_job, "steps": steps_job, "trainer": trainer_job,
        "mesh": mesh_job, "serve": serve_job}


def main() -> None:
    job, in_dir, out_file = sys.argv[1:4]
    torch.set_num_threads(1)
    from dlsg_tpu_torch.parallel import dist

    if "RANK" in os.environ:
        dist.init_distributed("cpu", timeout=datetime.timedelta(seconds=60))
    try:
        result = JOBS[job](in_dir)
        mods = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "flax", "dlsg_tpu"))
        result["foreign_modules"] = mods
        torch.save(result, out_file)
    finally:
        if dist.is_distributed():
            torch.distributed.destroy_process_group()
    print("WORKER OK", flush=True)


if __name__ == "__main__":
    main()
