"""dlsg_tpu_torch's model axis (parallel/mesh.py, the column-split vocab
head through the forward, the beam decode, the train steps and RunGAN)
against dlsg_tpu's TP layout on the same weights, the counterpart of
tests/test_parallel.py:100,131 and tests/test_trainer.py:73.

Three jobs run once for the module, as real processes on gloo
(tests/helpers/torch_tp_worker.py, which imports dlsg_tpu_torch alone):
- 2 ranks on a (data 1 x model 2) mesh take the teacher-forced logits,
  beam-5 ids with the fused head off and on (the plain K1 on each rank's 20
  columns and the merge), the int8 decode's first-step logits and ids (each
  rank's columns quantized; held bitwise to one process's int8 decode, run
  in this process), one GAN and one CE step (dropout off, epsilon 1,
  the penalty's mixing weights given), then the forward and a GAN step with
  dropout on;
- 4 ranks on a (data 2 x model 2) mesh take the same steps, each data index
  on its half of the global batch; so do 2 ranks on a (data 2) mesh and one
  process without a group on the whole batch, the model axis's references
  for the replicated discriminator;
- RunGAN for one epoch on 2 ranks with mesh_model_axis 2, resumed for a
  second, beside the same epoch in one process without a group.
This process runs JAX meanwhile: `shard_params` + `apply` and the TP beam
decode on make_mesh(1, 2), and the GAN and CE steps with
`shard_train_state` under the (1, 2) and (2, 2) meshes of its 8 virtual CPU
devices.

Tolerances: logits 2e-5 (tests/test_parallel.py:100); ids exactly (:131);
the steps those of tests/test_torch_train_steps.py (Adam moments 1e-4 of
each tensor's max-abs, parameters 1e-5, metrics 1e-5); the epoch 2e-4
(tests/test_trainer.py:73). Replicated tensors are compared across ranks
bitwise, and the head's shards across data peers.

The generator's state (the split head among it) and its metrics (cap
loss, G loss, lambda) are held to JAX's step under the matching mesh. The
discriminator, replicated in both packages, sees the gathered logits, which
the split head makes bitwise the whole head's; so D's state and its metrics
(D loss, Wasserstein estimate, penalty) are held bitwise to the port's same
step without a model axis (one process for (1, 2), the (2) mesh for
(2, 2)), whose agreement with JAX tests/test_torch_parallel.py and
tests/test_torch_train_steps.py hold. JAX is no reference for D at 1e-4
here: its own partitioned steps move D's Adam moments by up to 1.4e-4 of
max-abs from its single-device step on these weights (2.0e-5 on (1, 2),
1.4e-4 on (2, 2), 6.7e-5 on (2, 1)), and its D loss by 1.1e-5.
"""

import jax
import jax.numpy as jnp
import flax.linen
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_decode_fn
from dlsg_tpu.models.discriminator import DiscV2 as JaxDiscV2
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.parallel import mesh as jmesh
from dlsg_tpu.train import gan_lambda as jgl
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.config import apply_dataset_overrides, tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.trainer import RunGAN
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax
from test_torch_parallel import REPO, _eps_gp, _global_batch, collect_ranks, launch_ranks
from test_torch_train_steps import KEY, LR, V, _adam_mu, _identity, check_state
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

WORKER = f"{REPO}/tests/helpers/torch_tp_worker.py"
BEAM = 5
HEAD = ("decoder.step.word_restore.weight", "decoder.step.word_restore.bias")
G_METRICS = ("cap_loss", "loss_G", "gan_lambda")
D_METRICS = ("loss_D", "wasserstein", "grad_penalty")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


def _jax_steps(cfg, weights, batch, mesh):
    """JAX's GAN and CE steps on the global batch, the states laid out by
    `shard_train_state` and the batch over the data axis of `mesh`."""
    gen, disc = JaxCapGnnModel(cfg, V), JaxDiscV2(cfg, V)
    data = jmesh.shard_batch({k: batch[k] for k in ("frames", "regions", "captions", "lengths")},
                             mesh)

    def state(name):
        return jmesh.shard_train_state(
            joptim.TrainState.create(params_to_jax(weights[name]), joptim.make_optimizer(LR)), mesh)

    g, d, _, m = jsteps.make_gan_train_step(gen, disc, cfg)(
        state("gen"), state("disc"), jax.device_put(jgl.init_lambda_state(0.01), jmesh.replicated(mesh)),
        data, jax.random.PRNGKey(KEY), jnp.float32(1.0))
    out = {"gan": {
        "g_mu": params_from_jax(_adam_mu(g.opt_state)), "g_params": params_from_jax(g.params),
        "metrics": {k: np.asarray(v) for k, v in m.items()},
        "head_sharding": g.params["decoder"]["step"]["word_restore"]["kernel"].sharding,
    }}
    g, m = jsteps.make_ce_train_step(gen, cfg)(state("gen"), data, jax.random.PRNGKey(KEY),
                                               jnp.float32(1.0))
    out["ce"] = {"g_mu": params_from_jax(_adam_mu(g.opt_state)), "g_params": params_from_jax(g.params),
                 "metrics": {k: np.asarray(v) for k, v in m.items()}}
    return out


def _jax_reference(cfg, weights, batch):
    """JAX on the (1, 2) and (2, 2) meshes (module doc)."""
    devices = jax.devices()
    mesh12 = jmesh.make_mesh(n_data=1, n_model=2, devices=devices[:2])
    mesh22 = jmesh.make_mesh(n_data=2, n_model=2, devices=devices[:4])
    model = JaxCapGnnModel(cfg, V)
    sharded = jmesh.shard_params(params_to_jax(weights["gen"]), mesh12)
    fr, rg, caps = (jnp.asarray(batch[k]) for k in ("frames", "regions", "captions"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        with mesh12:
            out["logits"] = np.asarray(
                jax.jit(lambda p: model.apply({"params": p}, fr, rg, caps)[0])(sharded))
        out["ids"] = np.asarray(
            jax_decode_fn(model, cfg, beam_size=BEAM, mesh=mesh12)({"params": sharded}, fr, rg))
        out["mesh12"] = _jax_steps(cfg, weights, batch, mesh12)
        out["mesh22"] = _jax_steps(cfg, weights, batch, mesh22)
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(JAX's results, the (1, 2) ranks', the (2, 2) ranks', the model-axis
    RunGAN's ranks', the single RunGAN's, {mesh: the steps without a model
    axis})."""
    work = tmp_path_factory.mktemp("tp")
    cfg = tiny_test_config(dropout=0.0)
    weights = {"gen": CapGnnModel(cfg, V, device="cpu").state_dict(),
               "disc": DiscV2(cfg, V, device="cpu").state_dict()}
    torch.save(weights, work / "weights.pt")
    batch = _global_batch(cfg, [9, 9, 8, 9, 2, 2, 3, 2], seed=3)
    np.savez(work / "batch.npz", eps_gp=_eps_gp(cfg, 8), **batch)
    procs = {"tp": launch_ranks("tp", work, 2, worker=WORKER),
             "steps": launch_ranks("steps", work, 4, worker=WORKER),
             "steps_data": launch_ranks("steps", work, 2, tag="steps_data", worker=WORKER),
             "steps_one": launch_ranks("steps", work, 0, tag="steps_one", worker=WORKER),
             "trainer": launch_ranks("trainer", work, 2, worker=WORKER),
             "single": launch_ranks("trainer", work, 0, tag="single", worker=WORKER)}
    want = _jax_reference(jax_tiny(dropout=0.0), weights, batch)  # while the ranks run
    got = {name: collect_ranks(p, name, work, timeout=600) for name, p in procs.items()}
    plain = {"1x2": got["steps_one"], "2x2": got["steps_data"]}
    return want, got["tp"], got["steps"], got["trainer"], got["single"][0], plain


def _check_step(want, plain, got, gan: bool):
    """The generator against JAX (`want`), the discriminator bitwise against
    the port without a model axis (`plain`: this data index's rank)."""
    check_state(want["g_mu"], want["g_params"], got["g"]["whole_mu"], got["g"]["whole_params"])
    for k in G_METRICS if gan else ("cap_loss",):
        np.testing.assert_allclose(got["metrics"][k].numpy(), want["metrics"][k], atol=1e-5, err_msg=k)
    if gan:
        for key in ("params", "mu"):
            for name, t in got["d"][key].items():
                assert torch.equal(t, plain["d"][key][name]), (key, name)
        for k in D_METRICS:
            assert torch.equal(got["metrics"][k], plain["metrics"][k]), k


def _check_layout(ranks, step: str, data_peers):
    """Replicated parameters and moments bitwise equal on every rank; the
    head's rows (V / 2 of them) equal across data peers, each rank's own."""
    for part in ("g", "d") if step == "gan" else ("g",):
        for key in ("params", "mu"):
            ref = ranks[0][step][part][key]
            for r in ranks[1:]:
                for name, t in r[step][part][key].items():
                    if name not in HEAD:
                        assert torch.equal(t, ref[name]), (step, part, key, name)
    for r0, r1 in data_peers:
        for key in ("params", "mu"):
            for name in HEAD:
                a, b = ranks[r0][step]["g"][key][name], ranks[r1][step]["g"][key][name]
                assert a.shape[0] == V // 2 and torch.equal(a, b), (step, key, name)


def test_forward_logits_of_the_split_head_match_jax(jobs):
    want, tp, *_ = jobs
    for r in tp:
        assert r["shard_rows"] == V // 2
        np.testing.assert_allclose(r["logits"].numpy(), want["logits"], atol=2e-5)
    assert [r["out_shard"] for r in tp] == [(0, V), (V // 2, V)]


@pytest.mark.parametrize("head", ["off", "on"])
def test_beam_decode_ids_equal_jax_tp_decode(jobs, head):
    """Fused head off: gathered logits; on: the kernel's plain version on
    each rank's columns, merged. Both give JAX's TP decode, token for token."""
    want, tp, *_ = jobs
    for r in tp:
        np.testing.assert_array_equal(r[f"ids_{head}"].numpy(), want["ids"])


@pytest.fixture(scope="module")
def int8_one_process(jobs, tmp_path_factory):
    """The worker's int8 decode in this process, without a group, of the
    jobs' weights (the same seeded init): the whole head quantized at once."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_tp_worker", WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    cfg = tiny_test_config(dropout=0.0)
    weights = {"gen": CapGnnModel(cfg, V, device="cpu").state_dict(),
               "disc": DiscV2(cfg, V, device="cpu").state_dict()}
    batch = _global_batch(cfg, [9, 9, 8, 9, 2, 2, 3, 2], seed=3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks
    try:
        return worker.int8_decode(weights, torch.from_numpy(batch["frames"]),
                                  torch.from_numpy(batch["regions"]))
    finally:
        torch.set_num_threads(n)


def test_int8_split_head_matches_one_process(jobs, int8_one_process):
    """decode_quant="int8" with the head split over the model axis: each
    rank quantizes its own columns (the scales are per column), so the
    gathered first-step logits equal one process's int8 logits bitwise, and
    the beam-5 ids, fused head off and on, are equal."""
    _, tp, *_ = jobs
    for r in tp:
        assert torch.equal(r["int8_logits"], int8_one_process["int8_logits"])
        for head in ("off", "on"):
            assert torch.equal(r[f"int8_ids_{head}"], int8_one_process[f"int8_ids_{head}"]), head


@pytest.mark.parametrize("step", ["gan", "ce"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_train_step_on_the_model_axis_matches_jax(jobs, step, mesh):
    want, tp, steps, *_, plain = jobs
    ranks = tp if mesh == "1x2" else steps
    ref = want["mesh12" if mesh == "1x2" else "mesh22"]
    for i, r in enumerate(ranks):
        _check_step(ref[step], plain[mesh][i // 2 if mesh == "2x2" else 0][step], r[step],
                    step == "gan")
    if step == "gan":  # JAX split its head the same way
        assert ref["gan"]["head_sharding"].spec == jax.sharding.PartitionSpec(None, "model")
    if mesh == "2x2":
        assert [r["mesh"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        peers = [(0, 2), (1, 3)]
    else:
        peers = []
    _check_layout(ranks, step, peers)
    # rank 0 (data index 0) holds the first row of the global batch
    np.testing.assert_array_equal(ranks[0][step]["metrics"]["sample_tokens"].numpy(),
                                  ref[step]["metrics"]["sample_tokens"])


def test_dropout_masks_are_the_same_on_model_peers(jobs):
    """Dropout on: the two model peers hold the same rows and draw the same
    masks, so their gathered logits and, after a GAN step, every replicated
    parameter and moment are bitwise equal."""
    _, tp, *_ = jobs
    assert torch.equal(tp[0]["logits_dropout"], tp[1]["logits_dropout"])
    assert not torch.equal(tp[0]["logits_dropout"], tp[0]["logits"])  # dropout did act
    _check_layout([r["dropout_step"] for r in tp], "gan", [])
    _check_layout([r["dropout_step"] for r in tp], "ce", [])


def test_run_gan_epoch_on_the_model_axis_matches_one_process(jobs):
    """tests/test_trainer.py:73: one epoch of RunGAN with the head split
    over 2 ranks ends within 2e-4 of the same epoch in one process
    (word_restore, word_embed), and keeps its layout."""
    *_, trainer, single, _ = jobs
    hidden = single["layout_before"][1]
    assert single["layout_before"] == single["layout_after"] == (V, hidden)
    for r in trainer:
        assert r["layout_before"] == r["layout_after"] == (V // 2, hidden)
        assert r["mu_rows"] == r["nu_rows"] == V // 2
        assert r["steps"] == single["steps"] == 4
    whole = {n: torch.cat([r["params"][n] for r in trainer]) for n in HEAD}
    for n in HEAD:
        np.testing.assert_allclose(whole[n].numpy(), single["params"][n].numpy(), atol=2e-4)
    emb = "decoder.step.word_embed.embedding"
    for r in trainer:
        np.testing.assert_allclose(r["params"][emb].numpy(), single["params"][emb].numpy(),
                                   atol=2e-4)


def test_model_axis_checkpoint_is_whole_and_restores_in_one_process(jobs, tmp_path):
    """The epoch checkpoint holds whole tensors (the head and both moments
    gathered) equal to the ranks' rows; it restores into one process's
    RunGAN, and a model-axis resume continued it to epoch 1."""
    *_, trainer, _, _ = jobs
    r0 = trainer[0]
    payload = torch.load(r0["checkpoint"], weights_only=True)
    for n in HEAD:
        assert payload["gen_params"][n].shape[0] == V
    assert r0["resumed_from"] == 0 and r0["resumed_rows"] == V // 2
    assert r0["steps_after_resume"] == 8
    after = torch.load(r0["epoch1_checkpoint"], weights_only=True)
    assert after["gen_step"] == 8 and after["gen_params"][HEAD[0]].shape[0] == V
    state = payload["gen_opt"]["state"]
    whole = {tuple(payload["gen_params"][n].shape) for n in HEAD}
    assert {tuple(s[k].shape) for s in state.values() for k in ("exp_avg", "exp_avg_sq")} >= whole

    vocab = make_vocab(extra_words=1)
    cfg = apply_dataset_overrides(tiny_test_config(dropout=0.0))  # as RunGAN built it
    ds = SyntheticDataset(cfg, vocab, num_videos=2, captions_per_video=1)
    ckpt_dir = r0["checkpoint"].rsplit("/epoch_0/", 1)[0]
    g = CapGnnModel(cfg, V, device="cpu")
    gs = TrainState.create(g, make_optimizer(LR))
    restored = ckpt.restore_train(ckpt_dir, 0, gs)
    assert restored["epoch"] == 0 and gs.step == 4
    for n in HEAD:
        assert torch.equal(g.state_dict()[n], payload["gen_params"][n])
    # and in one process's RunGAN, as `cli` resumes
    run = RunGAN(tiny_test_config(epoch_num=2, result_dir=ckpt_dir.rsplit("/checkpoints", 1)[0],
                                  dropout=0.0, beam_size=2, train_batch_size=4, test_batch_size=4),
                 vocab, ds, ds.eval_view(), ds.references, resume_epoch=0, device="cpu")
    assert run.last_epoch == 0 and run.gen_state.step == 4
    assert run.gen_model.decoder.step.word_restore.weight.shape[0] == V
