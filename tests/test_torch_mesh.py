"""dlsg_tpu_torch's mesh (parallel/mesh.py) against dlsg_tpu's: shapes,
rank order and groups, the tensor-parallel rules, the merge of the split
vocab head's top-k (evaluation/decode.py) against the whole head, and the
multi-rank serving path (`Captioner(mesh=)`, `CaptionServer` with
followers, `cli train|serve|export --distributed`).

The multi-rank jobs run once for the module, as real processes on gloo
(tests/helpers/torch_tp_worker.py imports dlsg_tpu_torch alone; the CLI
runs under torchrun): a 4-rank `mesh` job, a 2-rank `serve` job on a
(data 2) mesh, and `torchrun --nproc_per_node=2 -m dlsg_tpu_torch.cli`
`train --mesh_model_axis 2` and `export --mesh_model_axis 2`, then
`serve --features` of the exported bundle, all with `--distributed`.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from dlsg_tpu.parallel import mesh as jmesh
from dlsg_tpu_torch.cli import main
from dlsg_tpu_torch.config import parse_opt, tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.evaluation.decode import merge_shard_topk
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk_plain
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.parallel import Mesh, make_mesh, param_sharding_specs, shard_params
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.train.trainer import RunGAN
from dlsg_tpu_torch.weights import params_to_jax
from test_torch_cli import PORT_FLAGS, SCORES, _clips_npz
from test_torch_multiprocess import _finish, _torchrun
from test_torch_parallel import REPO, collect_ranks, launch_ranks
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

WORKER = f"{REPO}/tests/helpers/torch_tp_worker.py"
HEAD = ("decoder.step.word_restore.weight", "decoder.step.word_restore.bias")


# ---------------------------------------------------------------- one process


def test_without_a_process_group_the_mesh_is_one_by_one():
    m = make_mesh()
    assert (m.shape, m.data_index, m.model_index, m.data_group, m.model_group) == (
        {"data": 1, "model": 1}, 0, 0, None, None)
    assert make_mesh(1, 1).shape == make_mesh(-1).shape == m.shape
    assert dist.current_mesh() is None  # no process group: nothing is live
    assert (dist.data_size(), dist.data_rank()) == (1, 0)


@pytest.mark.parametrize("n_data, n_model, match", [
    (2, 1, r"mesh_data_axis=2 x mesh_model_axis=1 = 2 ranks, but the world size is 1"),
    (-1, 2, r"mesh_model_axis=2 does not divide the world size 1 \(no process group"),
    (0, 1, r"mesh_data_axis=0 x mesh_model_axis=1 = 0 ranks, but the world size is 1"),
    (1, 2, r"= 2 ranks, but the world size is 1 \(no process group"),
    (1, 0, r"mesh_model_axis=0: must be >= 1"),
])
def test_a_bad_product_raises_and_names_both_numbers(n_data, n_model, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(n_data, n_model)


def _specs_like_jax(sd, mesh):
    """JAX's param_sharding_specs on the port's parameters (as a flax tree),
    back under the port's names: {name: sharded or not}."""
    tree = params_to_jax(sd)
    specs = jmesh.param_sharding_specs(tree, mesh=mesh)
    flat = {}

    def walk(node, spec, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, spec[k], prefix + (k,))
            else:
                name = ".".join(prefix + ({"kernel": "weight", "scale": "weight"}.get(k, k),))
                flat[name] = spec[k] != jax.sharding.PartitionSpec()

    walk(tree, specs, ())
    return flat


@pytest.mark.parametrize("vocab", [40, 39])
def test_sharding_specs_pick_jax_leaves(vocab):
    """The same leaves as JAX's TP_RULES on CapGnnModel: the vocab head's
    weight and bias on a 40-word vocabulary, nothing on 39 words over model
    2 (JAX's divisibility rule), and shard_params then splits nothing."""
    cfg = tiny_test_config()
    model = CapGnnModel(cfg, vocab, device="cpu")
    sd = model.state_dict()
    jax_mesh = jmesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    want = _specs_like_jax(sd, jax_mesh)
    got = param_sharding_specs(sd, mesh=Mesh(1, 2))
    assert {n for n, s in got.items() if s is not None} == {n for n, s in want.items() if s}
    assert {n for n, s in got.items() if s is not None} == (set(HEAD) if vocab == 40 else set())
    # without a mesh the rules alone decide, in both packages
    assert {n for n, s in param_sharding_specs(sd).items() if s is not None} == set(HEAD)
    assert {n for n, s in _specs_like_jax(sd, None).items() if s} == set(HEAD)
    split = shard_params(model, Mesh(1, 2, model_index=1))
    wr = model.decoder.step.word_restore
    if vocab == 40:
        assert split == {HEAD[0]: 0, HEAD[1]: 0} and wr.out_shard == (20, 40)
        torch.testing.assert_close(wr.weight, sd[HEAD[0]][20:], rtol=0, atol=0)
    else:
        assert split == {} and wr.out_shard is None and wr.weight.shape[0] == 39


def test_a_head_that_does_not_divide_stays_replicated_and_the_trainer_says_so(tmp_path, capsys):
    vocab = make_vocab()
    assert len(vocab) == 39
    cfg = tiny_test_config(epoch_num=1, result_dir=str(tmp_path), beam_size=2)
    ds = SyntheticDataset(cfg, vocab, num_videos=2, captions_per_video=1)
    run = RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu", mesh=Mesh(1, 2))
    out = capsys.readouterr().out
    assert out.count("does not divide the 39-word vocabulary: the vocab head stays replicated") == 1
    assert run.gen_model.decoder.step.word_restore.weight.shape[0] == 39


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["random", "tie_at_boundary"])
def test_merge_of_the_shards_equals_the_whole_head(n_model, k, case):
    """Each shard's plain K1 (raw top-k and logsumexp), ids offset, merged:
    the whole head's normalized top-k, ids exactly. V = 300 (not a multiple
    of 128). In the tie case every shard's first column equals the last
    column of the shard before it, and both are the largest logits of
    their rows, so ties straddle each boundary."""
    G, H, V = 7, 16, 300
    g = torch.Generator().manual_seed(n_model * 10 + k)
    h = torch.randn(G, H, generator=g)
    w = torch.randn(H, V, generator=g)
    b = torch.randn(V, generator=g)
    n = V // n_model
    if case == "tie_at_boundary":
        for s in range(1, n_model):
            w[:, s * n] = w[:, s * n - 1] = 3.0 * torch.sign(h[0])
            b[s * n] = b[s * n - 1] = 0.5
    want_v, want_i = vocab_head_topk_plain(h, w, b, k)
    parts = [vocab_head_topk_plain(h, w[:, s * n:(s + 1) * n].contiguous(), b[s * n:(s + 1) * n], k,
                                   normalize=False, return_lse=True) for s in range(n_model)]
    vals = torch.stack([p[0] for p in parts], dim=1)
    ids = torch.stack([p[1] + s * n for s, p in enumerate(parts)], dim=1)
    lse = torch.stack([p[2] for p in parts], dim=1)
    got_v, got_i = merge_shard_topk(vals, ids, lse, k)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=2e-6)
    assert torch.equal(got_i, want_i)
    if case == "tie_at_boundary" and k > 1:  # the pair on each boundary, lower id first
        row = want_i[0].tolist()
        assert row[0] == n - 1 and row[1] == n


def test_plain_vocab_head_returns_the_row_logsumexp():
    g = torch.Generator().manual_seed(0)
    h, w, b = torch.randn(5, 8, generator=g), torch.randn(8, 30, generator=g), torch.randn(30, generator=g)
    logits = h @ w + b
    for normalize in (True, False):
        vals, ids, lse = vocab_head_topk_plain(h, w, b, 4, normalize=normalize, return_lse=True)
        torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0, atol=1e-6)
        raw = logits.gather(1, ids)
        torch.testing.assert_close(vals, raw - lse[:, None] if normalize else raw, rtol=0, atol=1e-6)


def test_model_axis_without_distributed_exits_2(capsys):
    for command in ("train", "serve", "export", "evaluate"):
        assert main([command, "--synthetic", "--allow_random_params", "--mesh_model_axis", "2",
                     "--device", "cpu"]) == 2
        assert "pass --distributed" in capsys.readouterr().err


# ---------------------------------------------------------------- multi-rank


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The module doc's jobs: ({mesh job ranks}, {serve job ranks}, the
    one-process captions, {cli: (rc, out, err)}, work dir)."""
    work = tmp_path_factory.mktemp("mesh")
    cfg = tiny_test_config(beam_size=5, use_fused_vocab_head="on")
    vocab = make_vocab()
    weights = CapGnnModel(cfg, len(vocab), device="cpu").state_dict()
    torch.save(weights, work / "weights.pt")
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(8, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(8, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32)
    np.savez(work / "clips.npz", frames=frames, regions=regions)

    bundle = work / "model.dlsg.npz"
    cli_flags = ["--synthetic", "--synthetic_vocab", "40", "--device", "cpu", "--distributed",
                 "--mesh_model_axis", "2"] + PORT_FLAGS
    procs = {
        "train": _torchrun(["train", "--synthetic_videos", "6", "--no_debug", "--epoch_num", "1",
                            "--result_dir", str(work / "cli_train")] + cli_flags, work, "train"),
        "export": _torchrun(["export", "--allow_random_params", "--out", str(bundle)] + cli_flags,
                            work, "export"),
        "evaluate": _torchrun(["evaluate", "--allow_random_params", "--synthetic_videos", "6",
                               "--result_dir", str(work / "cli_eval")] + cli_flags, work, "evaluate"),
    }
    ranks = {"mesh": launch_ranks("mesh", work, 4, worker=WORKER),
             "serve": launch_ranks("serve", work, 2, worker=WORKER)}
    cap = Captioner(cfg, vocab, weights, device="cpu")
    single = {n: cap.caption(frames[:n], regions[:n]) for n in (5, 8)}
    single["greedy_5"] = cap.caption(frames[:5], regions[:5], greedy=True)
    got = {name: collect_ranks(p, name, work, timeout=300) for name, p in ranks.items()}
    cli = {"export": _finish(procs["export"])}
    ccfg = parse_opt(PORT_FLAGS)
    _clips_npz(work / "cli_clips.npz", ccfg, 5, np.array(["a", "b", "c", "d", "e"]))
    procs["serve"] = _torchrun(["serve", "--bundle", str(bundle), "--features",
                                str(work / "cli_clips.npz"), "--output", str(work / "captions.jsonl"),
                                "--device", "cpu", "--distributed"], work, "serve")
    cli.update(train=_finish(procs["train"]), serve=_finish(procs["serve"]),
               evaluate=_finish(procs["evaluate"]))
    yield got["mesh"], got["serve"], single, cli, work
    shutil.rmtree(work, ignore_errors=True)  # the CLI's outputs (collect_ranks)


def test_mesh_rank_order_and_groups_on_four_ranks(jobs):
    """rank = data_index * n_model + model_index (JAX's reshape order); the
    model group holds the ranks of one data index, the data group those of
    one model index; -1 takes the rest; a bad product names both numbers."""
    ranks, *_ = jobs
    for r, res in enumerate(ranks):
        m22 = res[(2, 2)]
        assert m22["index"] == (r // 2, r % 2) and m22["shape"] == {"data": 2, "model": 2}
        # the model group: ranks 2d and 2d + 1; the data group: ranks m and m + 2
        assert m22["model_sum"] == 4 * (r // 2) + 1 and m22["data_sum"] == 2 * (r % 2) + 2
        assert (m22["data_size"], m22["data_rank"]) == (2, r // 2)
        assert res[(-1, 2)]["index"] == m22["index"]
        assert res[(4, 1)]["index"] == (r, 0) and (res[(4, 1)]["data_size"], res[(4, 1)]["data_rank"]) == (4, r)
        assert res[(1, 4)]["index"] == (0, r) and res[(1, 4)]["data_size"] == 1
        assert "mesh_data_axis=3 x mesh_model_axis=1 = 3 ranks, but the world size is 4" in res["bad_product"]


def test_data_axis_helpers_follow_the_data_index(jobs):
    """Per-row draws, the global sum and the eval gather run over the data
    axis: model peers draw the same block, data ranks different ones; the
    gather returns every data index's rows in data order, once."""
    ranks, *_ = jobs
    draw = torch.rand((2, 3, 2), generator=torch.Generator().manual_seed(4))
    for r, res in enumerate(ranks):
        assert torch.equal(res["block_rand"], draw[r // 2])
        # ranks 0 and 2 (model index 0) sum 1 + 3; ranks 1 and 3 sum 2 + 4
        assert float(res["global_sum"]) == (4.0 if r % 2 == 0 else 6.0)
        ids, vids, alphas = res["gather_eval"]
        assert vids.tolist() == [0, 10, 11] and alphas is None
        assert ids[:, 0].tolist() == [r % 2, 2 + r % 2, 2 + r % 2]


def test_copy_and_gather_differentiate_like_the_whole_product(jobs):
    """tanh(gather(copy(x) @ W_local.T)) against tanh(x @ W.T), with the
    first and second derivatives in x (float64)."""
    ranks, *_ = jobs
    for res in ranks:
        whole, split = res["tp_autograd"][False], res["tp_autograd"][True]
        for a, b in zip(whole, split):
            torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("key", [5, 8, "greedy_5"])
def test_captioner_on_a_data_mesh_matches_one_process(jobs, key):
    """Captioner(mesh=) on 2 ranks (data 2): each rank decodes its half of
    the padded bucket; both ranks return one process's captions, N = 5 (not
    a multiple of 2) and 8, beam (fused head) and greedy."""
    _, ranks, single, *_ = jobs
    for res in ranks:
        assert res[key] == single[key]


def test_caption_server_serves_through_the_leader_and_stops_the_follower(jobs):
    _, (leader, follower), single, *_ = jobs
    assert leader["http_npz"] == single[5]
    assert leader["http_greedy"] == single["greedy_5"]
    assert leader["healthz"]["world"] == 2 and leader["healthz"]["mesh"] == {"data": 2, "model": 1}
    assert follower["followed"] == 2  # both requests, then the stop


def test_cli_train_on_the_model_axis(jobs):
    """`torchrun ... cli train --distributed --mesh_model_axis 2`: trains,
    saves a whole checkpoint, logs once."""
    *_, cli, work = jobs
    rc, out, err = cli["train"]
    assert rc == 0, out[-3000:] + err[-3000:]
    assert out.count("Epoch-0 lr: ") == 1
    payload = torch.load(work / "cli_train" / "checkpoints" / "epoch_0" / "train.pt", weights_only=True)
    assert payload["gen_params"][HEAD[0]].shape[0] == 40 and payload["gen_step"] > 0


def test_cli_evaluate_with_the_head_split_scores_as_one_process(jobs, capsys):
    """`evaluate --distributed --mesh_model_axis 2` (the decode with the head
    split over both ranks) prints one score block, equal to one process's
    `evaluate` of the same seeded weights."""
    *_, cli, work = jobs
    rc, out, err = cli["evaluate"]
    assert rc == 0, out[-3000:] + err[-3000:]
    got = [ln for ln in out.splitlines() if ln.split(":")[0] in SCORES]
    assert main(["evaluate", "--allow_random_params", "--synthetic", "--synthetic_vocab", "40",
                 "--synthetic_videos", "6", "--device", "cpu", "--result_dir", str(work / "one")]
                + PORT_FLAGS) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.split(":")[0] in SCORES]
    assert got == want and [ln.split(":")[0] for ln in got] == list(SCORES)


def test_cli_export_and_serve_distributed(jobs):
    """`export --distributed --mesh_model_axis 2` writes the whole model once
    (rank 0); `serve --bundle --features --distributed` over a (data 2)
    mesh writes one process's captions, once."""
    *_, cli, work = jobs
    for name in ("export", "serve"):
        rc, out, err = cli[name]
        assert rc == 0, out[-3000:] + err[-3000:]
    assert cli["export"][2].count("export: wrote") == 1
    bundle = str(work / "model.dlsg.npz")
    cfg = parse_opt(PORT_FLAGS)
    want_model = CapGnnModel(parse_opt(PORT_FLAGS), 40, device="cpu").state_dict()
    got = Captioner.from_bundle(bundle, device="cpu")
    for k, t in got.model.state_dict().items():
        assert torch.equal(t, want_model[k]), k
    frames, regions = _clips_npz(work / "check.npz", cfg, 5, np.arange(5))
    lines = [json.loads(ln) for ln in (work / "captions.jsonl").read_text().splitlines()]
    assert [ln["video_id"] for ln in lines] == ["a", "b", "c", "d", "e"]
    assert [ln["caption"] for ln in lines] == got.caption(frames, regions)
    assert cli["serve"][2].count("serve: 5 captions") == 1
