"""dlsg_tpu_torch's data parallelism (parallel/dist.py and the global-batch
train steps) against dlsg_tpu's single process at the global batch, the
counterpart of tests/test_parallel.py.

The 2-rank job runs once for the module: two real processes on gloo
(tests/helpers/torch_dp_worker.py, which imports dlsg_tpu_torch alone), each
with the rows of its rank of a global batch of 8, take one GAN step (and one
CE step) from the same weights, with dropout off, epsilon 1 and the
penalty's mixing weights of JAX's key chain split by rank. This process runs
JAX's step on the whole batch meanwhile. Two batches: one whose halves hold
the same number of caption tokens, one whose halves do not (9, 9, 8, 9
against 2, 2, 3, 2 tokens). The same steps with each of the four global
computations made per rank (the CE's token count, PSLScore2's batch mean,
the gradient of its sum in the penalty, the cap loss lambda is fed) show
that each is needed: every one of them goes wrong silently.

Tolerances: those of tests/test_torch_train_steps.py (Adam moments 1e-4 of
each tensor's max-abs, parameters 1e-5, metrics 1e-5), but D's moments,
after its 5 WGAN-GP substeps, within 1e-4 x 5 of max-abs, as check_state
scales D's parameter tolerance with the substeps; the two ranks are compared
bitwise.

Why D's moments get 5e-4: the same GAN step of each case in float64 (the
port with every fp32 cast widened, one process, the whole batch, dropout
off, JAX's penalty draws; the worker's `gan_f64` job) shows that fp32
itself lies this far from it after 5 substeps, in both packages alike. A
first Adam update is lr * sign(grad): an element whose gradient sits at
rounding level moves by +-lr depending on the summation order, and the
later substeps carry that into the moments. Worst share of max-abs over
D's tensors, from float64 (x86 CPU, torch 2.x and jax on the CPU; the test
below recomputes them in every run): even case JAX 2.04e-4 (conv1d.weight),
port over two ranks 1.84e-4 (att_norm_dense.weight); uneven case JAX
1.61e-4, port 1.88e-4. JAX against the port: up to 2.01e-4 (conv1d.weight,
even), which the former 1e-4 refused on some machines and not on others.
G's moments (one update) lie within 6.6e-6 of float64 in both packages.

The ratio check ("the port no more than twice as far as JAX") has a floor,
RATIO_FLOOR = 1e-5, check_state's parameter tolerance: below it both
distances are fp32 rounding and their ratio says nothing. G's moments lie
there: 3.1e-6 (JAX) against 6.8e-6 (port) failed `port <= 2 * jax` on one
run of the whole suite (uneven case) and passed on the next with the same
code, since which package lands nearer depends on the summation order of
the machine and its thread count. D's distances (1.6-2.0e-4) stay held by
the ratio as before.
"""

import os
import shutil
import socket
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.discriminator import DiscV2 as JaxDiscV2
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.train import gan_lambda as jgl
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu_torch.cli import main as cli_main
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.device import resolve_device
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax
from test_torch_train_steps import KEY, LR, METRICS, V, _adam_mu, _identity, check_state
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "helpers", "torch_dp_worker.py")
WORLD = 2
D_MOMENT_TOL = 1e-4 * jax_tiny().num_D_visual  # module doc
RATIO_FLOOR = 1e-5  # module doc: below it a distance from float64 is fp32 rounding
LENGTHS = {"even": [3, 9, 5, 2, 9, 2, 5, 3], "uneven": [9, 9, 8, 9, 2, 2, 3, 2]}


def launch_ranks(job: str, work_dir, n: int = WORLD, tag: str = None, worker: str = WORKER) -> list:
    """Start `n` processes of `worker`'s `job` with torchrun's environment,
    or with n=0 one process with no process group; each writes
    work_dir/<tag or job>_<rank>.pt."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(max(n, 1)):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        if n:
            env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, worker, job, str(work_dir), str(work_dir / f"{tag or job}_{r}.pt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return procs


# The suite writes its outputs under pytest's temp root, which pytest keeps
# for the last three sessions, on a disk shared with everything else on the
# host: once it is full, whichever test writes next fails with ENOSPC
# (ROADMAP F9). So the rank files are removed once read, the module fixtures
# that write hundreds of MB remove their directories at teardown, and the
# tests that do so take `tmp_path` below.


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends (see above)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def collect_ranks(procs: list, job: str, work_dir, timeout: float) -> list:
    """Each rank's results; a rank that hangs is killed at `timeout`. The
    ranks' files are removed once read: the results are in memory."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER OK" in log, f"rank {r}:\n{log[-4000:]}"
    # files the workers of this test wrote
    paths = [work_dir / f"{job}_{r}.pt" for r in range(len(procs))]
    out = [torch.load(p, weights_only=False) for p in paths]
    for p in paths:
        p.unlink()
    for r, res in enumerate(out):
        assert res["foreign_modules"] == [], (r, res["foreign_modules"])
    return out


def _global_batch(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    n, T = len(lengths), cfg.max_words
    lengths = np.asarray(lengths, np.int32)
    return {
        "frames": rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(
            np.float32),
        "captions": np.where(np.arange(T)[None] < lengths[:, None],
                             rng.integers(4, V, size=(n, T)), 0).astype(np.int32),
        "lengths": lengths,
    }


def _eps_gp(cfg, n):
    """The penalty's mixing weights of JAX's GAN step at batch n: [num_D, n]."""
    rng_d = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), 0), 3)[1]
    return np.stack([
        np.asarray(jax.random.uniform(jax.random.split(sub)[0], (n, 1, 1))).reshape(n)
        for sub in jax.random.split(rng_d, cfg.num_D_visual)
    ])


def _jax_steps(cfg, weights, batches):
    """JAX's GAN step on each global batch and its CE step on the uneven one."""
    gen, disc = JaxCapGnnModel(cfg, V), JaxDiscV2(cfg, V)
    gstep, cstep = jsteps.make_gan_train_step(gen, disc, cfg), jsteps.make_ce_train_step(gen, cfg)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        for case, batch in batches.items():
            g = joptim.TrainState.create(params_to_jax(weights["gen"]), joptim.make_optimizer(LR))
            d = joptim.TrainState.create(params_to_jax(weights["disc"]), joptim.make_optimizer(LR))
            g, d, _, m = gstep(g, d, jgl.init_lambda_state(0.01),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(KEY), jnp.float32(1.0))
            out[f"gan_{case}"] = {
                "g_mu": params_from_jax(_adam_mu(g.opt_state)), "g_params": params_from_jax(g.params),
                "d_mu": params_from_jax(_adam_mu(d.opt_state)), "d_params": params_from_jax(d.params),
                "metrics": {k: np.asarray(v) for k, v in m.items()},
            }
        g = joptim.TrainState.create(params_to_jax(weights["gen"]), joptim.make_optimizer(LR))
        g, m = cstep(g, {k: jnp.asarray(v) for k, v in batches["uneven"].items()},
                     jax.random.PRNGKey(KEY), jnp.float32(1.0))
        out["ce_uneven"] = {"g_mu": params_from_jax(_adam_mu(g.opt_state)),
                            "g_params": params_from_jax(g.params),
                            "metrics": {k: np.asarray(v) for k, v in m.items()}}
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(JAX's results, [rank 0's, rank 1's], [a world-size-1 rank's, a
    process's without a group], the float64 steps) of the module doc's job;
    the third pair takes the uneven GAN step alone."""
    work = tmp_path_factory.mktemp("dp_steps")
    cfg = tiny_test_config(dropout=0.0)
    weights = {"gen": CapGnnModel(cfg, V, device="cpu").state_dict(),
               "disc": DiscV2(cfg, V, device="cpu").state_dict()}
    torch.save(weights, work / "weights.pt")
    batches = {case: _global_batch(cfg, lengths, seed=3) for case, lengths in LENGTHS.items()}
    arrays = {f"{case}_{k}": v for case, b in batches.items() for k, v in b.items()}
    arrays.update({f"{case}_eps_gp": _eps_gp(cfg, len(LENGTHS[case])) for case in LENGTHS})
    np.savez(work / "batches.npz", **arrays)
    procs = launch_ranks("steps", work)
    one, none = launch_ranks("gan", work, n=1), launch_ranks("gan", work, n=0, tag="gan_no_group")
    f64 = launch_ranks("gan_f64", work, n=0)
    want = _jax_steps(jax_tiny(dropout=0.0), weights, batches)  # while the ranks run
    yield (want, collect_ranks(procs, "steps", work, timeout=300),
           collect_ranks(one, "gan", work, 300) + collect_ranks(none, "gan_no_group", work, 300),
           collect_ranks(f64, "gan_f64", work, 300)[0])
    shutil.rmtree(work, ignore_errors=True)


def check_rank(want, got, rank: int, gan: bool = True):
    """One rank's state after the step against JAX's (module doc)."""
    check_state(want["g_mu"], want["g_params"], got["g_mu"], got["g_params"])
    if gan:
        check_state(want["d_mu"], want["d_params"], got["d_mu"], got["d_params"],
                    updates=jax_tiny().num_D_visual, moment_tol=D_MOMENT_TOL)
    for k in METRICS if gan else ("cap_loss",):
        np.testing.assert_allclose(got["metrics"][k].numpy(), want["metrics"][k], atol=1e-5, err_msg=k)
    if rank == 0:  # the first row of the global batch is rank 0's
        np.testing.assert_array_equal(got["metrics"]["sample_tokens"].numpy(),
                                      want["metrics"]["sample_tokens"])


def test_token_counts_of_the_two_batches():
    assert sum(LENGTHS["even"][:4]) == sum(LENGTHS["even"][4:])
    assert sum(LENGTHS["uneven"][:4]) != sum(LENGTHS["uneven"][4:])


@pytest.mark.parametrize("case", ["even", "uneven"])
@pytest.mark.parametrize("rank", [0, 1])
def test_gan_step_over_two_ranks_matches_jax_at_the_global_batch(steps, case, rank):
    want, got, *_ = steps
    check_rank(want[f"gan_{case}"], got[rank][f"gan_{case}"], rank)
    assert (got[rank][f"gan_{case}"]["g_step"], got[rank][f"gan_{case}"]["d_step"]) == (
        1, jax_tiny().num_D_visual)


def _worst_share(mu, ref) -> float:
    """The largest |mu - ref| over a state's tensors, as a share of each
    reference tensor's max-abs."""
    worst = 0.0
    for name, r in ref.items():
        scale = float(r.abs().max())
        if scale:
            worst = max(worst, float((mu[name].double() - r).abs().max()) / scale)
    return worst


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_both_packages_lie_equally_far_from_a_float64_step(steps, case):
    """The evidence for D's moment tolerance (module doc): JAX's fp32 step
    and the port's over two ranks each lie within it of the float64 step,
    and the port no more than twice as far as JAX (or than RATIO_FLOOR,
    where both are rounding); G's moments within the 1e-4 that check_state
    holds them to."""
    want, got, _, f64 = steps
    ref = f64[f"gan_{case}"]
    for part, tol in (("g_mu", 1e-4), ("d_mu", D_MOMENT_TOL)):
        jax_far = _worst_share(want[f"gan_{case}"][part], ref[part])
        port_far = _worst_share(got[0][f"gan_{case}"][part], ref[part])
        assert max(jax_far, port_far) <= tol, (part, jax_far, port_far)
        assert port_far <= 2 * max(jax_far, RATIO_FLOOR), (part, jax_far, port_far)


@pytest.mark.parametrize("rank", [0, 1])
def test_ce_step_over_two_ranks_matches_jax_at_the_global_batch(steps, rank):
    want, got, *_ = steps
    check_rank(want["ce_uneven"], got[rank]["ce_uneven"], rank, gan=False)


def test_a_mean_of_per_rank_ce_means_fails_once_token_counts_differ(steps):
    """The CE flipped to each rank's own mean (scaled by 1/world, as averaged
    gradients would): right while the halves hold the same token count,
    wrong once they do not; the global count is right in both."""
    want, got, *_ = steps
    check_rank(want["gan_even"], got[0]["gan_even_per_rank_ce"], 0)
    with pytest.raises(AssertionError):
        check_rank(want["gan_uneven"], got[0]["gan_uneven_per_rank_ce"], 0)
    np.testing.assert_allclose(got[0]["gan_uneven"]["metrics"]["cap_loss"].numpy(),
                               want["gan_uneven"]["metrics"]["cap_loss"], atol=1e-5)


def test_psl_score_takes_the_global_batch_mean(steps):
    """PSLScore2's batch mean flipped to each rank's own rows changes the
    penalty (and so D's update); the global mean gives JAX's."""
    want, got, *_ = steps
    gp_want = float(want["gan_uneven"]["metrics"]["grad_penalty"])
    assert float(got[0]["gan_uneven"]["metrics"]["grad_penalty"]) == pytest.approx(gp_want, abs=1e-5)
    gp_local = float(got[0]["gan_uneven_per_rank_psl"]["metrics"]["grad_penalty"])
    assert abs(gp_local - gp_want) > 1e-3 * abs(gp_want), (gp_local, gp_want)
    with pytest.raises(AssertionError):
        check_rank(want["gan_uneven"], got[0]["gan_uneven_per_rank_psl"], 0)


def test_the_penalty_differentiates_the_global_sum(steps):
    """PSLScore2's global sum with a backward that stays on each rank (an
    all-reduce autograd does not see): the forward is JAX's, the penalty's
    input gradient is not, and so neither is the penalty."""
    want, got, *_ = steps
    gp_want = float(want["gan_uneven"]["metrics"]["grad_penalty"])
    gp_local = float(got[0]["gan_uneven_local_psl_grad"]["metrics"]["grad_penalty"])
    assert abs(gp_local - gp_want) > 1e-3 * abs(gp_want), (gp_local, gp_want)
    with pytest.raises(AssertionError):
        check_rank(want["gan_uneven"], got[0]["gan_uneven_local_psl_grad"], 0)


def test_lambda_is_fed_the_global_cap_loss(steps):
    """The lambda window holds JAX's global cap loss on both ranks; fed each
    rank's own mean, the ranks' lambda states part silently."""
    want, got, *_ = steps
    cap = float(want["gan_uneven"]["metrics"]["cap_loss"])
    windows = [float(r["gan_uneven"]["lambda"]["window"][0]) for r in got]
    assert windows == [windows[0]] * WORLD and windows[0] == pytest.approx(cap, abs=1e-5)
    local = [float(r["gan_uneven_per_rank_lambda"]["lambda"]["window"][0]) for r in got]
    assert local[0] != local[1] and all(abs(w - cap) > 1e-3 for w in local), (local, cap)


@pytest.mark.parametrize("case", ["gan_even", "gan_uneven", "ce_uneven"])
def test_the_ranks_end_bitwise_equal(steps, case):
    """Parameters, Adam moments, the lambda state and the logged losses."""
    _, (r0, r1), *_ = steps
    a, b = r0[case], r1[case]
    for part in ("g_params", "g_mu") + (("d_params", "d_mu") if "d_params" in a else ()):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)
    for k, t in a["metrics"].items():
        if k != "sample_tokens":
            assert torch.equal(t, b["metrics"][k]), k
    for k, t in a.get("lambda", {}).items():
        assert torch.equal(t, b["lambda"][k]), k


def test_dropout_masks_are_each_ranks_block_of_one_draw(steps):
    """Dropout on: the ranks' masks differ, and rank r's is block r of one
    draw over the ranks from the same generator."""
    _, got, *_ = steps
    masks = [g["dropout"] for g in got]
    assert not torch.equal(masks[0], masks[1])
    draw = torch.rand((WORLD, 6, 10), generator=torch.Generator().manual_seed(5))
    for r, m in enumerate(masks):
        assert torch.equal(m, torch.where(draw[r] < 0.5, torch.full((6, 10), 2.0), torch.zeros(6, 10)))


def test_world_size_one_in_a_group_is_bitwise_the_step_without_one(steps):
    """The GAN step of a process group of one (gloo) equals, bitwise, the
    same step in a process without a group: the collectives of a world of
    one change no bit."""
    _, _, (one, none), _ = steps
    a, b = one["gan_uneven"], none["gan_uneven"]
    for part in ("g_params", "d_params", "g_mu", "d_mu", "metrics", "lambda"):
        assert a[part].keys() == b[part].keys()
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)


def test_dropout_at_world_size_one_is_the_single_process_draw():
    """Without a process group (world size 1) dropout and the penalty's
    mixing weights draw exactly what torch.rand draws from the generator."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    got = linear.dropout(x, 0.3, torch.Generator().manual_seed(9))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(9)) < 0.7
    assert torch.equal(got, torch.where(keep, x / 0.7, torch.zeros(())))
    eps = dist.rank_block_rand((4, 1, 1), torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(eps, torch.rand(4, 1, 1, generator=torch.Generator().manual_seed(3)))


def test_without_a_process_group_everything_is_the_single_process():
    assert not dist.is_distributed()
    assert (dist.world_size(), dist.rank(), dist.is_leader(), dist.global_rows(3)) == (1, 0, True, 3)
    x = torch.randn(3, requires_grad=True)
    assert dist.global_sum(x) is x
    grads = [torch.ones(2), torch.zeros(3, 2)]
    assert all(a is b for a, b in zip(dist.all_reduce_grads(grads), grads))
    ids, vids, alphas = np.ones((2, 4), np.int64), np.arange(2), None
    assert all(a is b for a, b in zip(dist.gather_eval(ids, vids, alphas), (ids, vids, alphas)))
    dist.barrier()
    dist.broadcast_module(torch.nn.Linear(2, 2))


def test_init_distributed_needs_torchrun_and_a_card(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        dist.init_distributed("cpu")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_distributed()
    assert not dist.is_distributed()


@pytest.mark.parametrize("local_rank, current", [(1, 1), (1, 0)])
def test_cuda_means_this_ranks_card_inside_a_group(monkeypatch, local_rank, current):
    """`cuda` is the card init_distributed made current: cuda:LOCAL_RANK, or
    the card it was given by index (two gloo ranks on one card both set
    cuda:0, and rank 1 has LOCAL_RANK=1)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert resolve_device(None) == resolve_device("cuda") == torch.device("cuda", current)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("command", ["serve", "export"])
def test_serve_and_export_refuse_distributed(command, monkeypatch):
    """Both run under a process group since the model axis came
    (tests/test_torch_mesh.py); outside torchrun's environment they refuse
    `--distributed`, as train and evaluate do."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launch with torchrun"):
        cli_main([command, "--synthetic", "--allow_random_params", "--distributed",
                  "--device", "cpu"])
    assert not dist.is_distributed()
