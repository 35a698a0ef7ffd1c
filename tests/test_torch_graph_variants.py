"""dlsg_tpu_torch/models/graph_variants.py against dlsg_tpu.models.graph_variants
on the same numpy inputs with carried weights (the port of
tests/test_graph_variants.py).

Each module runs in eval mode (the JAX modules' default `train=False`: the
BatchNorms use their running statistics, which are set to seeded random
values first so that they matter) and in one train-mode forward (JAX's
`train=True` with `mutable=["batch_stats"]`, the port's training mode),
comparing the output and the updated running statistics. Dropout is off on
both sides (JAX's `deterministic=True`, the port's forward given no
generator). The encoders run with 8 objects (the object branch) and 4 (the
bypass), with `baseline=True` and with `use_embed=False`. fp32; every
comparison within 1e-5 (atol and rtol). The weights then round-trip through
`weights.py` (`params` and `batch_stats`), exactly.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models import graph_variants as jgv
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models import graph_variants as tgv
from dlsg_tpu_torch.weights import (
    batch_stats_from_jax,
    batch_stats_to_jax,
    params_from_jax,
    params_to_jax,
)

from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _random_stats(tree, rng):
    """A batch_stats tree of the same structure with seeded random running
    means and (positive) variances."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, size=x.shape) if path[-1].key == "var"
                         else rng.normal(size=x.shape)).astype(np.float32), tree)


def _case(name: str):
    """(JAX module, port module, inputs as numpy arrays) of one named
    case."""
    rng = np.random.default_rng(7)
    cfg = tiny_test_config()
    T, H = cfg.max_frames, cfg.visual_hidden_size
    if name == "latent_gnn":
        return jgv.LatentGNN(16, 4), tgv.LatentGNN(16, 4, device="cpu"), (_arr(rng, 2, 7, 16),)
    if name == "latent_gnn_mask":
        mask = (rng.uniform(size=(2, 1, 7)) > 0.3).astype(np.float32)
        return (jgv.LatentGNN(16, 4), tgv.LatentGNN(16, 4, device="cpu"),
                (_arr(rng, 2, 7, 16), mask))
    if name == "gnn":
        return (jgv.GNN(feature_size=20, out_size=8), tgv.GNN(20, 8, device="cpu"),
                (_arr(rng, 2, 3, 4, 20),))
    if name.startswith("gat"):
        concat = name == "gat"
        return (jgv.GraphAttentionLayer(16, 12, dropout=0.1, concat=concat),
                tgv.GraphAttentionLayer(16, 12, 0.1, concat=concat, device="cpu"),
                (_arr(rng, 2, 6, 16), _arr(rng, 2, 3, 16)))
    kind, variant = name.split(":")
    num_obj = 4 if variant == "4obj" else 8
    kw = {"baseline": variant == "baseline", "use_embed": variant != "no_embed"}
    cfg, jcfg = tiny_test_config(num_obj=num_obj), jax_tiny(num_obj=num_obj)
    width = cfg.a_feature_size if kw["use_embed"] else H
    frames = _arr(rng, 2, T, width)
    regions = _arr(rng, 2, T, num_obj, cfg.region_feature_size)
    jcls, tcls = {"graph": (jgv.EncoderVisualGraph, tgv.EncoderVisualGraph),
                  "gat": (jgv.EncoderVisualGAT, tgv.EncoderVisualGAT)}[kind]
    return (jcls(jcfg, input_type="object", **kw),
            tcls(cfg, "object", visual_size=width, device="cpu", **kw), (frames, regions))


CASES = ["latent_gnn", "latent_gnn_mask", "gnn", "gat", "gat_no_concat"] + [
    f"{kind}:{variant}" for kind in ("graph", "gat")
    for variant in ("8obj", "4obj", "baseline", "no_embed")]


def _setup(name):
    """Both modules with the same weights (JAX's init, random running
    statistics): (JAX module, its variables, port module, numpy inputs)."""
    jmod, tmod, inputs = _case(name)
    variables = dict(jmod.init(jax.random.PRNGKey(0), *inputs))
    if "batch_stats" in variables:
        variables["batch_stats"] = _random_stats(variables["batch_stats"],
                                                 np.random.default_rng(11))
    tmod.load_state_dict({**params_from_jax(variables["params"]),
                          **batch_stats_from_jax(variables.get("batch_stats", {}))})
    return jmod, variables, tmod, inputs


def _torch_inputs(inputs):
    return [torch.from_numpy(x) for x in inputs]


def _train_kwargs(jmod):
    """JAX's train-mode switch of each module (GNN and the GAT layer have
    no batch statistics and no such switch)."""
    return {} if isinstance(jmod, (jgv.GNN, jgv.GraphAttentionLayer)) else {"train": True}


@pytest.mark.parametrize("name", CASES)
def test_eval_mode_matches_jax(name):
    jmod, variables, tmod, inputs = _setup(name)
    want = jmod.apply(variables, *inputs)
    with torch.no_grad():
        got = tmod(*_torch_inputs(inputs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", CASES)
def test_train_mode_forward_and_batch_stats_match_jax(name):
    """One train-mode forward: the output (normalized with the batch's
    statistics) and the updated running statistics."""
    jmod, variables, tmod, inputs = _setup(name)
    want, updated = jmod.apply(variables, *inputs, mutable=["batch_stats"], **_train_kwargs(jmod))
    tmod.train()
    got = tmod(*_torch_inputs(inputs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    want_stats = updated.get("batch_stats", {})
    got_stats = batch_stats_to_jax(tmod.state_dict())
    assert jax.tree_util.tree_structure(got_stats) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want_stats))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_stats),
                            jax.tree_util.tree_leaves(got_stats)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL, err_msg=str(path))
    if "batch_stats" in variables:  # the forward did update them
        assert not all(np.array_equal(a, np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(got_stats),
            jax.tree_util.tree_leaves(variables["batch_stats"])))


@pytest.mark.parametrize("name", CASES)
def test_weights_round_trip(name):
    """The port's state_dict -> flax `params` and `batch_stats` give JAX's
    trees exactly, and back."""
    _, variables, tmod, _ = _setup(name)
    sd = tmod.state_dict()
    params, stats = params_to_jax(sd), batch_stats_to_jax(sd)
    want_params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want_params)
    for g, w in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_array_equal(g, w)
    want_stats = jax.tree_util.tree_map(np.asarray, dict(variables.get("batch_stats", {})))
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want_stats)
    for g, w in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_array_equal(g, w)
    back = {**params_from_jax(params), **batch_stats_from_jax(stats)}
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(64, 5), (3, 9, 6), (2, 3, 4, 7)])
def test_batch_norm_is_flax_batch_norm(shape, train):
    """`BatchNorm` against flax's on inputs of several ranks, with a mean
    away from 0 and scale and bias not 1 and 0: the output and the running
    statistics (the variance the biased one; torch's `BatchNorm1d` would
    update with the unbiased one, 1/(n-1) larger)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 2).astype(np.float32)
    F = shape[-1]
    variables = {"params": {"scale": rng.normal(size=F).astype(np.float32),
                            "bias": rng.normal(size=F).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=F).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, size=F).astype(np.float32)}}
    want, updated = flax.linen.BatchNorm(use_running_average=not train).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tgv.BatchNorm(F)
    bn.load_state_dict({**params_from_jax(variables["params"]),
                        **batch_stats_from_jax(variables["batch_stats"])})
    bn.train(train)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    stats = batch_stats_to_jax(bn.state_dict())
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(updated["batch_stats"][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_encoder_without_object_branch_refuses_objects():
    """Built for fewer than 5 objects (no object branch, as JAX's tree has
    none), the encoder refuses inputs of 5 or more."""
    cfg = tiny_test_config(num_obj=4)
    mod = tgv.EncoderVisualGraph(cfg, visual_size=cfg.a_feature_size, device="cpu")
    assert not hasattr(mod, "obj_embed")
    frames = torch.zeros(1, cfg.max_frames, cfg.a_feature_size)
    with pytest.raises(ValueError, match="object branch"):
        mod(frames, torch.zeros(1, cfg.max_frames, 6, cfg.region_feature_size))


def test_dropout_acts_in_training_mode_with_a_generator():
    """The GAT layer's attention dropout and the encoder's self-attention
    dropout act only in training mode when given a generator, and the
    same generator state gives the same output."""
    cfg = tiny_test_config(dropout=0.3)
    mod = tgv.EncoderVisualGAT(cfg, visual_size=cfg.a_feature_size, device="cpu")
    rng = np.random.default_rng(2)
    fr = torch.from_numpy(_arr(rng, 2, cfg.max_frames, cfg.a_feature_size))
    rg = torch.from_numpy(_arr(rng, 2, cfg.max_frames, cfg.num_obj, cfg.region_feature_size))
    with torch.no_grad():
        ref = mod(fr, rg)
        assert torch.equal(mod(fr, rg, rng=torch.Generator().manual_seed(1)), ref)  # eval mode
        mod.train()
        a = mod(fr, rg, rng=torch.Generator().manual_seed(1))
        b = mod(fr, rg, rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.allclose(a, mod(fr, rg), atol=1e-3)
