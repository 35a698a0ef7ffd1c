"""dlsg_tpu_torch: weight bridge, config/vocab copies, package isolation and
device selection."""

import dataclasses
import importlib
import inspect
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import DLSGConfig as JaxConfig
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.vocab import Vocabulary as JaxVocabulary
from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides, tiny_test_config
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.vocab import Vocabulary
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax

V = 40


def _jax_params(cfg):
    B = 2
    frames = jnp.zeros((B, cfg.max_frames, cfg.feature_size))
    regions = jnp.zeros((B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size))
    caps = jnp.zeros((B, cfg.max_words), jnp.int32)
    return JaxCapGnnModel(cfg, V).init(jax.random.PRNGKey(3), frames, regions, caps)["params"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("joint", [False, True])
def test_flax_torch_flax_round_trip(joint):
    """A tiny CapGnnModel's flax tree loads strictly into the torch model and
    comes back as an equal tree (same paths, bitwise-equal arrays)."""
    params = _jax_params(jax_tiny(joint_region_projection=joint))
    model = CapGnnModel(tiny_test_config(joint_region_projection=joint), V, device="cpu")
    model.load_state_dict(params_from_jax(params))  # strict: same key set
    back = _flat(params_to_jax(model.state_dict()))
    want = _flat(jax.tree_util.tree_map(np.asarray, params))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_dense_kernel_is_transposed():
    params = _jax_params(jax_tiny())
    sd = params_from_jax(params)
    k = np.asarray(params["decoder"]["step"]["word_restore"]["kernel"])
    np.testing.assert_array_equal(sd["decoder.step.word_restore.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        sd["decoder.step.lang_lstm.w_hh"].numpy(),
        np.asarray(params["decoder"]["step"]["lang_lstm"]["w_hh"]),
    )


def test_config_fields_and_defaults_match():
    """Same field names and defaults, so a bundle's config JSON loads into
    both packages; the dtype properties return torch dtypes."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(DLSGConfig)}
    assert jf == tf
    assert dataclasses.asdict(tiny_test_config()) == dataclasses.asdict(jax_tiny())
    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16"))
    assert (cfg.decode_hidden_size, cfg.num_proposals, cfg.num_obj) == (1536, 5, 36)
    assert cfg.cdtype == torch.bfloat16 and DLSGConfig().cdtype == torch.float32
    assert DLSGConfig(input_stage_dtype="bfloat16").stage_dtype == torch.bfloat16
    assert DLSGConfig().stage_dtype is None
    with pytest.raises(ValueError):
        DLSGConfig(input_stage_dtype="int8").stage_dtype


def test_vocab_matches_jax():
    words = ["a", "man", "is", "cooking"]
    tv, jv = Vocabulary.from_words(words), JaxVocabulary.from_words(words)
    assert tv.idx2word == jv.idx2word
    toks = [4, 5, 6, 2, 7]
    assert tv.decode_tokens(toks) == jv.decode_tokens(toks) == "a man is"
    assert tv("unseen") == jv("unseen") == 3


def test_package_imports_no_jax():
    """Importing the port and every submodule (the train, trainer, data,
    metrics, CLI, server, convert, native and worker-pool modules among
    them, and the data-parallel module) pulls in no jax, flax or dlsg_tpu
    module."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import dlsg_tpu_torch
        for m in pkgutil.walk_packages(dlsg_tpu_torch.__path__, "dlsg_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "flax", "jaxlib", "dlsg_tpu"))
        assert not bad, bad
        for m in ("models.discriminator", "ops.losses", "train.optim", "train.gan_lambda",
                  "train.schedule", "train.steps", "train.trainer", "checkpoint", "cli",
                  "data.loader", "data.datasets", "data.prefetch", "evaluation.evaluate",
                  "metrics.scorer", "metrics.meteor", "utils.profiler", "server", "convert",
                  "native", "data.parallel_loader", "parallel.dist"):
            assert "dlsg_tpu_torch." + m in sys.modules, m
        print("imported", len([n for n in sys.modules if n.startswith("dlsg_tpu_torch")]))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    """Without a card and without device='cpu' (`--device cpu`) the entry
    points raise, naming the option; they never carry on on the CPU."""
    from dlsg_tpu_torch.cli import main
    from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.serve import Captioner
    from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
    from dlsg_tpu_torch.train.trainer import RunGAN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Captioner(cfg, vocab, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CapGnnModel(cfg, V)
    model = CapGnnModel(cfg, V, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_fn(model, cfg, beam_size=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lambda_state(0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Captioner.from_checkpoint(cfg, vocab, ckpt_dir="no_such_dir")
    ds = SyntheticDataset(cfg, make_vocab(), num_videos=2, captions_per_video=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RunGAN(cfg, make_vocab(), ds, ds.eval_view(), ds.references)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["train", "--synthetic", "--synthetic_videos", "2", "--epoch_num", "1"])


def test_port_bundle_loads_in_jax(tmp_path):
    """A bundle written by the port's save_bundle reads back in dlsg_tpu's
    load_bundle with the same config, vocabulary and parameter tree."""
    from dlsg_tpu.bundle import load_bundle as jax_load_bundle
    from dlsg_tpu_torch.bundle import load_bundle, save_bundle

    cfg = tiny_test_config(beam_size=2)
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    model = CapGnnModel(cfg, V, device="cpu")
    path = str(tmp_path / "port.dlsg.npz")
    save_bundle(path, cfg, vocab, params_to_jax(model.state_dict()))
    jcfg, jvocab, jtree = jax_load_bundle(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jvocab.idx2word == vocab.idx2word
    tcfg, _, ttree = load_bundle(path)
    assert tcfg == cfg
    want = model.state_dict()
    for k, t in params_from_jax(jtree).items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0)
    assert _flat(ttree).keys() == _flat(jtree).keys()


def test_jsonable_id_matches_jax():
    from dlsg_tpu.serve import jsonable_id as jax_jsonable_id
    from dlsg_tpu_torch.serve import jsonable_id

    for vid in (np.int64(7001), 3, "video7001", np.str_("v1")):
        assert jsonable_id(vid) == jax_jsonable_id(vid)
        assert type(jsonable_id(vid)) is type(jax_jsonable_id(vid))


# JAX exports with no counterpart of the same name: the XLA placement
# helpers (the port's collectives are explicit: parallel/mesh.py has no
# arrays to place) and ParallelBatcher (the port's worker pool is
# data/parallel_loader.py::WorkerPool)
NOT_EXPORTED = {
    "parallel": {"batch_sharding", "replicated", "shard_batch"},
    "data": {"ParallelBatcher"},
}


@pytest.mark.parametrize("sub", ["data", "evaluation", "metrics", "models", "parallel", "train", "utils"])
def test_subpackage_exports_match_jax(sub):
    """Every function or class a dlsg_tpu subpackage's __init__ re-exports
    from its modules is exported by the port's subpackage under the same
    name as the same kind, apart from NOT_EXPORTED."""
    jmod = importlib.import_module(f"dlsg_tpu.{sub}")
    tmod = importlib.import_module(f"dlsg_tpu_torch.{sub}")
    exported = {
        n: o for n, o in vars(jmod).items()
        if (inspect.isfunction(o) or inspect.isclass(o)) and o.__module__.startswith(f"dlsg_tpu.{sub}.")
    }
    assert exported
    for name, obj in exported.items():
        if name in NOT_EXPORTED.get(sub, ()):
            continue
        got = getattr(tmod, name, None)
        assert got is not None, f"dlsg_tpu_torch.{sub} does not export {name}"
        assert (inspect.isclass(got), inspect.isfunction(got)) == (
            inspect.isclass(obj), inspect.isfunction(obj)), name
