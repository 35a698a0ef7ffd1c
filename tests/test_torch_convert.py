"""dlsg_tpu_torch's reference-checkpoint import (`convert.py`) against
dlsg_tpu's (`dlsg_tpu/convert.py`).

A reference-schema state_dict, built by tests/test_convert.py's key-set
helper (the exact keys of the reference CapGnnModel, dead ones included),
goes through both packages: the JAX-layout trees must be equal bitwise, the
port's state_dict must load strictly, and greedy and beam decode must give
JAX's token ids exactly (fp32 on both sides)."""

import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.convert import convert_capgnn_state_dict as jax_convert_capgnn
from dlsg_tpu.convert import convert_discv2_state_dict as jax_convert_discv2
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu_torch import convert
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from test_convert import VOCAB, _latent_psl, _linear, _ln, _lstm_seq, _reference_capgnn_sd, _self_att
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)
from test_torch_weights import _flat

B = 4


def _reference_discv2_sd(cfg, dim, rng):
    """The key set of the reference DiscV2.state_dict() (as in
    tests/test_convert.py::test_discv2_round_trip_structure)."""
    H = cfg.visual_hidden_size
    sd = {
        "conv1d.weight": rng.normal(size=(dim, VOCAB, 1)).astype(np.float32),
        "conv1d.bias": rng.normal(size=(dim,)).astype(np.float32),
        "block.0.res_block.1.weight": rng.normal(size=(dim, dim, 3)).astype(np.float32),
        "block.0.res_block.1.bias": rng.normal(size=(dim,)).astype(np.float32),
        "fusion": rng.normal(size=(2, dim)).astype(np.float32),
    }
    _lstm_seq(sd, "lstm", dim, dim, rng)
    _ln(sd, "layer_norm", dim, rng)
    _self_att(sd, "att", dim, dim, dim, rng)
    _ln(sd, "att_norm.1", dim, rng)
    for k in ("obj_psl_score", "motion_psl_score"):
        _linear(sd, f"{k}.psl_embed.0", H, dim, rng=rng)
        _ln(sd, f"{k}.psl_embed.2", dim, rng)
        _linear(sd, f"{k}.att_norm.0", dim, dim, rng=rng)
        _ln(sd, f"{k}.att_norm.2", dim, rng)
        _ln(sd, f"{k}.psl_norm.1", dim, rng)
        _linear(sd, f"{k}.psl_scorer.classify", dim, 1, rng=rng)
        _linear(sd, f"{k}.psl_scorer.visual_embed.0", dim, dim, rng=rng)
        _linear(sd, f"{k}.psl_scorer.sent_embed.0", dim, dim, rng=rng)
    _latent_psl(sd, "text_sum", dim, 1, rng)
    return sd


def _clips(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(
        np.float32
    )
    return frames, regions


@pytest.mark.parametrize("joint", [False, True])
def test_reference_generator_decodes_as_in_jax(joint):
    jcfg, cfg = jax_tiny(joint_region_projection=joint), tiny_test_config(joint_region_projection=joint)
    sd = _reference_capgnn_sd(jcfg, np.random.default_rng(0))
    tree, jtree = convert.convert_capgnn_state_dict(sd, cfg), jax_convert_capgnn(sd, jcfg)
    got, want = _flat(tree), _flat(jtree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    model = CapGnnModel(cfg, VOCAB, device="cpu")
    model.load_state_dict(convert.capgnn_from_reference(sd, cfg))  # strict
    frames, regions = _clips(cfg)
    jmodel = JaxCapGnnModel(jcfg, VOCAB)
    for beam in (1, 3):
        ids = make_decode_fn(model, cfg, beam_size=beam, device="cpu")(frames, regions)
        jids = jax_make_decode_fn(jmodel, jcfg, beam_size=beam)(jtree, frames, regions)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_reference_discriminator_loads_strictly():
    cfg, dim = tiny_test_config(), 16
    sd = _reference_discv2_sd(cfg, dim, np.random.default_rng(1))
    got, want = _flat(convert.convert_discv2_state_dict(sd, cfg)), _flat(jax_convert_discv2(sd, jax_tiny()))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    disc = DiscV2(cfg, VOCAB, dim=dim, device="cpu")
    disc.load_state_dict(convert.discv2_from_reference(sd, cfg))  # strict
    torch.testing.assert_close(disc.state_dict()["block.conv.weight"],
                               torch.from_numpy(sd["block.0.res_block.1.weight"]), rtol=0, atol=0)


def test_load_reference_checkpoint(tmp_path):
    """A reference epoch file of torch tensors (and a numpy cap_list) loads
    with weights_only into the port's state_dicts."""
    cfg = tiny_test_config()
    sd = _reference_capgnn_sd(jax_tiny(), np.random.default_rng(2))
    dsd = _reference_discv2_sd(cfg, 16, np.random.default_rng(3))
    pt = tmp_path / "ref_epoch.pt"
    torch.save({"epoch": 7, "model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "model_d_state_dict": {k: torch.from_numpy(v) for k, v in dsd.items()},
                "cap_list": np.arange(3)}, str(pt))
    out = convert.load_reference_checkpoint(str(pt), cfg)
    assert out["epoch"] == 7 and out["cap_list"].tolist() == [0, 1, 2]
    want = convert.capgnn_from_reference(sd, cfg)
    assert out["generator"].keys() == want.keys()
    for k in want:
        torch.testing.assert_close(out["generator"][k], want[k], rtol=0, atol=0)
    assert out["discriminator"].keys() == convert.discv2_from_reference(dsd, cfg).keys()


def test_load_reference_checkpoint_rejects_arbitrary_pickles(tmp_path):
    class Payload:  # stands in for any attacker-controlled class
        def __reduce__(self):
            return (print, ("pwned",))

    pt = tmp_path / "evil.pt"
    torch.save({"model_state_dict": {}, "cap_list": Payload()}, str(pt))
    with pytest.raises(Exception) as ei:
        convert.load_reference_checkpoint(str(pt), tiny_test_config())
    assert "pwned" not in str(ei.value)


def test_chip_smoke_reference_state_dict_has_the_reference_key_set():
    """chip_smoke.py writes its own reference-schema .pt for `cli evaluate
    --torch_checkpoint` on the card (the card's machine has no JAX, so it
    cannot use the tests' helper): the same keys and shapes as
    tests/test_convert.py's, and it loads strictly after conversion."""
    import chip_smoke

    cfg = tiny_test_config()
    got = chip_smoke.reference_state_dict(cfg, VOCAB, seed=0)
    want = _reference_capgnn_sd(jax_tiny(), np.random.default_rng(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    CapGnnModel(cfg, VOCAB, device="cpu").load_state_dict(convert.capgnn_from_reference(got, cfg))
