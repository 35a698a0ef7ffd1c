"""dlsg_tpu_torch's checkpoints: save_train -> restore_train round trips
bitwise (parameters, Adam state, step counters, the GAN-lambda state),
save_model -> restore_model, and latest_epoch against dlsg_tpu's."""

import os

import numpy as np
import pytest
import torch

from dlsg_tpu.checkpoint import latest_epoch as jax_latest_epoch
from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state, lambda_update
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_gan_train_step
from test_torch_parallel import tmp_path  # noqa: F401  (removed when a test ends)
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 30


def _batch(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, cfg.max_words + 1, size=n).astype(np.int32)
    caps = np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                    rng.integers(4, V, size=(n, cfg.max_words)), 0).astype(np.int32)
    return {
        "frames": rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(size=(n, cfg.max_frames, cfg.num_obj,
                                    cfg.region_feature_size)).astype(np.float32),
        "captions": caps, "lengths": lengths,
    }


def _states(cfg, frozen=()):
    g = CapGnnModel(cfg, V, device="cpu")
    d = DiscV2(cfg, V, generator=torch.Generator().manual_seed(1), device="cpu")
    return (TrainState.create(g, make_optimizer(1e-3, frozen_paths=frozen)),
            TrainState.create(d, make_optimizer(1e-3)))


def _assert_same(a: TrainState, b: TrainState):
    assert a.step == b.step and a.names == b.names
    for (n, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    assert len(sa["state"]) == (len(a.params) if a.step else 0)
    for i, st in sa["state"].items():
        for k, t in st.items():
            torch.testing.assert_close(t, sb["state"][i][k], rtol=0, atol=0, msg=f"{i}.{k}")


@pytest.mark.parametrize("frozen", [(), ("word_embed",)])
def test_save_train_restore_train_round_trip(tmp_path, frozen):
    cfg = tiny_test_config()
    gs, ds = _states(cfg, frozen)
    lstate = init_lambda_state(0.01, device="cpu")
    step = make_gan_train_step(gs.module, ds.module, cfg)
    for i in range(2):
        gs, ds, lstate, _ = step(gs, ds, lstate, _batch(cfg, seed=i), 5, 0.8)
    gs.set_learning_rate(5e-4)
    path = ckpt.save_train(str(tmp_path), 3, gs, ds, lambda_state=lstate)
    assert path == os.path.join(str(tmp_path), "epoch_3", ckpt.TRAIN_FILE)
    assert os.listdir(tmp_path / "epoch_3") == [ckpt.TRAIN_FILE]  # no temporary left

    fresh_g, fresh_d = _states(tiny_test_config(seed=99), frozen)  # other weights
    out = ckpt.restore_train(str(tmp_path), 3, fresh_g, fresh_d,
                             lambda_state=init_lambda_state(0.01, device="cpu"))
    assert out["epoch"] == 3 and out["gen_state"] is fresh_g and out["disc_state"] is fresh_d
    assert (fresh_g.step, fresh_d.step) == (2, 2 * cfg.num_D_visual)
    _assert_same(fresh_g, gs)
    _assert_same(fresh_d, ds)
    for k, t in lstate.items():
        torch.testing.assert_close(out["gan_lambda_state"][k], t, rtol=0, atol=0, msg=k)

    # the restored states train on as the saved ones do
    b = _batch(cfg, seed=7)
    gs, ds, lstate, m = step(gs, ds, lstate, b, 5, 0.8)
    step2 = make_gan_train_step(fresh_g.module, fresh_d.module, cfg)
    fresh_g, fresh_d, _, m2 = step2(fresh_g, fresh_d, out["gan_lambda_state"], b, 5, 0.8)
    _assert_same(fresh_g, gs)
    torch.testing.assert_close(m2["cap_loss"], m["cap_loss"], rtol=0, atol=0)


def test_generator_only_checkpoint_and_lambda_template(tmp_path):
    cfg = tiny_test_config(use_visual_gan=False)
    gs, _ = _states(cfg)
    ckpt.save_train(str(tmp_path), 0, gs)
    fresh, _ = _states(tiny_test_config(seed=5))
    out = ckpt.restore_train(str(tmp_path), 0, fresh, lambda_state=init_lambda_state(0.01, device="cpu"))
    assert out["disc_state"] is None and out["gan_lambda_state"] is None
    _assert_same(fresh, gs)

    lstate = init_lambda_state(0.01, device="cpu")
    for loss in (3.0, 2.5, 2.7):
        lstate, _ = lambda_update(lstate, torch.tensor(loss))
    ckpt.save_train(str(tmp_path), 1, gs, lambda_state=lstate)
    out = ckpt.restore_train(str(tmp_path), 1, fresh)  # no template: not restored
    assert out["gan_lambda_state"] is None
    tpl = {k: v.double() if v.is_floating_point() else v for k, v in lstate.items()}
    out = ckpt.restore_train(str(tmp_path), 1, fresh, lambda_state=tpl)
    assert out["gan_lambda_state"]["window"].dtype == torch.float64  # the template's dtype
    assert int(out["gan_lambda_state"]["count"]) == 3


def test_save_model_restore_model(tmp_path):
    model = CapGnnModel(tiny_test_config(), V, device="cpu")
    path = ckpt.save_model(str(tmp_path), "best_CIDEr", model.state_dict())
    assert path == os.path.join(str(tmp_path), "best_CIDEr", ckpt.MODEL_FILE)
    sd = ckpt.restore_model(str(tmp_path), "best_CIDEr")
    other = CapGnnModel(tiny_test_config(seed=3), V, device="cpu")
    other.load_state_dict(sd)
    for (n, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_model(str(tmp_path), "best_Bleu_4")


def test_latest_epoch_matches_jax(tmp_path):
    missing = str(tmp_path / "nowhere")
    assert ckpt.latest_epoch(missing) is None and jax_latest_epoch(missing) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert ckpt.latest_epoch(str(empty)) is None and jax_latest_epoch(str(empty)) is None
    mixed = tmp_path / "mixed"
    for name in ("epoch_2", "epoch_10", "epoch_x", "best_CIDEr", "epoch_", "epochs_40"):
        (mixed / name).mkdir(parents=True)
    (mixed / "notes.txt").write_text("")
    assert ckpt.latest_epoch(str(mixed)) == jax_latest_epoch(str(mixed)) == 10
