"""What the training cells share: the program's GAN train step built from
the seed's weights, what it is held to after its first steps, and the
reference's side of that comparison.

Numbers (a number is compared where the configuration's `limits` give it
a limit; the others are logged as `diagnostics`):
- `loss_gap`: the first step's cap_loss, |p - r| / max(|r|, 1). The
  later steps' losses and loss_G follow parameters that Adam's sign-like
  first updates have already moved by round-off, so they are logged;
- `grad_gap`: the generator's first gradient as Adam got it (clamped),
  read back from Adam's first moment after one step; the worst leaf's gap
  of norms, |‖g_p‖ - ‖g_r‖|, over the larger of that leaf's and the median
  leaf's reference norm;
- `g_change_gap`: the same for each generator leaf's change over the first
  steps (the worst leaf), and `d_change_gap` for the discriminator's (the
  median leaf: D takes five updates a step, each sign-like at first, so its
  worst leaf is round-off noise); both leave out the leaves whose reference
  first gradient is under a thousandth of the median leaf's (they move by
  round-off alone under Adam);
- `d_loss_gap`: the discriminator's first step, its loss, Wasserstein
  term and gradient penalty (each the mean over its substeps), the worst of
  the three gaps |p - r| / max(|r|, 1);
- `d_moment_gap`: the discriminator's gradients as Adam got them in the
  first step, read back from Adam's first moment after its substeps; the
  median leaf's gap of norms, as for `grad_gap`;
- `lambda_gap`: the GAN weight of each first step, |p - r| in float32. It
  moves only once its 200-step window of caption losses is full, so in the
  first steps it is the configuration's start value on both sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from portbench import inputs
from portbench.harness import Check, Run
from portbench.reference import model as ref

LOSSES = ("cap_loss", "loss_G", "loss_D", "wasserstein", "grad_penalty")
D_TERMS = ("loss_D", "wasserstein", "grad_penalty")
QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _shapes(r: Run):
    return ref.param_shapes(r.model_dict("training"), r.config["vocab_size"])


def _params(r: Run, device):
    gs, ds = _shapes(r)
    return (inputs.make_params(gs, r.seed, "generator", device, r.config["length_model"]),
            inputs.make_params(ds, r.seed, "discriminator", device))


def _norms(ts: Dict, scale: float = 1.0) -> Dict[str, float]:
    import torch

    names = list(ts)
    vals = torch.stack([ts[n].float().norm() for n in names]) * scale
    return dict(zip(names, vals.tolist()))


class Program:
    """The program's train step with its models, Adam states and lambda
    state: one object, from set-up through the window."""

    def __init__(self, r: Run, cfg, device):
        from dlsg_tpu_torch.models.discriminator import DiscV2
        from dlsg_tpu_torch.models.generator import CapGnnModel
        from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
        from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
        from dlsg_tpu_torch.train.steps import make_gan_train_step

        self.r, self.device = r, device
        V = r.config["vocab_size"]
        gp, dp = _params(r, device)
        gen = CapGnnModel(cfg, V, device=device)
        gen.load_state_dict(gp)
        disc = DiscV2(cfg, V, device=device)
        disc.load_state_dict(dp)
        del gp, dp
        self.gen, self.disc = gen, disc
        self.gstate = TrainState.create(gen, make_optimizer(cfg.learning_rate, cfg.grad_clip))
        self.dstate = TrainState.create(disc, make_optimizer(cfg.learning_rate))
        self.lstate = init_lambda_state(cfg.lambda_D_visual, device=device)
        self.fn = make_gan_train_step(gen, disc, cfg)
        self.g_first: Dict[str, float] = {}
        self.d_moment: Dict[str, float] = {}
        self.change: Dict[str, Dict[str, float]] = {}

    def step(self, batch, key: int, epsilon: float):
        self.gstate, self.dstate, self.lstate, m = self.fn(
            self.gstate, self.dstate, self.lstate, batch, key, epsilon)
        return m

    def record_first_grads(self) -> None:
        """After the first step: G's first gradient, as Adam got it
        (exp_avg / (1 - beta1)), and D's first moment after its substeps."""
        self.g_first = _norms(self.gstate.first_moments(), 1.0 / (1.0 - ref.ADAM_BETAS[0]))
        self.d_moment = _norms(self.dstate.first_moments())

    def record_changes(self) -> None:
        gp, dp = _params(self.r, self.device)
        for tag, model, p0 in (("G", self.gen, gp), ("D", self.disc, dp)):
            sd = model.state_dict()
            self.change[tag] = _norms({k: sd[k] - p0[k] for k in p0})

    def view(self, losses: Sequence[dict]) -> dict:
        return {"losses": list(losses), "g_first": self.g_first, "d_moment": self.d_moment,
                "change": self.change}


def reference_view(r: Run, batches: Sequence[dict], key: int, epsilon: float, device,
                   mode: str = "fp32") -> dict:
    """The reference's first steps from the same weights and batches."""
    import torch

    md = r.model_dict("training")
    gp, dp = _params(r, device)
    g0 = {k: v.clone() for k, v in gp.items()}
    d0 = {k: v.clone() for k, v in dp.items()}
    go = ref.Adam(gp, md["learning_rate"], md["grad_clip"])
    do = ref.Adam(dp, md["learning_rate"])
    lam = ref.GanLambda(md["lambda_D_visual"])
    losses, d_moment = [], {}
    with ref.precision(mode):
        for i, b in enumerate(batches):
            tb = {k: torch.as_tensor(b[k], device=device) for k in
                  ("frames", "regions", "captions", "lengths")}
            losses.append(ref.gan_step(gp, dp, go, do, lam, md, tb, key, i, epsilon))
            if i == 0:
                d_moment = _norms(do.m)
    return {"losses": losses, "g_first": _norms(go.first_grads), "d_first": _norms(do.first_grads),
            "d_moment": d_moment,
            "change": {"G": _norms({k: gp[k] - g0[k] for k in gp}),
                       "D": _norms({k: dp[k] - d0[k] for k in dp})}}


def _loud(first: Dict[str, float]) -> List[str]:
    med = float(np.median(list(first.values())))
    return [k for k, v in first.items() if v >= QUIET * med]


def _gaps(p: Dict[str, float], q: Dict[str, float], keep: Sequence[str]) -> np.ndarray:
    base = float(np.median([q[k] for k in keep]))
    return np.array([abs(p[k] - q[k]) / max(q[k], base) for k in keep])


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1.0)


def compare(prog: dict, refv: dict) -> Dict[str, float]:
    """Every number (module doc) of a program view and a reference view."""
    p1, r1 = prog["losses"][0], refv["losses"][0]
    g_keep, d_keep = _loud(refv["g_first"]), _loud(refv["d_first"])
    lam = [abs(float(np.float32(p["gan_lambda"])) - float(np.float32(q["gan_lambda"])))
           for p, q in zip(prog["losses"], refv["losses"])]
    return {
        "loss_gap": _rel(p1["cap_loss"], r1["cap_loss"]),
        "grad_gap": float(_gaps(prog["g_first"], refv["g_first"], list(refv["g_first"])).max()),
        "g_change_gap": float(_gaps(prog["change"]["G"], refv["change"]["G"], g_keep).max()),
        "d_change_gap": float(np.median(_gaps(prog["change"]["D"], refv["change"]["D"], d_keep))),
        "d_loss_gap": max(_rel(p1[k], r1[k]) for k in D_TERMS),
        "d_moment_gap": float(np.median(_gaps(prog["d_moment"], refv["d_moment"], d_keep))),
        "lambda_gap": max(lam),
    }


def diagnostics(prog: dict, refv: dict) -> Dict[str, float]:
    """What the numbers compared leave out, for the log: every step's loss
    gaps, and the other ends of the leaf spreads."""
    out = {f"step{i + 1}_{k}": _rel(p[k], q[k])
           for i, (p, q) in enumerate(zip(prog["losses"], refv["losses"])) for k in LOSSES}
    g_keep, d_keep = _loud(refv["g_first"]), _loud(refv["d_first"])
    g = _gaps(prog["change"]["G"], refv["change"]["G"], g_keep)
    d = _gaps(prog["change"]["D"], refv["change"]["D"], d_keep)
    dm = _gaps(prog["d_moment"], refv["d_moment"], d_keep)
    out.update(g_change_median=float(np.median(g)), d_change_worst=float(d.max()),
               d_moment_worst=float(dm.max()),
               d_change_worst_leaf=d_keep[int(d.argmax())], g_change_worst_leaf=g_keep[int(g.argmax())],
               quiet_leaves=len(refv["g_first"]) - len(g_keep) + len(refv["d_first"]) - len(d_keep))
    return out


def check(r: Run, batches: Sequence[dict], prog: dict, key: int, epsilon: float,
          device) -> List[Check]:
    refv = reference_view(r, batches, key, epsilon, device)
    limits = r.config["limits"]
    nums = compare(prog, refv)
    logged = {k: v for k, v in nums.items() if k not in limits}
    r.log(f"diagnostics: {dict(diagnostics(prog, refv), **logged)}")
    return [Check(k, v, limits[k]) for k, v in nums.items() if k in limits]
