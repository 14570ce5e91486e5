"""What a train driver needs: the program's step built on the
benchmark's seeded weights, the readings of its first steps that the
reference checks, the reference's run, the comparison, and the counts of
a step's work.

The first :data:`CHECK_STEPS` steps run in set-up through the window's own
call and feed, on distinct batches. Their readings: each step's total loss
(from the metrics copied to the host, as the loop copies them), each
leaf's first gradient as Adam holds it after one step (its first moment
over 1 - beta1), and each leaf's change after the last of them, taken
before the window's first step moves it.

The numbers compared: ``loss_gap``, the first step's loss against the
reference's, relative (the later steps' losses move with the elements
whose gradient is near zero, which Adam's first steps turn into whole
steps of either sign, and swing on sound runs); ``grad_gap`` and
``change_gap``, each the worst leaf's gap of norms against the
reference's norm of that leaf or of the median leaf, whichever is larger;
``grad_median_gap``, the median leaf's gap of first-gradient norms (the
worst leaf is a small batch-norm leaf that changes from seed to seed).
The change leaves out the leaves whose reference gradient is below
:data:`STILL_LEAF` of the median leaf's.

The 3D net's module (:mod:`benchmark.reference.nets3d`, by
``MODEL_3D.TYPE``) may add numbers of its own blocks: in the first step its
``check_hooks`` keep what they read from the program's 3D net, and after
the window its ``check_gaps`` work them out again with the reference.
"""

from __future__ import annotations

import gc
import statistics

import numpy as np
import torch

from benchmark.harness import counts, weights
from benchmark.harness.core import Phases, internal_seed, port_cfg
from benchmark.reference import model as ref
from benchmark.reference import nets3d

CHECK_STEPS = 3
# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by rounding alone, and its change is not compared
STILL_LEAF = 1e-3
# the stages of a train step (the program's record_function ranges)
STAGES = ("train/decode", "train/vgi", "train/plan", "train/net2d",
          "train/net3d", "train/losses", "train/backward", "train/optim",
          "train/ema")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a per-tensor scale (amax to 448), back in t's
    dtype, the gradient passed straight through."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    s = 448.0 / amax
    q = (t.detach().float() * s).to(torch.float8_e4m3fn).float() / s
    return t + (q.to(t.dtype) - t).detach()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``), the gradient passed straight
    through."""
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


# a configuration's control: the rounding of the operands of each dtype
CONTROLS = {"fp8": {torch.bfloat16: _fp8},
            "tf32": {torch.float32: _tf32},
            "fp8+tf32": {torch.bfloat16: _fp8, torch.float32: _tf32}}


def seeds(seed: int) -> dict:
    s = internal_seed(seed)
    return {"weights_2d": s * 4 + 1, "weights_3d": s * 4 + 2,
            "dropout": s * 4 + 3, "data": s}


def meta_nets(cfg_values: dict) -> tuple:
    with torch.device("meta"):
        return ref.build_nets(cfg_values, "meta")


def reference_params(cfg_values: dict, seed: int, device) -> tuple:
    net2d, net3d = meta_nets(cfg_values)
    s = seeds(seed)
    return (weights.seeded_params(net2d, s["weights_2d"], device),
            weights.seeded_params(net3d, s["weights_3d"], device))


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: dict, refn: dict, keep=None) -> list:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    names = [k for k in refn if keep is None or keep(k)]
    med = statistics.median(refn[k] for k in names)
    return [abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
            for k in names]


def worst_leaf_gap(prog: dict, refn: dict, keep=None) -> float:
    return max(leaf_gaps(prog, refn, keep))


def worst_leaves(prog: dict, refn: dict, keep=None, n: int = 3) -> list:
    """The ``n`` leaves of the widest gaps: [name, gap, ref / median]."""
    names = [k for k in refn if keep is None or keep(k)]
    med = statistics.median(refn[k] for k in names)
    gaps = sorted(((abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30), k)
                   for k in names), reverse=True)[:n]
    return [[k, g, refn[k] / med] for g, k in gaps]


class TrainCell:
    """The program's model pair, state and step for a train cell."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf = conf
        self.values = conf["cfg"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.cfg = port_cfg(self.values, seed)
        self.with_mopa = bool(traffic.get("with_mopa", False))
        self.net, self.sub = nets3d.of(self.values["MODEL_3D"])
        self.readings = {"losses": []}
        self.done = 0           # steps taken
        self.phases = Phases()
        self.worst = {}

    # -- the program ------------------------------------------------------
    def build(self) -> None:
        with self.phases("build"):
            self._build()

    def _build(self) -> None:
        from mopa_tpu_torch.train import trainer

        s = seeds(self.seed)
        models = trainer.build_models(self.cfg, device=self.device,
                                      seed=s["weights_2d"])
        p2d, p3d = reference_params(self.values, self.seed, self.device)
        weights.load_into(models.model_2d, p2d)
        weights.load_into(models.model_3d, p3d)
        del p2d, p3d
        self.models = models
        self.state = trainer.create_train_state(self.cfg, models,
                                                seed=s["dropout"])
        self.step_fn = trainer.make_train_step(
            self.cfg, models, with_pl=True, with_ema=False,
            with_mopa=self.with_mopa)

    def step(self, src, trg) -> dict:
        """One step as the train loop takes it: the call, then its metrics
        copied to the host."""
        from mopa_tpu_torch.train.common import host_metrics

        hooks = []
        if self.done == 0 and hasattr(self.net, "check_hooks"):
            hooks = self.net.check_hooks(self.models.model_3d, self.readings)
        try:
            self.state, metrics = self.step_fn(self.state, src, trg)
        finally:
            for h in hooks:
                h.remove()
        out = host_metrics(metrics)
        self.done += 1
        if self.done <= CHECK_STEPS:
            self._read(out)
        return out

    def _read(self, metrics: dict) -> None:
        self.readings["losses"].append(float(metrics["total_loss"]))
        st = self.state
        if self.done == 1:
            grads = {}
            for pre, params, opt in (("2d.", st.params_2d, st.opt_2d),
                                     ("3d.", st.params_3d, st.opt_3d)):
                beta1 = opt.optimizer.param_groups[0]["betas"][0]
                for k, p in params.items():
                    m = opt.optimizer.state.get(p, {}).get("exp_avg")
                    grads[pre + k] = (0.0 if m is None else
                                      float(m.float().norm()) / (1 - beta1))
            self.readings["grads"] = grads
        if self.done == CHECK_STEPS:
            p2d, p3d = reference_params(self.values, self.seed, self.device)
            change = {}
            for pre, params, start in (("2d.", st.params_2d, p2d),
                                       ("3d.", st.params_3d, p3d)):
                for k, p in params.items():
                    change[pre + k] = float((p.detach() - start[k]).norm())
            self.readings["change"] = change

    def release(self) -> None:
        """Free the program's models, state and step."""
        for name in ("state", "step_fn", "models"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def reference_readings(self, pairs: list, control=None) -> dict:
        """The reference's readings over ``pairs`` (raw source, raw target,
        VGI generator or None), as :func:`ref.train_readings` gives them,
        reduced to norms."""
        p2d, p3d = reference_params(self.values, self.seed, self.device)
        rnd = self.control() if control else None
        with self.phases("control" if control else "reference"):
            out = ref.train_readings(self.values, p2d, p3d, pairs,
                                     seeds(self.seed)["dropout"],
                                     self.device, control=rnd)
        return {"losses": out["losses"], "grads": leaf_norms(out["grads"]),
                "change": leaf_norms(out["change"])}

    def compare(self, prog: dict, refr: dict) -> dict:
        """The three numbers compared (module docstring); the three worst
        leaves of each go to ``self.worst``."""
        loss = abs(prog["losses"][0] - refr["losses"][0]) \
            / abs(refr["losses"][0])
        gaps = leaf_gaps(prog["grads"], refr["grads"])
        grad = max(gaps)
        med = statistics.median(refr["grads"].values())
        moving = {k for k, v in refr["grads"].items() if v >= STILL_LEAF * med}
        change = worst_leaf_gap(prog["change"], refr["change"],
                                keep=lambda k: k in moving)
        self.worst = {"grad": worst_leaves(prog["grads"], refr["grads"]),
                      "change": worst_leaves(
                          prog["change"], refr["change"],
                          keep=lambda k: k in moving),
                      "losses": [prog["losses"], refr["losses"]]}
        return {"loss_gap": loss, "grad_gap": grad,
                "grad_median_gap": statistics.median(gaps),
                "change_gap": change}

    def check_gaps(self, raw_src: dict, raw_trg: dict,
                   control: bool) -> dict:
        """The 3D net's own numbers over the first step's batch pair
        (``{"program": {name: gap}}``, with ``control`` also
        ``"control"``); {} where its module adds none."""
        if not hasattr(self.net, "check_gaps"):
            return {}
        torch.backends.cuda.matmul.allow_tf32 = False
        net3d = self.reference_net3d()
        feats, plan, nd = self.net_input(raw_src, raw_trg, net3d.num_levels)
        return self.net.check_gaps(self.readings, net3d, feats, plan, nd,
                                   self.control() if control else None)

    def net_input(self, raw_src: dict, raw_trg: dict, num_levels: int,
                  rng=None) -> tuple:
        """(features, plan, domains) of the reference's 3D net for a raw
        batch pair, on the cell's device, with the cat scans of ``rng``
        for MoPA."""
        dev = self.device
        src, trg = ref.decode(raw_src, dev), ref.decode(raw_trg, dev)
        cat = (None if rng is None else
               ref.vgi_cat(self.values, raw_trg, rng, dev))
        return ref.scans_input(src, trg, cat, num_levels)

    def control(self) -> dict:
        """The configuration's control: a rounding of GEMM operands by
        their dtype."""
        return CONTROLS[self.conf["control"]]

    def reference_net3d(self):
        """The reference's 3D net with the seeded weights, on the cell's
        device, in training mode."""
        net3d = ref.build_net3d(self.values, self.device)
        ref.load(net3d, reference_params(self.values, self.seed,
                                         self.device)[1])
        return net3d.train()

    # -- counts -------------------------------------------------------------
    def step_counts(self, raw_src: dict, raw_trg: dict, rng) -> dict:
        """Least time of the step's K1 / K2 launches and the step's model
        operations at peak (seconds), from the benchmark's own plan of the
        batch pair (with the cat scans of ``rng`` for MoPA), and what the
        3D net's module counts besides (its ``work``)."""
        dt = ref.compute_dtype(self.values)
        plan = self.net_input(raw_src, raw_trg,
                              meta_nets(self.values)[1].num_levels, rng)[1]
        stats = counts.level_stats(plan)
        convs = self.net.convs(self.sub, dt)
        b, p = raw_src["img_indices"].shape[:2]
        h, w = raw_src["img"].shape[1:3]
        peak_s = counts.conv_peak_s(convs, stats) + self.head_peak_s(
            stats, int(plan.point_voxel.shape[0]),
            int(plan.point_voxel.ge(0).sum()), 2 * b * p, 2 * b * h * w)
        peak_s += counts.unet2d_flops(2 * b, h, w) / counts.PEAK_FLOPS[dt]
        out = {"conv_least_s": counts.conv_kernel_least_s(convs, stats,
                                                          backward=True),
               "model_peak_s": 3 * peak_s}
        if hasattr(self.net, "work"):
            out.update(self.net.work(self.sub, dt, plan, stats))
        return out

    def head_peak_s(self, stats: list, n3d: int, n_valid: int, n2d: int,
                    pixels: int) -> float:
        """The float32 linear layers: the 2D net's heads over its points,
        the dense 2D head with SAM, then the 3D net's own operations that
        are not its convs (its module's ``peak_s``)."""
        c = int(self.values["MODEL_2D"]["NUM_CLASSES"])
        heads = 2 if self.values["MODEL_2D"]["DUAL_HEAD"] else 1
        out = heads * counts.dense_peak_s(n2d, 64, c)
        if float(self.values["TRAIN"]["PC_MM"]["lambda_sam_cons"]) > 0:
            out += counts.dense_peak_s(pixels, 64, c)
        return out + self.net.peak_s(self.sub, ref.compute_dtype(self.values),
                                     stats, n3d, n_valid, heads, c)


def check_numbers(cell: TrainCell, pairs, control: bool) -> dict:
    """{"program": numbers} of the program's readings against the
    reference's over ``pairs()``, and with ``control`` {"control":
    numbers} of the control's."""
    first = pairs()[0]
    refr = cell.reference_readings(pairs())
    out = {"program": cell.compare(cell.readings, refr)}
    worst = {"program": cell.worst}
    if control:
        out["control"] = cell.compare(
            cell.reference_readings(pairs(), control=True), refr)
        worst["control"] = cell.worst
    cell.worst = worst
    for who, gaps in cell.check_gaps(first[0], first[1], control).items():
        out[who].update(gaps)
    return out


def vgi_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([internal_seed(seed), 7, index])

