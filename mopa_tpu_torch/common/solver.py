"""Optimizers and LR schedules (PyTorch port of
``mopa_tpu/common/solver.py``).

The reference builds one optimizer per net from ``OPTIMIZER.MODEL_{2D,3D}``
(Adam or SGD) and steps an iteration-indexed LR multiplier (StepLR,
MultiStepLR, WarmupMultiStepLR) with an optional ``CLIP_LR`` floor. Here
:func:`build_optimizer` returns an :class:`OptimizerSpec` (the counterpart of
an optax transform) whose ``init(params)`` gives a :class:`ScheduledOptimizer`
(the counterpart of its state): a ``torch.optim`` optimizer plus the count of
updates it has made, which indexes the schedule as optax's count does.

* Adam: eps 1e-8, betas from the config; ``WEIGHT_DECAY`` is coupled L2
  (optax ``add_decayed_weights`` before Adam = torch Adam's
  ``weight_decay``).
* SGD: momentum from the config, no dampening (optax ``trace``), coupled
  weight decay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """Iteration-indexed LR multiplier ``schedule(step) -> float``."""
    sched_cfg = cfg.SCHEDULER
    kind = sched_cfg.TYPE
    if kind == "MultiStepLR":
        milestones = [int(m) for m in sched_cfg.MultiStepLR.milestones]
        gamma = float(sched_cfg.MultiStepLR.gamma)

        def schedule(step):
            return gamma ** sum(step >= m for m in milestones)

    elif kind == "StepLR":
        step_size = int(sched_cfg.StepLR.step_size)
        gamma = float(sched_cfg.StepLR.gamma)

        def schedule(step):
            return 1.0 if step_size <= 0 else gamma ** (step // step_size)

    elif kind == "WarmupMultiStepLR":
        wcfg = sched_cfg.WarmupMultiStepLR
        milestones = [int(m) for m in wcfg.milestones]
        gamma = float(wcfg.gamma)
        warmup_factor = float(wcfg.warmup_factor)
        warmup_steps = int(wcfg.warmup_steps)
        method = str(wcfg.warmup_method)
        if method not in ("constant", "linear"):
            raise ValueError(
                "Only 'constant' or 'linear' warmup_method accepted, got "
                "{!r}".format(method))

        def schedule(step):
            mult = gamma ** sum(step >= m for m in milestones)
            if warmup_steps > 0 and step < warmup_steps:
                if method == "constant":
                    mult *= warmup_factor
                else:
                    alpha = step / warmup_steps
                    mult *= warmup_factor * (1 - alpha) + alpha
            return mult

    elif kind in ("", None):

        def schedule(step):
            return 1.0

    else:
        raise ValueError("Unsupported scheduler: {}".format(kind))
    return schedule


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate is set from the
    schedule, at its own update count, before each update."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.count = 0

    def step(self) -> None:
        lr = self.lr_schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


class OptimizerSpec(NamedTuple):
    kind: str               # "Adam" or "SGD"
    lr_schedule: Callable[[int], float]  # absolute LR at an update count
    weight_decay: float
    betas: tuple            # Adam
    momentum: float         # SGD

    def optax_slots(self) -> dict:
        """Where the JAX package's checkpoints keep this optimizer's state:
        {slot: name or name prefix} in its flattened optax state, a
        NamedTuple walked as a tuple (so by index). ``optax.adam`` is
        (``ScaleByAdamState(count, mu, nu)``, the schedule's count), so
        ``count`` is ``0.0``, ``mu`` ``0.1.<param>``, ``nu``
        ``0.2.<param>`` and ``schedule_count`` ``1.0``; ``optax.sgd`` is
        (``TraceState(trace)``, the schedule's count): ``trace``
        ``0.0.<param>``, ``schedule_count`` ``1.0``. A weight decay puts
        ``add_decayed_weights`` (no state) first in a chain, so every name
        gains a ``1.`` prefix."""
        slots = ({"count": "0.0", "mu": "0.1", "nu": "0.2"}
                 if self.kind == "Adam" else {"trace": "0.0"})
        slots["schedule_count"] = "1.0"
        if self.weight_decay > 0:
            slots = {k: "1." + v for k, v in slots.items()}
        return slots

    def init(self, params: Sequence[torch.Tensor]) -> ScheduledOptimizer:
        lr0 = self.lr_schedule(0)
        if self.kind == "Adam":
            opt = torch.optim.Adam(params, lr=lr0, betas=self.betas,
                                   eps=1e-8, weight_decay=self.weight_decay)
        else:
            opt = torch.optim.SGD(params, lr=lr0, momentum=self.momentum,
                                  dampening=0.0,
                                  weight_decay=self.weight_decay)
        return ScheduledOptimizer(opt, self.lr_schedule)


def build_optimizer(optim_cfg, cfg) -> OptimizerSpec:
    """One net's optimizer from its ``OPTIMIZER.MODEL_{2D,3D}`` group, or the
    flat ``OPTIMIZER.TYPE``/``BASE_LR`` form when the group's TYPE is unset."""
    kind = optim_cfg.get("TYPE", "") or cfg.OPTIMIZER.get("TYPE", "")
    if kind not in ("Adam", "SGD"):
        raise ValueError("Unsupported optimizer type: {!r}".format(kind))
    base_lr = float(optim_cfg.get("BASE_LR",
                                  cfg.OPTIMIZER.get("BASE_LR", 1e-3)))
    lr_mult = build_lr_schedule(cfg)
    clip = float(cfg.SCHEDULER.CLIP_LR)

    def lr_schedule(step):
        lr = base_lr * lr_mult(step)
        return max(lr, clip) if clip > 0 else lr

    betas = tuple(float(b) for b in
                  optim_cfg.get("Adam", {}).get("betas", (0.9, 0.999)))
    momentum = float(optim_cfg.get("SGD", {}).get("momentum", 0.9))
    return OptimizerSpec(kind, lr_schedule,
                         float(optim_cfg.get("WEIGHT_DECAY", 0.0)), betas,
                         momentum)
