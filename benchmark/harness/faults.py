"""Faults planted in the program's timed path, for the check's tests and
for the readings that set the limits (``calibrate.py --fault``): each
must make a run come out not correct."""

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def state_unchanged():
    """The optimizers' steps do nothing: the step returns its state
    unchanged."""
    from mopa_tpu_torch.common import solver

    with mock.patch.object(solver.ScheduledOptimizer, "step",
                           lambda self: None):
        yield


@contextlib.contextmanager
def half_the_batch():
    """Every loss over the valid points takes the mean over the first half
    of the batch's points only."""
    from mopa_tpu_torch.models import losses

    def halve(fn):
        def inner(*args, **kw):
            args = list(args)
            valid = args[2].clone()
            valid[valid.shape[0] // 2:] = False
            args[2] = valid
            return fn(*args, **kw)
        return inner

    with mock.patch.object(losses, "cross_entropy",
                           halve(losses.cross_entropy)), \
            mock.patch.object(losses, "xm_kl_div", halve(losses.xm_kl_div)):
        yield


@contextlib.contextmanager
def answer_altered():
    """The 3D net's logits come out with the first class raised by one
    where they are produced."""
    from mopa_tpu_torch.models import xmuda_arch

    real = xmuda_arch.Net3DSeg.forward

    def forward(self, *args, **kw):
        out = real(self, *args, **kw)
        bump = torch.zeros_like(out["seg_logit"])
        bump[:, 0] = 1.0
        out["seg_logit"] = out["seg_logit"] + bump
        return out

    with mock.patch.object(xmuda_arch.Net3DSeg, "forward", forward):
        yield


@contextlib.contextmanager
def unbroken():
    yield


TRAIN = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
         "answer_altered": answer_altered}
