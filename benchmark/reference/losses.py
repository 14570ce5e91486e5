"""The losses of the xMUDA / MoPA recipe, in plain PyTorch (float32)."""

from __future__ import annotations

import math

import torch


def cross_entropy(logits, labels, valid, class_weights=None):
    """``F.cross_entropy`` with per-class weights over the ``valid`` points:
    the sum of weighted negative log-likelihoods over the sum of weights."""
    c = logits.shape[-1]
    lab = labels.long().clamp(0, c - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, lab[:, None])[:, 0]
    w = valid.float()
    if class_weights is not None:
        w = w * class_weights[lab]
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def xm_kl(student, teacher, valid):
    """KL(softmax(teacher) || softmax(student)) summed over classes, the
    mean over the valid points (``F.kl_div(..., 'none').sum(1)``)."""
    logp = torch.log_softmax(student.float(), dim=-1)
    p = torch.softmax(teacher.float(), dim=-1)
    kl = (p * (torch.log(p.clamp(min=1e-30)) - logp)).sum(-1)
    m = valid.float()
    return (kl * m).sum() / m.sum().clamp(min=1.0)


def mask_consistency(probs, masks, budget: int):
    """MoPA's SAM loss. ``probs`` (B, H, W, C) dense softmax, ``masks`` (B,
    H, W) ids, those outside [0, budget) ignored. Per mask: the mean over
    its pixels and the classes of the squared deviation from the mask's
    mean probability, plus the normalised entropy of that mean; per image
    the mean over its non-empty masks; the mean over the images."""
    b, h, w, c = probs.shape
    p = probs.reshape(b, h * w, c).float()
    ids = masks.reshape(b, h * w).long()
    keep = (ids >= 0) & (ids < budget)
    seg = torch.where(keep, ids, torch.full_like(ids, budget)) \
        + torch.arange(b, device=ids.device)[:, None] * (budget + 1)
    seg = seg.reshape(-1)
    n_seg = b * (budget + 1)
    flat = p.reshape(-1, c)
    npix = torch.zeros(n_seg, device=p.device).index_add(
        0, seg, torch.ones_like(seg, dtype=torch.float32))
    mean = torch.zeros((n_seg, c), device=p.device).index_add(0, seg, flat) \
        / npix.clamp(min=1.0)[:, None]
    dev = (flat - mean[seg]).square().sum(-1)
    sse = torch.zeros(n_seg, device=p.device).index_add(0, seg, dev)
    loss = sse / (npix * c).clamp(min=1.0)
    loss = loss - (mean * torch.log2(mean + 1e-30)).sum(-1) / math.log2(c)
    loss = loss.reshape(b, budget + 1)[:, :budget]
    nonempty = npix.reshape(b, budget + 1)[:, :budget] > 0
    per_image = torch.where(nonempty, loss, torch.zeros_like(loss)).sum(-1) \
        / nonempty.float().sum(-1).clamp(min=1.0)
    return per_image.mean()
