"""Segmentation and UDA losses (PyTorch port of
``mopa_tpu/models/losses.py``): masked CE, cross-modal KL, MinEnt and the SAM
mask-consistency loss."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor,
                  class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Masked CE with ``F.cross_entropy`` semantics: the mean weighted by the
    per-class weights of the valid points.

    logits (N, C); labels (N,) integer (may be out of range where invalid);
    valid (N,) bool.
    """
    num_classes = logits.shape[-1]
    safe = labels.long().clamp(0, num_classes - 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    w = class_weights.float()[safe] if class_weights is not None \
        else torch.ones_like(nll)
    w = w * valid.float()
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def xm_kl_div(logits_student: torch.Tensor, logits_teacher: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """KL(teacher || student) summed over classes, averaged over the valid
    points: ``F.kl_div(log_softmax(s), softmax(t), 'none').sum(1)`` masked.
    The caller detaches the teacher where the reference does."""
    logp_s = F.log_softmax(logits_student.float(), dim=-1)
    p_t = F.softmax(logits_teacher.float(), dim=-1)
    kl = (p_t * (torch.log(p_t.clamp(min=1e-30)) - logp_s)).sum(dim=-1)
    m = valid.float()
    return (kl * m).sum() / m.sum().clamp(min=1.0)


def prob_2_entropy(prob: torch.Tensor) -> torch.Tensor:
    """Weighted self-information map: -p * log2(p) / log2(C)."""
    c = prob.shape[-1]
    return -prob * torch.log2(prob + 1e-30) / math.log2(c)


def entropy_loss(prob: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """MinEnt loss: the normalised entropy averaged over the valid points."""
    c = prob.shape[-1]
    ent = -(prob * torch.log2(prob + 1e-30)).sum(dim=-1) / math.log2(c)
    m = valid.float()
    return (ent * m).sum() / m.sum().clamp(min=1.0)


def mask_cons_loss(all_probs: torch.Tensor, sam_masks: torch.Tensor,
                   mask_budget: int, min_entropy: bool = True) -> torch.Tensor:
    """SAM intra-mask consistency plus mask-mean entropy.

    all_probs (B, H, W, C) softmaxed dense 2D predictions; sam_masks (B, H, W)
    integer mask ids, negative = ignore, ids < ``mask_budget`` (M) count.
    Per mask: the mean over (pixels, classes) of (p - mask mean)^2, plus the
    normalised entropy of the mask mean when ``min_entropy``; per image: the
    mean over non-empty masks; batch: the mean over images (an image with no
    mask contributes 0). Segment sums are one-hot GEMMs, as in the
    reference."""
    b, h, w, c = all_probs.shape
    m = int(mask_budget)
    p = all_probs.reshape(b, h * w, c).float()
    ids = sam_masks.reshape(b, h * w).long()
    sid = torch.where((ids >= 0) & (ids < m), ids, torch.full_like(ids, m))
    onehot = F.one_hot(sid, m + 1).float()                    # (B, HW, M+1)
    npix = onehot.sum(dim=1)[:, :m]                            # (B, M)
    s1 = (onehot.transpose(1, 2) @ p)[:, :m]                   # (B, M, C)
    s2 = (onehot.transpose(1, 2) @ (p * p))[:, :m]
    n = npix.clamp(min=1.0)[..., None]
    mean = s1 / n
    sse = s2 - n * mean.square()
    loss = sse.sum(dim=-1) / (npix * c).clamp(min=1.0)
    if min_entropy:
        loss = loss - (mean * torch.log2(mean + 1e-30)).sum(dim=-1) \
            / math.log2(c)
    nonempty = npix > 0
    per_image = torch.where(nonempty, loss, torch.zeros_like(loss)).sum(
        dim=-1) / nonempty.float().sum(dim=-1).clamp(min=1.0)
    return per_image.mean()
