"""Multi-head attention blocks (port of ``mopa_tpu/models/attention.py``),
kept for inventory parity: the reference ships them and nothing calls them
(``models/sam.py`` has its own windowed and decoder attention).

Parameter names are the flax ones (``w_qs``, ``w_ks``, ``w_vs``, ``fc`` and
the unnamed flax norm's ``LayerNorm_0``), so ``models.weights`` carries a
flax block's variables over. Dropout acts in training mode only and draws
its masks from the caller's generator.
"""

from __future__ import annotations

import torch
from torch import nn

from .resnet34_unet import dropout
from .sam import LayerNorm


class ScaledDotProductAttention(nn.Module):
    def __init__(self, temperature: float, dropout: float = 0.1):
        super().__init__()
        self.temperature = temperature
        self.dropout = dropout

    def forward(self, q, k, v, mask=None,
                generator: torch.Generator | None = None) -> tuple:
        attn = (q @ k.transpose(-1, -2)) / self.temperature
        if mask is not None:
            attn = torch.where(mask, attn, torch.full_like(attn, -1e9))
        attn = torch.softmax(attn, dim=-1)
        if self.training:
            attn = dropout(attn, self.dropout, generator)
        return attn @ v, attn


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.attention = ScaledDotProductAttention(d_k ** 0.5, dropout)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.LayerNorm_0 = LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v, mask=None,
                generator: torch.Generator | None = None) -> tuple:
        """q (B, Lq, d_model), k and v (B, Lk, d_model); ``mask`` broadcasts
        onto (B, n_head, Lq, Lk), False masked out. Returns the normed
        output (B, Lq, d_model) and the attention (B, n_head, Lq, Lk)."""
        residual = q
        b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
        qh = self.w_qs(q).reshape(b, lq, self.n_head, self.d_k)
        kh = self.w_ks(k).reshape(b, lk, self.n_head, self.d_k)
        vh = self.w_vs(v).reshape(b, lk, self.n_head, self.d_v)
        out, attn = self.attention(qh.transpose(1, 2), kh.transpose(1, 2),
                                   vh.transpose(1, 2), mask=mask,
                                   generator=generator)
        out = self.fc(out.transpose(1, 2).reshape(b, lq, -1))
        if self.training:
            out = dropout(out, self.dropout, generator)
        return self.LayerNorm_0(out + residual), attn
