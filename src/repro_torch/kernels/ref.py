"""Plain PyTorch versions of every kernel's function (the correctness
contract).

Twins of repro/kernels/ref.py. segment_sum_ref / segment_max_ref: row
`num_segments` is the padding sink, ids equal to it land in a row that is
sliced off. flash_attention_ref / decode_attention_ref: the attention
oracles, on unfolded [B, H, ...] tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_sum_ref(messages: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Sum messages[e] into rows seg_ids[e]. messages [E, F], seg_ids [E]
    (may contain num_segments = padding sink). Returns [num_segments, F]."""
    out = messages.new_zeros((num_segments + 1, messages.shape[1]))
    out.index_add_(0, seg_ids.long(), messages)
    return out[:num_segments]


def segment_max_ref(messages: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Per-row max of messages[e] over rows seg_ids[e], identity -inf: rows
    no edge reaches come back as -inf. Same sink contract as the sum."""
    out = messages.new_full((num_segments + 1, messages.shape[1]),
                            float("-inf"))
    idx = seg_ids.long()[:, None].expand(-1, messages.shape[1])
    out.scatter_reduce_(0, idx, messages, reduce="amax", include_self=True)
    return out[:num_segments]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Reference attention. q [B, H, Sq, D]; k, v [B, H, Skv, D]. Softmax in
    fp32, the probabilities cast to q's dtype, then the PV product; the
    causal mask keeps k_idx <= q_idx + (Skv - Sq)."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len) -> torch.Tensor:
    """Single-token decode attention. q [B, H, D]; k, v [B, H, S, D];
    valid_len an int or a 0-d tensor: cache slots >= valid_len are masked
    to -1e30 (so valid_len <= 0 gives the mean of v over all slots)."""
    d = q.shape[-1]
    scores = torch.einsum("bhd,bhkd->bhk", q, k).float() / np.sqrt(d)
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.to(q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] < valid_len
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhkd->bhd", p, v)
