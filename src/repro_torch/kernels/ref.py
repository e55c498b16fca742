"""Plain PyTorch versions of the segment reduce (the correctness contract).

Twins of repro/kernels/ref.py:segment_sum_ref / segment_max_ref. Row
`num_segments` is the padding sink: ids equal to it land in a row that is
sliced off.
"""

from __future__ import annotations

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
