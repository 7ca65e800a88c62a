"""Search-quality metrics (counterpart of ``repro.core.metrics``)."""
from __future__ import annotations

import torch


def recall_at_r(pred_ids: torch.Tensor, gt_ids: torch.Tensor,
                r: int | None = None) -> torch.Tensor:
    """Recall@R as in the paper's Fig. 2 / Table 1: the fraction of queries
    whose true first nearest neighbour appears in the top R predictions.

    pred_ids: (Q, R') ascending by distance; gt_ids: (Q,) or (Q, G).
    """
    gt = gt_ids[:, 0] if gt_ids.ndim == 2 else gt_ids
    if r is not None:
        pred_ids = pred_ids[:, :r]
    hits = torch.any(pred_ids == gt[:, None].to(pred_ids.dtype), dim=1)
    return torch.mean(hits.float())
