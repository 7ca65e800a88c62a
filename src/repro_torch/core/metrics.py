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


def intersection_recall(pred_ids: torch.Tensor, gt_ids: torch.Tensor
                        ) -> torch.Tensor:
    """|pred ∩ gt| / |gt| per query, averaged (the 'k-recall@k' variant):
    pred_ids (Q, R), gt_ids (Q, G). Averaged in f64 and returned as f32,
    so the count ratio is rounded once."""
    inter = torch.any(pred_ids[:, :, None] == gt_ids[:, None, :].to(
        pred_ids.dtype), dim=1)
    return torch.mean(torch.mean(inter.double(), dim=1)).float()


def distance_error_stats(approx: torch.Tensor, exact: torch.Tensor) -> dict:
    """Relative distance-estimation error of the quantized ADC pipeline:
    mean and 95th percentile (linear interpolation) of ``|approx - exact| /
    max(|exact|, 1e-12)``, and the largest absolute error."""
    err = torch.abs(approx - exact)
    rel = err / torch.clamp_min(torch.abs(exact), 1e-12)
    return {"mean_rel_err": float(torch.mean(rel)),
            "p95_rel_err": float(torch.quantile(rel.flatten(), 0.95)),
            "max_abs_err": float(torch.max(err))}
