"""Segmentation-to-groundtruth matching.

Counterpart of ``rec_attend_tpu/ops/matching.py:21-55``: mask the pairwise
IoU by the groundtruth scores on both sides, round to 1e-6, add 1e-5 so
every edge has positive weight, solve max-weight matching, and mask the
matching again.  The solve runs on the host (``ops/hungarian.py``): one copy
of the weights from the device and one of the matching back per call.
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.ops import hungarian as hungarian_lib

MATCH_EPS = 1e-5
MATCH_PRECISION = 1e6


def f_segm_match(iou, s_gt):
  """Match predictions to groundtruth by pairwise IoU.

  Args:
    iou: [B, N, M] pairwise scores (predictions x groundtruth).
    s_gt: [B, M] groundtruth presence indicators.
  Returns:
    match: [B, N, M] 0/1 float matching on iou's device, zero outside the
    present groundtruth rows and columns; no gradient flows through it.
  """
  with torch.no_grad():
    mask_x = s_gt[:, None, :]
    mask_y = s_gt[:, :, None]
    iou_mask = iou * mask_x * mask_y
    iou_mask = torch.round(iou_mask * MATCH_PRECISION) / MATCH_PRECISION
    weights = iou_mask + MATCH_EPS
    m, _, _, _ = hungarian_lib.hungarian(weights.cpu().numpy())
    match = torch.from_numpy(m).to(iou.device, non_blocking=False)
    return match * mask_x * mask_y


def get_identity_match(timespan, s_gt):
  """Fixed-order identity matching masked by the groundtruth scores."""
  eye = torch.eye(timespan, dtype=torch.float32, device=s_gt.device)[None]
  return eye * s_gt[:, None, :] * s_gt[:, :, None]
