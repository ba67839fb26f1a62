"""Segmentation-to-groundtruth matching.

Counterpart of ``rec_attend_tpu/ops/matching.py:21-55``: mask the pairwise
IoU by the groundtruth scores on both sides, round to 1e-6, add 1e-5 so
every edge has positive weight, solve max-weight matching, and mask the
matching again.  ``matcher`` takes JAX's values: 'jax' (the default, as in
JAX's losses) solves with JAX's algorithm on the tensor's device
(``ops/hungarian.py``: the kernel on the card, its plain version on the
CPU), with no copy to the host; 'native' solves with the host C++ solver
(``ops/native.py``), one copy of the weights from the device and one of
the matching back per call.
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.ops import hungarian as hungarian_lib
from rec_attend_tpu_torch.ops import native

MATCH_EPS = 1e-5
MATCH_PRECISION = 1e6


def solve(weights, matcher='jax'):
  """The 0/1 max-weight matching [B, N, M] of weights [B, N, M], float32
  on the weights' device, by ``matcher`` ('jax' or 'native')."""
  if matcher == 'jax':
    return hungarian_lib.hungarian(weights)[0]
  if matcher == 'native':
    m = native.hungarian_native(weights.cpu().numpy())[0]
    return torch.from_numpy(m).to(weights.device)
  raise ValueError(f"Unknown matcher: {matcher!r}, want 'jax' or 'native'")


def f_segm_match(iou, s_gt, matcher='jax'):
  """Match predictions to groundtruth by pairwise IoU.

  Args:
    iou: [B, N, M] pairwise scores (predictions x groundtruth).
    s_gt: [B, M] groundtruth presence indicators.
    matcher: 'jax' (JAX's algorithm, run on the tensor's device) or
      'native' (the host C++ solver).
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
    return solve(weights, matcher) * mask_x * mask_y


def get_identity_match(timespan, s_gt):
  """Fixed-order identity matching masked by the groundtruth scores."""
  eye = torch.eye(timespan, dtype=torch.float32, device=s_gt.device)[None]
  return eye * s_gt[:, None, :] * s_gt[:, :, None]
