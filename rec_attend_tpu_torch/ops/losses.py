"""Loss and metric primitives of the recurrent-attention model.

Counterpart of ``rec_attend_tpu/ops/losses.py:27-297`` (``f_iou_all`` and
``f_ce`` of the fg model included), with its numerical
contracts: ``f_union`` adds eps per pixel, so the pairwise union carries an
``eps * H * W`` term; Dice cardinalities add 1e-5 per pixel; the BCEs put
eps = 1e-5 inside the log; Huber is the symmetric form; the greedy match
splits exact ties evenly.

The cumulative min and max are computed as JAX differentiates them: its
``cummin``/``cummax`` take their gradient through ``lax.associative_scan``
with an elementwise min/max that splits the gradient of a tie evenly.
``torch.cummin`` routes all of it to one index instead, which differs where
scores tie (for example a score saturated at 1), so ``f_cum_min`` and
``f_cum_max`` run the same scan, ``torch.minimum``/``torch.maximum``
splitting ties as ``lax.min``/``lax.max`` do.
"""

from __future__ import annotations

import torch

EPS = 1e-5


# ---------------------------------------------------------------------------
# Cumulative min / max
# ---------------------------------------------------------------------------

def _interleave(even, odd):
  """Interleave along dim 1: even[0], odd[0], even[1], ... (even may hold
  one more element)."""
  k = odd.shape[1]
  pairs = torch.stack([even[:, :k], odd], dim=2).flatten(1, 2)
  return torch.cat([pairs, even[:, k:]], dim=1)


def _prefix_scan(s, combine):
  """Inclusive prefix scan along dim 1, the recursion of JAX's
  ``lax.associative_scan``."""
  n = s.shape[1]
  if n < 2:
    return s
  odd = _prefix_scan(combine(s[:, 0:-1:2], s[:, 1::2]), combine)
  if n % 2 == 0:
    even = combine(odd[:, :-1], s[:, 2::2])
  else:
    even = combine(odd, s[:, 2::2])
  even = torch.cat([s[:, :1], even], dim=1)
  return _interleave(even, odd)


def f_cum_min(s):
  """Prefix cumulative minimum along dim 1.  s: [B, D] -> [B, D]."""
  return _prefix_scan(s, torch.minimum)


def f_cum_max(s):
  """Suffix cumulative maximum along dim 1 (max of s[:, i:])."""
  return torch.flip(_prefix_scan(torch.flip(s, dims=(1,)), torch.maximum),
                    dims=(1,))


# ---------------------------------------------------------------------------
# Intersections / unions / IoU / Dice
# ---------------------------------------------------------------------------

def f_inter(a, b):
  """Sum of a*b over the last two dims."""
  return torch.sum(a * b, dim=(-2, -1))


def f_union(a, b, eps=EPS):
  """Sum of a+b-ab+eps over the last two dims (eps per pixel)."""
  return torch.sum(a + b - a * b + eps, dim=(-2, -1))


def f_iou(a, b, pairwise=False):
  """Soft IoU of a [B, N, H, W] and b [B, M, H, W]: [B, N, M] when
  pairwise, else aligned over the last two dims."""
  if not pairwise:
    return f_inter(a, b) / f_union(a, b)
  af = a.flatten(-2).float()
  bf = b.flatten(-2).float()
  npix = af.shape[-1]
  inter = torch.einsum('bnp,bmp->bnm', af, bf)
  sum_a = torch.sum(af, dim=-1)
  sum_b = torch.sum(bf, dim=-1)
  union = sum_a[:, :, None] + sum_b[:, None, :] - inter + EPS * npix
  return inter / union


def f_dice(a, b, pairwise=False):
  """Soft Dice; pairwise mode returns [B, N, M]."""
  if not pairwise:
    card_a = torch.sum(a + EPS, dim=(-2, -1))
    card_b = torch.sum(b + EPS, dim=(-2, -1))
    return 2 * f_inter(a, b) / (card_a + card_b)
  af = a.flatten(-2).float()
  bf = b.flatten(-2).float()
  npix = af.shape[-1]
  inter = torch.einsum('bnp,bmp->bnm', af, bf)
  card_a = torch.sum(af, dim=-1) + EPS * npix
  card_b = torch.sum(bf, dim=-1) + EPS * npix
  return 2 * inter / (card_a[:, :, None] + card_b[:, None, :])


def f_iou_all(a, b):
  """IoU over every element at once (the fg model's dataset-level IoU);
  eps once in the union."""
  inter = torch.sum(a * b)
  return inter / (torch.sum(a) + torch.sum(b) - inter + EPS)


# ---------------------------------------------------------------------------
# Box IoU
# ---------------------------------------------------------------------------

def f_iou_box(top_left_a, bot_right_a, top_left_b, bot_right_b):
  """Box IoU, broadcasting; (y, x) coordinates in the last dim."""
  y1a, x1a = top_left_a[..., 0], top_left_a[..., 1]
  y2a, x2a = bot_right_a[..., 0], bot_right_a[..., 1]
  y1b, x1b = top_left_b[..., 0], top_left_b[..., 1]
  y2b, x2b = bot_right_b[..., 0], bot_right_b[..., 1]
  x1m = torch.maximum(x1a, x1b)
  y1m = torch.maximum(y1a, y1b)
  x2m = torch.minimum(x2a, x2b)
  y2m = torch.minimum(y2a, y2b)
  overlap = (x1m < x2m).float() * (y1m < y2m).float()
  overlap_area = overlap * (x2m - x1m) * (y2m - y1m)
  area_a = (x2a - x1a) * (y2a - y1a)
  area_b = (x2b - x1b) * (y2b - y1b)
  union = area_a + area_b - overlap_area
  return overlap_area / union


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------

def f_coverage(iou):
  """Max IoU over predictions per GT instance; iou [B, N, M] -> [B, M]."""
  return torch.amax(iou, dim=1)


def f_coverage_weight(y_gt):
  """Per-instance area weight, zero for empty instances."""
  y_gt_sum = torch.sum(y_gt, dim=(2, 3))
  denom = (torch.sum(y_gt_sum, dim=1, keepdim=True)
           + (y_gt_sum == 0).float())
  return y_gt_sum / denom


def f_weighted_coverage(iou, y_gt):
  return torch.sum(f_coverage(iou) * f_coverage_weight(y_gt)) / y_gt.shape[0]


def f_unweighted_coverage(iou, count):
  return torch.sum(torch.sum(f_coverage(iou), dim=1) / count) / iou.shape[0]


# ---------------------------------------------------------------------------
# Cross-entropies
# ---------------------------------------------------------------------------

def f_ce(y_out, y_gt):
  """Cross-entropy of probabilities, per element (summed by the caller
  over the classes)."""
  return -y_gt * torch.log(y_out + EPS)


def f_bce(y_out, y_gt):
  return (-y_gt * torch.log(y_out + EPS)
          - (1 - y_gt) * torch.log(1 - y_out + EPS))


def f_bce_minmax(y_out_min, y_out_max, y_gt):
  """Monotonic-decreasing BCE: prefix-min against 1, suffix-max against 0."""
  return (-y_gt * torch.log(y_out_min + EPS)
          - (1 - y_gt) * torch.log(1 - y_out_max + EPS))


# ---------------------------------------------------------------------------
# Confidence loss and greedy matching
# ---------------------------------------------------------------------------

def f_conf_loss(s_out, match, use_cum_min=True):
  """Confidence sequence loss; s_out [B, T], match [B, T, T]."""
  num_ex, timespan = s_out.shape
  match_sum = torch.sum(match, dim=2)
  if use_cum_min:
    s_bce = f_bce_minmax(f_cum_min(s_out), f_cum_max(s_out), match_sum)
  else:
    s_bce = f_bce(s_out, match_sum)
  return torch.sum(s_bce) / num_ex / timespan


def f_greedy_match(score, matched):
  """One greedy step: the argmax of score [B, N] among the slots not yet
  matched ([B, N] mask), one-hot, split evenly on exact ties.  No gradient
  flows through it."""
  with torch.no_grad():
    score = score * (1.0 - matched)
    max_score = torch.amax(score, dim=1, keepdim=True)
    match = (score == max_score).float()
    return match / torch.sum(match, dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# Matched elementwise loss
# ---------------------------------------------------------------------------

def f_match_loss(y_out, y_gt, match, loss_fn):
  """Elementwise loss under a matching.

  y_out [B, N, ...], y_gt [B, M, ...], match [B, N, M]: the sum over matched
  pairs of each pair's summed loss, over the match count, the batch size
  and the per-item feature count."""
  num_ex = y_out.shape[0]
  num_dim = 1
  for d in y_out.shape[2:]:
    num_dim *= d
  match_count = torch.clamp_min(torch.sum(match, dim=(1, 2)), 1.0)
  red = tuple(range(3, y_out.dim() + 1))
  pair = loss_fn(y_out.unsqueeze(2), y_gt.unsqueeze(1))
  if red:
    pair = torch.sum(pair, dim=red)
  err_total = torch.sum(pair * match, dim=(1, 2))
  return torch.sum(err_total / match_count) / num_ex / num_dim


# ---------------------------------------------------------------------------
# Counting metrics
# ---------------------------------------------------------------------------

def f_count_acc(s_out, s_gt):
  count_out = torch.sum((s_out > 0.5).float(), dim=1)
  count_gt = torch.sum(s_gt, dim=1)
  return torch.sum((count_out == count_gt).float()) / s_out.shape[0]


def f_dic(s_out, s_gt, abs=False):
  count_out = torch.sum((s_out > 0.5).float(), dim=1)
  diff = count_out - torch.sum(s_gt, dim=1)
  if abs:
    diff = torch.abs(diff)
  return torch.sum(diff) / s_out.shape[0]


# ---------------------------------------------------------------------------
# Pointwise regression losses
# ---------------------------------------------------------------------------

def f_huber(y_out, y_gt, threshold=1.0):
  """Symmetric Huber loss."""
  err = y_out - y_gt
  ind = (torch.abs(err) <= threshold).float()
  squared = 0.5 * err * err
  l1 = torch.abs(err) - (threshold - 0.5 * threshold ** 2)
  return squared * ind + l1 * (1 - ind)


def f_squared_err(y_out, y_gt):
  err = y_out - y_gt
  return 0.5 * err * err
