"""Maximum-weight bipartite matching, batched: JAX's default matcher.

Counterpart of ``rec_attend_tpu/ops/hungarian.py``, the shortest-augmenting-
path solver that JAX runs in-graph under ``vmap`` (``matcher='jax'``, the
default of its losses).  ``hungarian`` solves a CUDA tensor with the
hand-written kernel (``ops/cuda/hungarian.py``, ``csrc/hungarian.cu``) and
a CPU tensor with ``hungarian_plain``, the same algorithm in PyTorch
operations; both give JAX's bits, ties included.  The host C++ solver of
JAX's ``matcher='native'`` is ``ops/native.py``.

The algorithm (JAX ``:38-115``): w [n_x, n_y] is zero-padded to n x n and
the minimum-cost assignment of cost = -w is solved row by row with a
sentinel row and column 0; each row runs a Dijkstra phase of at most n + 2
iterations and an augmentation of at most n + 2 steps (JAX's caps, reached
only on degenerate input, and silently).  Every addition and subtraction
is a single float32 operation in JAX's order; the argmin takes the first
index of the smallest value and counts NaN below every number, as
``jnp.argmin`` does.  The plain version runs the batch as ``vmap`` runs a
``while_loop``: each iteration for every problem, kept only where that
problem's loop is still running.
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.ops.cuda import hungarian as kernel

_INF = 1e30


def _argmin(mm):
  """jnp.argmin over the last axis of [B, N]: the first NaN where there is
  one, else the first index of the smallest value (-0 == +0)."""
  idx = torch.arange(mm.shape[1], device=mm.device).expand_as(mm)
  far = torch.full_like(idx, mm.shape[1])
  nan = torch.isnan(mm)
  first_nan = torch.where(nan, idx, far).min(1).values
  smallest = torch.where(nan, torch.full_like(mm, float('inf')), mm).min(
      1, keepdim=True).values
  first_min = torch.where(mm == smallest, idx, far).min(1).values
  return torch.where(nan.any(1), first_nan, first_min)


def _solve_plain(w):
  """w [B, n_x, n_y] float32 -> (matching, c_x [B, n_x], c_y [B, n_y],
  the Dijkstra iterations of each problem's rows [B, n])."""
  b, n_x, n_y = w.shape
  n = max(n_x, n_y)
  n1, dev = n + 1, w.device
  wp = torch.zeros((b, n, n), dtype=torch.float32, device=dev)
  wp[:, :n_x, :n_y] = w
  cost = torch.zeros((b, n1, n1), dtype=torch.float32, device=dev)
  cost[:, 1:, 1:] = -wp
  u = torch.zeros((b, n1), dtype=torch.float32, device=dev)
  v = torch.zeros_like(u)
  p = torch.zeros((b, n1), dtype=torch.long, device=dev)
  rows = torch.arange(b, device=dev)
  inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
  zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
  steps = []
  max_iter = n + 2
  for i in range(1, n + 1):
    p[:, 0] = i
    minv = torch.full((b, n1), _INF, dtype=torch.float32, device=dev)
    used = torch.zeros((b, n1), dtype=torch.bool, device=dev)
    way = torch.zeros((b, n1), dtype=torch.long, device=dev)
    j0 = torch.zeros(b, dtype=torch.long, device=dev)
    it = torch.zeros(b, dtype=torch.long, device=dev)
    while True:
      run = (p[rows, j0] != 0) & (it < max_iter)
      if not bool(run.any()):
        break
      used_n = used.clone()
      used_n[rows, j0] = True
      i0 = p[rows, j0]
      cur = cost[rows, i0] - u[rows, i0][:, None] - v
      upd = (cur < minv) & ~used_n
      minv_n = torch.where(upd, cur, minv)
      way_n = torch.where(upd, j0[:, None], way)
      mm = torch.where(used_n, inf, minv_n)
      mm[:, 0] = _INF
      j1 = _argmin(mm)
      delta = mm[rows, j1][:, None]
      # u.at[p].add(where(used, delta, 0)): one addition per column.
      u_n = u.scatter_add(1, p, torch.where(used_n, delta, zero))
      v_n = v - torch.where(used_n, delta, zero)
      minv_n = torch.where(used_n, minv_n, minv_n - delta)
      keep = run[:, None]
      u = torch.where(keep, u_n, u)
      v = torch.where(keep, v_n, v)
      minv = torch.where(keep, minv_n, minv)
      used = torch.where(keep, used_n, used)
      way = torch.where(keep, way_n, way)
      j0 = torch.where(run, j1, j0)
      it = it + run
    steps.append(it)
    it = torch.zeros_like(it)
    while True:
      run = (j0 != 0) & (it < max_iter)
      if not bool(run.any()):
        break
      j1 = way[rows, j0]
      p_n = p.clone()
      p_n[rows, j0] = p[rows, j1]
      p = torch.where(run[:, None], p_n, p)
      j0 = torch.where(run, j1, j0)
      it = it + run
  col_to_row = p[:, 1:] - 1
  matching = (col_to_row[:, None, :] == torch.arange(n, device=dev)[
      None, :, None]).to(torch.float32)
  steps = (torch.stack(steps, 1) if steps
           else torch.zeros((b, 0), dtype=torch.long, device=dev))
  return (matching[:, :n_x, :n_y], -u[:, 1:n_x + 1], -v[:, 1:n_y + 1],
          steps)


def _shaped(w, solve):
  """JAX ``hungarian``'s shapes around solve(w [B, n_x, n_y])."""
  if w.dim() == 2:
    m, cx, cy = solve(w[None])
    return m[0], cx[0], cy[0]
  return solve(w)


def hungarian_plain(w):
  """The solver in PyTorch operations, on w's device.

  Args:
    w: [n_x, n_y] or [B, n_x, n_y] weights, cast to float32 as JAX casts
      them.
  Returns:
    (matching, c_x, c_y) in JAX ``hungarian``'s shapes: matching like w,
    c_x [..., n_x, 1], c_y [..., 1, n_y], float32.
  """
  def solve(wb):
    m, cx, cy, _ = _solve_plain(wb.to(torch.float32))
    return m, cx[..., None], cy[:, None, :]
  return _shaped(w, solve)


def dijkstra_steps(w):
  """The Dijkstra iterations of each row of each problem of w [B, n_x,
  n_y], [B, max(n_x, n_y)]: the serial steps of its solve.  A row that
  reaches JAX's cap takes max(n_x, n_y) + 2."""
  return _solve_plain(w.to(torch.float32))[3]


def hungarian(w):
  """Max-weight bipartite matching, single or batched (JAX ``hungarian``).

  Args:
    w: [n_x, n_y] or [B, n_x, n_y] non-negative weights, cast to float32.
  Returns:
    (matching, c_x, c_y): matching like w, c_x [..., n_x, 1], c_y
    [..., 1, n_y], float32 on w's device.  A CUDA tensor is solved by the
    kernel, a CPU tensor by ``hungarian_plain``.
  """
  if w.device.type == 'cpu':
    return hungarian_plain(w)
  if w.device.type != 'cuda':
    raise ValueError(f'hungarian: no solver for device {w.device}')
  return _shaped(w, lambda wb: kernel.hungarian(
      wb.to(torch.float32).contiguous()))


def matching_weight(w, matching):
  """Total weight of a matching (for optimality checks)."""
  return torch.sum(w * matching, dim=(-2, -1))
