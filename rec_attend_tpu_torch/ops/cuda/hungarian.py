"""The Hungarian kernel (``csrc/hungarian.cu``) on tensors on the card.

Counterpart of ``rec_attend_tpu/ops/hungarian.py:118-141`` (``hungarian``
with ``_hungarian_rect``), the solver that JAX runs in-graph under ``vmap``:
one block of one warp per problem, the same float32 operations in the same
order, so the same matching and covers, ties included.  The plain version
of the same algorithm is ``ops/hungarian.hungarian_plain``.

``hungarian`` takes float32, contiguous weights on a CUDA device and
raises on anything else, and on a refused launch: there is no fallback.
It counts its launches in ``hungarian.launches``, and by shape
('BxN_XxN_Y') in ``hungarian.shape_launches``.
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.ops.cuda import build


def max_n():
  """The largest max(n_x, n_y) the kernel takes (its cost matrix fills a
  block's shared memory)."""
  return build.load_hungarian_cuda().hungarian_max_n()


def hungarian(w):
  """Max-weight matching of each problem of w [B, n_x, n_y] on the card.

  Returns (matching [B, n_x, n_y] 0/1, c_x [B, n_x, 1], c_y [B, 1, n_y]),
  float32 on w's device, launched on its current stream."""
  if w.device.type != 'cuda':
    raise ValueError(f'hungarian: the kernel takes a CUDA tensor, got '
                     f'{w.device}')
  if w.dtype != torch.float32:
    raise TypeError(f'hungarian: the kernel takes float32, got {w.dtype}')
  if w.dim() != 3:
    raise ValueError(f'hungarian: want [B, n_x, n_y], got {tuple(w.shape)}')
  if not w.is_contiguous():
    raise ValueError('hungarian: the kernel takes a contiguous tensor')
  b, n_x, n_y = w.shape
  m = torch.empty((b, n_x, n_y), dtype=torch.float32, device=w.device)
  c_x = torch.empty((b, n_x, 1), dtype=torch.float32, device=w.device)
  c_y = torch.empty((b, 1, n_y), dtype=torch.float32, device=w.device)
  if b == 0 or max(n_x, n_y) == 0:
    return m, c_x, c_y
  if max(n_x, n_y) > max_n():
    raise ValueError(f'hungarian: {n_x}x{n_y} problems are larger than the '
                     f'kernel takes ({max_n()})')
  lib = build.load_hungarian_cuda()
  with torch.cuda.device(w.device):
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.hungarian_solve_cuda(w.data_ptr(), b, n_x, n_y, m.data_ptr(),
                                   c_x.data_ptr(), c_y.data_ptr(), stream)
  if err != 0:
    msg = lib.hungarian_error_string(err).decode()
    raise RuntimeError(f'hungarian launch failed: {msg} (cudaError {err}) '
                       f'at [{b}, {n_x}, {n_y}]')
  hungarian.launches += 1
  key = f'{b}x{n_x}x{n_y}'
  hungarian.shape_launches[key] = hungarian.shape_launches.get(key, 0) + 1
  return m, c_x, c_y


def reset_launch_counts():
  hungarian.launches = 0
  hungarian.shape_launches = {}


reset_launch_counts()
