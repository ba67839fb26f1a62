"""Maximum-weight bipartite matching on the host, batched.

Counterpart of ``rec_attend_tpu/ops/native.py:37-65`` (the JAX package's
``matcher='native'`` path): the port's own copy of the C++ solver,
``csrc/hungarian.cc``, is built by ``ops/cuda/build.py`` and called through
``ctypes``.  On the same weights it returns the same matching as the JAX
package's native solver, ties included; JAX's default solver (the port's
``ops/hungarian.py``) may choose another optimal matching on ties.
"""

from __future__ import annotations

import numpy as np

from rec_attend_tpu_torch.ops.cuda import build


def hungarian_native(w):
  """Solve max-weight matching for each problem of a batch.

  Args:
    w: [B, N, M] (or [N, M]) non-negative float weights, a numpy array.
  Returns:
    (matching, cover_x, cover_y, capped): the 0/1 matching [B, N, M], the
    dual covers [B, N] and [B, M], and the number of problems that hit the
    solver's iteration cap (their matching is the partial one it reached).
  """
  lib = build.load_hungarian()
  squeeze = w.ndim == 2
  wb = np.ascontiguousarray(w[None] if squeeze else w, dtype=np.float32)
  b, n_x, n_y = wb.shape
  m = np.zeros((b, n_x, n_y), np.float32)
  cx = np.zeros((b, n_x), np.float32)
  cy = np.zeros((b, n_y), np.float32)
  capped = lib.hungarian_solve(wb.ctypes.data, b, n_x, n_y, m.ctypes.data,
                               cx.ctypes.data, cy.ctypes.data)
  if squeeze:
    return m[0], cx[0], cy[0], capped
  return m, cx, cy, capped
