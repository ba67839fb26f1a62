"""The hand-written glimpse kernels (``csrc/glimpse.cu``) as differentiable
operations.

Counterpart of ``rec_attend_tpu/ops/pallas/glimpse.py``: ``glimpse_extract``
and ``glimpse_paste`` are its ``extract_patch`` and ``paste_patch``, two
``torch.autograd.Function``s whose passes reuse the two kernels as the JAX
custom VJPs do (``_extract_bwd``, ``_paste_bwd``):

  extract  forward  extract kernel
           backward d_x = paste kernel (g);  d_f_y, d_f_x: einsums
  paste    forward  paste kernel
           backward d_p = extract kernel (g);  d_f_y, d_f_x: einsums

The filter gradients are thin contractions that JAX also leaves outside
its kernels, so they stay ``torch.einsum``.  A backward computes only the
gradients ``ctx.needs_input_grad`` asks for.

The extract kernel has three routes, picked on the host from the shape and
the pointers' alignment alone (``extract_route``): ``extract_tiled_kernel``
at the flagship's shapes (224x224 image, 48x48 glimpse, D = 1 or 4);
``extract_strip_kernel`` at the other 48x48 glimpses with D <= 32 and W*D a
multiple of 4 (any H and W: the KITTI and Cityscapes shapes, paste's d_p
off 224x224), both with all pointers 16-byte aligned; and
``extract_kernel_general`` at every other shape.  The tiled and strip
kernels return the patch in the plain version's memory layout ([B,FH,D,FW],
viewed as [B,FH,FW,D]), the general one contiguous.

A CUDA tensor goes to the kernel, or the call raises: there is no fallback
to the einsum forms on the card.  A CPU tensor goes to the plain two-einsum
version of ``ops/attention.py``, in the forward and in the backward, so the
Functions' own backward formulas run on the CPU too.  A bfloat16 or float16
operand is refused on either device: the bfloat16 model keeps its glimpses
in float32, as JAX's does.  Each wrapper counts
the launches of its kernel, backward launches included, in its
``launches`` attribute, and the backward ones also in
``backward_launches``; ``glimpse_extract.route_launches`` splits its
launches by route.
"""

from __future__ import annotations

import ctypes

import torch

from rec_attend_tpu_torch.ops import attention
from rec_attend_tpu_torch.ops.cuda import build

extract_patch_plain = attention.extract_patch
paste_patch_plain = attention.paste_patch


def _check(name, a, f_y, f_x):
  """Validate a [B, *, *, D] operand and its filter banks; returns
  (B, H, W, FH, FW) where H/W are the filter banks' image extents."""
  if a.dim() != 4 or f_y.dim() != 3 or f_x.dim() != 3:
    raise ValueError(f'{name}: want a 4-D operand and 3-D filter banks, got '
                     f'{tuple(a.shape)}, {tuple(f_y.shape)}, '
                     f'{tuple(f_x.shape)}')
  b, h, fh = f_y.shape
  _, w, fw = f_x.shape
  if f_y.shape[0] != a.shape[0] or f_x.shape[0] != a.shape[0]:
    raise ValueError(f'{name}: batch sizes differ: {tuple(a.shape)}, '
                     f'{tuple(f_y.shape)}, {tuple(f_x.shape)}')
  low = [t.dtype for t in (a, f_y, f_x)
         if t.dtype in (torch.bfloat16, torch.float16)]
  if low:
    # JAX's bfloat16 model keeps its glimpses in float32; a cast here would
    # hide a cast missed before it.
    raise TypeError(f'{name}: the glimpse takes float32 operands, got '
                    f'{low[0]}')
  devices = {t.device for t in (a, f_y, f_x)}
  if len(devices) != 1:
    raise ValueError(f'{name}: operands on several devices: {devices}')
  if a.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'{name}: no kernel for device {a.device}')
  return b, h, w, fh, fw


# The extract kernels by the route number glimpse_extract_route returns.
EXTRACT_KERNELS = ('extract_kernel_general', 'extract_tiled_kernel',
                   'extract_strip_kernel')


def extract_route(b, h, w, d, fh, fw, aligned=True):
  """The extract kernel that ``glimpse_extract`` launches at these dims:
  {'kernel': 'extract_tiled_kernel' or 'extract_strip_kernel', 'ft': output
  rows a block} or {'kernel': 'extract_kernel_general'}.  ``aligned``: all
  four pointers 16-byte aligned.  Raises ValueError where no kernel takes
  them."""
  ft = ctypes.c_int(0)
  route = build.load().glimpse_extract_route(b, h, w, d, fh, fw,
                                             int(aligned), ctypes.byref(ft))
  if route < 0:
    raise ValueError(f'glimpse_extract: no kernel takes dims '
                     f'{(b, h, w, d, fh, fw)}')
  if route == 0:
    return {'kernel': EXTRACT_KERNELS[0]}
  return {'kernel': EXTRACT_KERNELS[route], 'ft': ft.value}


def extract_route_of(x, f_y, f_x):
  """``extract_route`` of the operands x (or a gradient) [B,H,W,D], f_y
  [B,H,FH], f_x [B,W,FW] on the card, with their alignment."""
  b, h, w, d = x.shape
  return extract_route(b, h, w, d, f_y.shape[2], f_x.shape[2], aligned=all(
      t.data_ptr() % 16 == 0 for t in (x, f_y, f_x)))


def _launch(name, a, f_y, f_x, out, dims):
  """Launch kernel ``name`` on the current stream of the operands' card."""
  for t in (a, f_y, f_x):
    if t.dtype != torch.float32:
      raise TypeError(f'{name}: the kernel takes float32, got {t.dtype}')
    if not t.is_contiguous():
      raise ValueError(f'{name}: the kernel takes contiguous tensors')
  lib = build.load()
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib, name)(a.data_ptr(), f_y.data_ptr(), f_x.data_ptr(),
                             out.data_ptr(), *dims, stream)
  if err != 0:
    msg = lib.glimpse_error_string(err).decode()
    raise RuntimeError(f'{name} launch failed: {msg} (cudaError {err}) '
                       f'at dims {dims}')


def _extract(x, f_y, f_x, backward=False):
  """x [B,H,W,D], f_y [B,H,FH], f_x [B,W,FW] -> [B,FH,FW,D], no autograd;
  ``backward`` marks a launch for a gradient."""
  b, h, w, fh, fw = _check('glimpse_extract', x, f_y, f_x)
  if x.shape[1:3] != (h, w):
    raise ValueError(f'glimpse_extract: x is {tuple(x.shape)} but the '
                     f'filters span {h}x{w}')
  if x.device.type == 'cpu':
    return extract_patch_plain(x, f_y, f_x)
  d = x.shape[3]
  kernel = extract_route_of(x, f_y, f_x)['kernel']
  if kernel == 'extract_kernel_general':
    out = torch.empty((b, fh, fw, d), dtype=torch.float32, device=x.device)
  else:
    # The tiled and strip kernels write the patch as [B,FH,D,FW] in memory,
    # the layout of the plain version's result, so that the layers after it
    # run the same algorithms on either path.
    out = torch.empty((b, fh, d, fw), dtype=torch.float32,
                      device=x.device).transpose(2, 3)
  _launch('glimpse_extract', x, f_y, f_x, out, (b, h, w, d, fh, fw))
  glimpse_extract.launches += 1
  glimpse_extract.backward_launches += backward
  glimpse_extract.route_launches[kernel] += 1
  return out


def _paste(p, f_y, f_x, backward=False):
  """p [B,FH,FW,D], f_y [B,H,FH], f_x [B,W,FW] -> [B,H,W,D], no autograd;
  ``backward`` marks a launch for a gradient."""
  b, h, w, fh, fw = _check('glimpse_paste', p, f_y, f_x)
  if p.shape[1:3] != (fh, fw):
    raise ValueError(f'glimpse_paste: patch is {tuple(p.shape)} but the '
                     f'filters have {fh}x{fw} taps')
  if p.device.type == 'cpu':
    return paste_patch_plain(p, f_y, f_x)
  d = p.shape[3]
  out = torch.empty((b, h, w, d), dtype=torch.float32, device=p.device)
  _launch('glimpse_paste', p, f_y, f_x, out, (b, h, w, d, fh, fw))
  glimpse_paste.launches += 1
  glimpse_paste.backward_launches += backward
  return out


class ExtractPatch(torch.autograd.Function):
  """patch[b,f,g,d] = sum_hw f_y[b,h,f] x[b,h,w,d] f_x[b,w,g]."""

  @staticmethod
  def forward(ctx, x, f_y, f_x):
    ctx.save_for_backward(x, f_y, f_x)
    return _extract(x, f_y, f_x)

  @staticmethod
  def backward(ctx, g):
    x, f_y, f_x = ctx.saved_tensors
    g = g.contiguous()
    need_x, need_fy, need_fx = ctx.needs_input_grad
    d_x = _paste(g, f_y, f_x, backward=True) if need_x else None
    d_f_y = d_f_x = None
    if need_fy:   # sum_{g,d} g[b,f,g,d] (x f_x)[b,h,g,d]
      xg = torch.einsum('bhwd,bwg->bhgd', x, f_x)
      d_f_y = torch.einsum('bfgd,bhgd->bhf', g, xg)
    if need_fx:   # sum_{f,d} g[b,f,g,d] (f_y x)[b,f,w,d]
      fyx = torch.einsum('bhf,bhwd->bfwd', f_y, x)
      d_f_x = torch.einsum('bfgd,bfwd->bwg', g, fyx)
    return d_x, d_f_y, d_f_x


class PastePatch(torch.autograd.Function):
  """out[b,h,w,d] = sum_fg f_y[b,h,f] p[b,f,g,d] f_x[b,w,g]."""

  @staticmethod
  def forward(ctx, p, f_y, f_x):
    ctx.save_for_backward(p, f_y, f_x)
    return _paste(p, f_y, f_x)

  @staticmethod
  def backward(ctx, g):
    p, f_y, f_x = ctx.saved_tensors
    g = g.contiguous()
    need_p, need_fy, need_fx = ctx.needs_input_grad
    d_p = _extract(g, f_y, f_x, backward=True) if need_p else None
    d_f_y = d_f_x = None
    if need_fy:   # sum_{w,d} g[b,h,w,d] (p f_x^T)[b,f,w,d]
      pfx = torch.einsum('bfgd,bwg->bfwd', p, f_x)
      d_f_y = torch.einsum('bhwd,bfwd->bhf', g, pfx)
    if need_fx:   # sum_{h,d} g[b,h,w,d] (f_y p)[b,h,g,d]
      fyp = torch.einsum('bhf,bfgd->bhgd', f_y, p)
      d_f_x = torch.einsum('bhwd,bhgd->bwg', g, fyp)
    return d_p, d_f_y, d_f_x


def glimpse_extract(x, f_y, f_x):
  """Glimpse crop: x [B,H,W,D], f_y [B,H,FH], f_x [B,W,FW] -> [B,FH,FW,D]."""
  return ExtractPatch.apply(x, f_y, f_x)


def glimpse_paste(p, f_y, f_x):
  """Mask paste: p [B,FH,FW,D], f_y [B,H,FH], f_x [B,W,FW] -> [B,H,W,D]."""
  return PastePatch.apply(p, f_y, f_x)


WRAPPERS = (glimpse_extract, glimpse_paste)


def reset_launch_counts():
  for fn in WRAPPERS:
    fn.launches = 0
    fn.backward_launches = 0
  glimpse_extract.route_launches = dict.fromkeys(EXTRACT_KERNELS, 0)


def launch_counts(backward=False):
  """{wrapper name: kernel launches} since the last reset; with
  ``backward``, the launches for gradients only."""
  key = 'backward_launches' if backward else 'launches'
  return {fn.__name__: getattr(fn, key) for fn in WRAPPERS}


reset_launch_counts()
