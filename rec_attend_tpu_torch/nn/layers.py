"""Layer library of the recurrent-attention model.

Counterpart of ``rec_attend_tpu/nn/layers.py:36-402``.  Parameters keep the
JAX package's names and layouts (conv ``w`` [F,F,in,out], transposed-conv
``w`` [F,F,out,in], dense ``w`` [in,out], BatchNorm copies [T,C]), so a JAX
parameter tree maps onto these modules name for name.  Activations are
computed NCHW (usually as channels-last views of the model's NHWC tensors);
the TF/JAX SAME padding rules are written out where PyTorch's differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_DECAY = 0.9

# Parameter names that carry L2 weight decay: conv/dense weights and the
# LSTM matrices, never biases or BatchNorm parameters.
WD_PARAM_NAMES = ('w', 'w_xi', 'w_hi', 'w_xf', 'w_hf', 'w_xu', 'w_hu',
                  'w_xo', 'w_ho')


def _trunc_normal(shape, generator, stddev=0.01):
  """Truncated normal at +-2 stddev, the init of every weight and bias."""
  t = torch.empty(shape)
  nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev,
                        generator=generator)
  return nn.Parameter(t)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

class _Bf16Conv(torch.autograd.Function):
  """Convolution (or transposed convolution) in bfloat16 of x, bfloat16 or
  a float32 tensor that JAX casts to bfloat16 at this point, with the
  float32 weight w cast to bfloat16, as JAX's ``conv2d`` casts it.

  Its gradients are those of the compiled JAX program, which computes the
  convolution's transposes in float32 over the bfloat16 operands: the
  weight gradient of a convolution is that float32 sum, unrounded (XLA
  drops the round trip through bfloat16 that the weight's cast implies),
  that of a transposed convolution is rounded to bfloat16 (there the
  kernel's flip stands between the two casts, and XLA keeps them); the
  input gradient of a float32 x is unrounded (the cast's round trip is
  dropped), that of a bfloat16 x is rounded to bfloat16."""

  @staticmethod
  def forward(ctx, x, w, stride, padding, transposed):
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    ctx.save_for_backward(xb, wb)
    ctx.x_dtype, ctx.transposed = x.dtype, transposed
    # bias, stride, padding, dilation, transposed, output padding, groups
    ctx.args = (None, stride, padding, (1, 1), transposed, (0, 0), 1)
    return torch.ops.aten.convolution(xb, wb, *ctx.args)

  @staticmethod
  def backward(ctx, g):
    xb, wb = ctx.saved_tensors
    bwd = torch.ops.aten.convolution_backward
    need_x, need_w = ctx.needs_input_grad[:2]
    gx = gw = None
    if need_x and ctx.x_dtype == torch.bfloat16:
      gx = bwd(g, xb, wb, *ctx.args, (True, False, False))[0]
      need_x = False
    if need_x or need_w:
      wide = bwd(g.float(), xb.float(), wb.float(), *ctx.args,
                 (need_x, need_w, False))
      gx = wide[0] if need_x else gx
      gw = wide[1]
      if gw is not None and ctx.transposed:
        gw = gw.to(torch.bfloat16).float()
    return gx, gw, None, None, None


def _conv(x, weight, stride, padding, transposed, dtype):
  """Convolution of x [B,C,H,W] with the [out,in,F,F] (transposed: [in,
  out,F,F]) float32 weight, in ``dtype`` (float32, or bfloat16 by
  ``_Bf16Conv``)."""
  if dtype == torch.bfloat16:
    return _Bf16Conv.apply(x, weight, stride, padding, transposed)
  if transposed:
    return F.conv_transpose2d(x, weight, stride=stride, padding=padding)
  return F.conv2d(x, weight, stride=stride, padding=padding)


def conv2d_same(x, w, dtype=None):
  """Stride-1 SAME convolution.  x [B,C,H,W], w [F,F,in,out] (HWIO), in
  ``dtype`` (default x's).

  SAME puts the odd pad row/column at the bottom/right."""
  k_h, k_w = w.shape[0], w.shape[1]
  pt, pl = (k_h - 1) // 2, (k_w - 1) // 2
  pb, pr = k_h - 1 - pt, k_w - 1 - pl
  weight = w.permute(3, 2, 0, 1)
  if (pt, pl) != (pb, pr):
    x = F.pad(x, (pl, pr, pt, pb))
    pt = pl = 0
  return _conv(x, weight, (1, 1), (pt, pl), False, dtype or x.dtype)


def conv2d_transpose_same(x, w, stride, dtype=None):
  """SAME transposed convolution with output H*stride x W*stride, in
  ``dtype`` (default x's).

  x [B,in,H,W], w [F,F,out,in] (the ``tf.nn.conv2d_transpose`` layout that
  JAX applies with ``transpose_kernel=True``).  JAX's SAME result is the full
  transposed convolution cropped by (F-stride)//2 at the top/left and the
  rest at the bottom/right; PyTorch's ``padding`` crops both sides equally,
  so the crop is taken explicitly."""
  k = w.shape[0]
  if k < stride:
    raise NotImplementedError(f'filter {k} narrower than stride {stride}')
  full = _conv(x, w.permute(3, 2, 0, 1), (stride, stride), (0, 0), True,
               dtype or x.dtype)
  o = (k - stride) // 2
  h, wd = x.shape[2] * stride, x.shape[3] * stride
  return full[:, :, o:o + h, o:o + wd]


def max_pool_same(x, ratio):
  """ratio x ratio max pooling with SAME padding (pads with -inf)."""
  if ratio == 1:
    return x
  pads = []
  for size in (x.shape[3], x.shape[2]):
    total = -(-size // ratio) * ratio - size
    pads += [total // 2, total - total // 2]
  if any(pads):
    x = F.pad(x, pads, value=float('-inf'))
  return F.max_pool2d(x, ratio, ratio)


def nchw(x):
  """NHWC tensor -> NCHW view (channels-last memory)."""
  return x.permute(0, 3, 1, 2)


def nhwc(x):
  """NCHW tensor -> NHWC view; flattening it gives the JAX feature order."""
  return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# BatchNorm with per-timestep copies
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
  """BatchNorm parameters with one [C] copy per timestep, [T, C]; or, with
  ``num_copies`` None, a single [C] copy (the fg model's)."""

  def __init__(self, n_out, num_copies):
    super().__init__()
    shape = (n_out,) if num_copies is None else (num_copies, n_out)
    self.beta = nn.Parameter(torch.zeros(shape))
    self.gamma = nn.Parameter(torch.ones(shape))
    self.register_buffer('ema_mean', torch.zeros(shape))
    self.register_buffer('ema_var', torch.ones(shape))

  def forward(self, x, t, stats=None, out_dtype=None):
    """Normalise channel dim 1 of x ([B,C,H,W] or [B,C]) with copy ``t``
    (None for a single copy); computed in float32, returned in
    ``out_dtype`` (default x's).

    Eval (``stats`` None): with the EMA statistics.  Train (``stats`` a
    list): with the batch mean and biased variance, and the new EMA
    statistics of copy t, ``BN_DECAY * ema + (1 - BN_DECAY) * batch``, are
    appended to ``stats`` as a (mean, var) pair instead of being written
    here, so that a recomputed forward does not apply them twice.

    With ``t`` a list of n copies (``folded``), x holds n groups of B rows,
    rows i*B to (i+1)*B-1 normalised with copy t[i]: in training over the
    group's own statistics, whose pair goes to ``stats[i]``, one list per
    copy; what ``jax.vmap`` of the serial forward over the copies does."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if folded(t):
      return self._forward_folded(x, t, stats).to(out_dtype)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.float()
    copy = (lambda p: p) if t is None else (lambda p: p[t])
    if stats is None:
      mean, var = copy(self.ema_mean), copy(self.ema_var)
    else:
      axes = (0,) + tuple(range(2, x.dim()))
      mean = torch.mean(xf, dim=axes)
      var = torch.var(xf, dim=axes, correction=0)
      stats.append(((BN_DECAY * copy(self.ema_mean)
                     + (1 - BN_DECAY) * mean).detach(),
                    (BN_DECAY * copy(self.ema_var)
                     + (1 - BN_DECAY) * var).detach()))
    inv = torch.rsqrt(var + BN_EPS).view(shape)
    normed = ((xf - mean.view(shape)) * inv * copy(self.gamma).view(shape)
              + copy(self.beta).view(shape))
    return normed.to(out_dtype)

  def _forward_folded(self, x, ts, stats):
    n = len(ts)
    xf = x.float().reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    shape = (n, 1, -1) + (1,) * (x.dim() - 2)
    if stats is None:
      mean, var = self.ema_mean[ts], self.ema_var[ts]
    else:
      axes = (1,) + tuple(range(3, xf.dim()))
      mean = torch.mean(xf, dim=axes)
      var = torch.var(xf, dim=axes, correction=0)
      new_mean = (BN_DECAY * self.ema_mean[ts] + (1 - BN_DECAY) * mean)
      new_var = (BN_DECAY * self.ema_var[ts] + (1 - BN_DECAY) * var)
      for i in range(n):
        stats[i].append((new_mean[i].detach(), new_var[i].detach()))
    inv = torch.rsqrt(var + BN_EPS).view(shape)
    normed = ((xf - mean.view(shape)) * inv * self.gamma[ts].view(shape)
              + self.beta[ts].view(shape))
    return normed.reshape(x.shape)


def folded(t):
  """Whether ``t`` is a list of BatchNorm copies, one a group of rows of
  the batch (``BatchNorm.forward``), and not one copy or None."""
  return isinstance(t, list)


# ---------------------------------------------------------------------------
# CNN / DCNN
# ---------------------------------------------------------------------------

class ConvLayer(nn.Module):
  """One conv (or transposed-conv) layer: ``w``, ``b`` and optional ``bn``."""

  def __init__(self, w_shape, n_out, use_bn, num_bn_copies, generator):
    super().__init__()
    self.w = _trunc_normal(w_shape, generator)
    self.b = _trunc_normal((n_out,), generator)
    self.bn = BatchNorm(n_out, num_bn_copies) if use_bn else None


def init_cnn(filter_sizes, channels, use_bn, num_bn_copies, generator):
  """N-layer CNN; ``channels`` has N+1 entries, input depth first;
  ``num_bn_copies`` as in ``BatchNorm``."""
  return nn.ModuleList(
      ConvLayer((f, f, channels[i], channels[i + 1]), channels[i + 1],
                use_bn[i], num_bn_copies, generator)
      for i, f in enumerate(filter_sizes))


def init_dcnn(filter_sizes, channels, use_bn, skip_ch, num_bn_copies,
              generator):
  """N-layer transposed-conv net; layer i also takes skip_ch[i] channels."""
  layers = []
  in_ch = channels[0]
  for i, f in enumerate(filter_sizes):
    out_ch = channels[i + 1]
    if skip_ch is not None and skip_ch[i]:
      in_ch += skip_ch[i]
    layers.append(ConvLayer((f, f, out_ch, in_ch), out_ch, use_bn[i],
                            num_bn_copies, generator))
    in_ch = out_ch
  return nn.ModuleList(layers)


def _conv_bias_bn(layer, h, t, stats):
  """A conv layer's output h [B,C,H,W] plus its bias, then its BatchNorm
  (copy t; ``stats`` as in ``apply_cnn``), in h's dtype.

  In bfloat16 the bias, cast to bfloat16, is added in float32 where a
  BatchNorm follows, and that sum reaches the BatchNorm unrounded: the
  compiled JAX program fuses ``conv + b`` with the BatchNorm's cast to
  float32 and drops the sum's bfloat16 rounding (XLA keeps the rounding
  of the conv's output, of the bias and of the BatchNorm's result).  In
  float32 this is the plain ``conv + b``."""
  b = layer.b.to(h.dtype).view(1, -1, 1, 1)
  if layer.bn is None:
    if stats is not None:
      for s in (stats if folded(t) else [stats]):
        s.append(None)
    return h + b
  return layer.bn(h.float() + b.float(), t, stats, out_dtype=h.dtype)


def apply_cnn(layers, x, pool, act, t, stats=None, dtype=None):
  """conv -> +b -> BN(copy t) -> act -> SAME max-pool, per layer, in
  ``dtype`` (default x's; a float32 x with ``dtype`` bfloat16 is cast by
  the first convolution, see ``_Bf16Conv``).

  x [B,C,H,W]; returns the list of per-layer activations.  With ``stats``
  a list, BatchNorm runs in train mode and appends each layer's new EMA
  statistics (None for a layer without BatchNorm).  With ``t`` a list of
  copies, x holds one group of rows a copy and ``stats`` one list a copy
  (``BatchNorm.forward``)."""
  h = x
  h_list = []
  for i, layer in enumerate(layers):
    h = _conv_bias_bn(layer, conv2d_same(h, layer.w, dtype), t, stats)
    if act[i] is not None:
      h = act[i](h)
    h = max_pool_same(h, pool[i])
    h_list.append(h)
  return h_list


def apply_dcnn(layers, x, pool, act, t, skip=None, stats=None, dtype=None):
  """Transposed-conv net; skip[i] (may be None) is concatenated on the
  channel axis before layer i.  Returns the per-layer activations;
  ``stats`` and ``dtype`` as in ``apply_cnn``."""
  h = x
  h_list = []
  for i, layer in enumerate(layers):
    if skip is not None and skip[i] is not None:
      h = torch.cat([h, skip[i]], dim=1)
    h = _conv_bias_bn(layer, conv2d_transpose_same(h, layer.w, pool[i],
                                                   dtype), t, stats)
    if act[i] is not None:
      h = act[i](h)
    h_list.append(h)
  return h_list


# ---------------------------------------------------------------------------
# MLP and LSTM
# ---------------------------------------------------------------------------

class Dense(nn.Module):

  def __init__(self, n_in, n_out, generator):
    super().__init__()
    self.w = _trunc_normal((n_in, n_out), generator)
    self.b = _trunc_normal((n_out,), generator)


def init_mlp(dims, generator):
  return nn.ModuleList(Dense(dims[i], dims[i + 1], generator)
                       for i in range(len(dims) - 1))


def apply_mlp(layers, x, act):
  h = x
  h_list = []
  for i, layer in enumerate(layers):
    h = h @ layer.w.to(h.dtype) + layer.b.to(h.dtype)
    if act[i] is not None:
      h = act[i](h)
    h_list.append(h)
  return h_list


_LSTM_GATES = ('i', 'f', 'u', 'o')


class LSTM(nn.Module):
  """The 12-matrix LSTM: w_x{g} [in,H], w_h{g} [H,H], b_{g} [H] for the
  gates i, f, u, o; forget bias initialised to 1."""

  def __init__(self, inp_dim, hid_dim, generator):
    super().__init__()
    self.hid_dim = hid_dim
    for g in _LSTM_GATES:
      setattr(self, f'w_x{g}', _trunc_normal((inp_dim, hid_dim), generator))
      setattr(self, f'w_h{g}', _trunc_normal((hid_dim, hid_dim), generator))
      setattr(self, f'b_{g}', nn.Parameter(
          torch.full((hid_dim,), 1.0 if g == 'f' else 0.0)))

  def forward(self, inp, state):
    """One step.  inp [B,in], state [B,2H] = concat(c, h) -> new state."""
    c, h = state[:, :self.hid_dim], state[:, self.hid_dim:]
    w_x = torch.cat([getattr(self, f'w_x{g}') for g in _LSTM_GATES], dim=1)
    w_h = torch.cat([getattr(self, f'w_h{g}') for g in _LSTM_GATES], dim=1)
    b = torch.cat([getattr(self, f'b_{g}') for g in _LSTM_GATES])
    # In bfloat16 the two products are rounded and summed with the bias in
    # float32, as the compiled JAX program does.
    z = ((inp @ w_x.to(inp.dtype)).float()
         + (h.to(inp.dtype) @ w_h.to(inp.dtype)).float() + b)
    zi, zf, zu, zo = torch.chunk(z, 4, dim=1)
    c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zu)
    h = torch.sigmoid(zo) * torch.tanh(c)
    return torch.cat([c, h], dim=1)


# ---------------------------------------------------------------------------
# Weight decay
# ---------------------------------------------------------------------------

def weight_decay_loss(module, wd):
  """wd * sum over the decayed parameters (``WD_PARAM_NAMES``) of
  0.5 * sum(w^2)."""
  if not wd:
    return 0.0
  total = 0.0
  for name, p in module.named_parameters():
    if name.rsplit('.', 1)[-1] in WD_PARAM_NAMES:
      total = total + 0.5 * torch.sum(torch.square(p))
  return wd * total
