#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and eval paths on one CUDA card
and check them.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each on stdout:
  device        the card, and its name and power limit from nvidia-smi;
  build         nvcc builds rec_attend_tpu_torch/csrc/glimpse.cu and the C++
                compiler csrc/hungarian.cc, both at once (seconds taken),
                and each kernel's registers a thread, spill bytes and
                static shared memory as nvcc -Xptxas -v reports them (the
                paste kernel and both extract routes must be there);
  kernels       each hand-written kernel against its plain PyTorch version,
                at the serving path's shapes (CVPPP, b128, b8 and b1) and at
                a ragged shape (KITTI 128x448, D=13, 48x64 glimpse), with
                CUDA-event times; each extract names its route (the tiled
                kernel and its output rows a block, or the general one);
  kernels_grad  each differentiable glimpse (ExtractPatch, PastePatch)
                against plain autograd through the einsums, every input
                gradient, at the CVPPP train shapes (b32) and the KITTI
                shape; the kernels' backward uses (paste as extract's d_x,
                extract at D=1 as paste's d_p) and the filter-gradient
                einsums timed;
  serve         InstanceSegmenter serves the flagship CVPPP checkpoint (a
                checkout without it fails) to three requests of b=8, 32 and
                128 at the model's size and two of other sizes (b1 530x500,
                b8 300x400: input resize, masks upsampled back), counting
                kernel launches; the other sizes' requests are held against
                the CPU's through the same predict, the b32 forward against
                the plain-glimpse forward and a b2 forward against the CPU
                (beside them plain einsums that sum in another order against
                the plain forward: the float32 floor), a forward with the
                bf16 islands on must fail the same gates, and the b128
                forward is timed;
  train         the Trainer restores the flagship checkpoint with its Adam
                state and takes 5 steps at b32 from step 30000 and 2 from
                step 0 (the ground-truth segmentation mix on), counting
                launches per step; one step's loss, gradients and update are
                held against the plain-glimpse step (b32) at step 0 and at
                step 30000 (there by the loss and all gradients at once,
                beside the step's float32 noise floor) and against the CPU's
                (b2) at step 0, with the matchings of each pair reported
                and pinned where they differ; a step whose glimpse backward
                drops the filter gradients must fail the same gates;
  eval          eval_split over 64 synthetic 224x224 images with labels at
                b32, score and mask thresholds 0.40, with the kernels, the
                plain glimpses and plain einsums that sum in another order
                (the float32 floor), counting kernel launches; per example
                the kernels' SBD is held to the plain one within a limit
                set from that floor, and the counts must be equal; upsample
                on the card against the CPU; host seconds per batch of the
                postprocess chain and of the analyzers.
Then the kernel table (each row with bound_share = bound_ms / ms), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failure raises, and the exit code is not
0.  Without CUDA the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT_DIR = os.path.join(REPO, 'results',
                              'full_model_synth-20260816104712')
REPLACES = {
    'glimpse_extract': 'rec_attend_tpu/ops/pallas/glimpse.py:62',
    'glimpse_paste': 'rec_attend_tpu/ops/pallas/glimpse.py:75',
}
# Where the JAX package launches each kernel for a gradient.
BACKWARD_USES = {
    'glimpse_extract': 'd_p of _paste_bwd, rec_attend_tpu/ops/pallas/'
                       'glimpse.py:181',
    'glimpse_paste': 'd_x of _extract_bwd, rec_attend_tpu/ops/pallas/'
                     'glimpse.py:152',
}
SOURCE = 'rec_attend_tpu_torch/csrc/glimpse.cu'
# Published H100 SXM peaks: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (NVIDIA's data sheet), for the least time of a kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# Kernel against plain version, both float32: the sums run in other orders
# (the tolerance of tests/test_pallas_glimpse.py).
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# Whole forward, kernel glimpses against plain ones (and card against CPU).
# Float32 summation-order differences of 1e-7 pass through 21 canvas
# feedbacks and the steep output sigmoid sigmoid(e^2 * y - 5), whose logits
# reach 300: at mask edges a few pixels move by up to 0.2 while the rest
# agree.  So y_out is held by its mean and by the share of pixels that move
# more than 1e-3, s_out by its largest difference.  A forward with the bf16
# islands on (cfg.dtype='bfloat16') must fail these gates.
Y_OUT_MEAN_ATOL = 1e-5
Y_OUT_MOVED, Y_OUT_MOVED_SHARE = 1e-3, 1e-3
S_OUT_ATOL = 1e-4

# Gradients of one glimpse, Function against plain autograd: the tolerance
# of ROADMAP B, atol scaled by the gradient's largest magnitude (the filter
# gradients sum up to 48*48*4 products).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# Whole train step, kernel glimpses against plain ones (and card against
# CPU), from the same parameters, Adam state, batch and draws:
#   loss: relative difference;
#   gradients (the main gate): per parameter leaf, the relative L2 error
#   ||g - g_ref|| / ||g_ref||; a conv bias that a train-mode BatchNorm
#   follows has gradient 0 in exact arithmetic (the BatchNorm subtracts the
#   batch mean), so there max |g| / max |g_w| of the layer's weight
#   gradient, on both sides, instead;
#   updated parameters: per leaf, the relative L2 error of the update
#   (new - old); for those biases, whose gradient is noise, the largest
#   update difference in units of lr (Adam moves an element whose gradient
#   is noise by up to about lr either way, so 2 lr at most).
#   The update's limit is ten times the gradient's: Adam divides each
#   element by the root of its second moment, which weighs most the
#   elements whose gradient is small against their history (measured on
#   the card: the update's error 1.8 times the gradient's at step 0).
# The steps compared run with cuDNN held to its deterministic algorithms,
# as the serving forwards do, and with the same Hungarian matchings: where
# a step's matchings differ from the reference's in any example, the gate
# holds the step taken with the reference's matching pinned.
# STEP_LIMITS hold at step 0, where the ground-truth segmentation mix fills
# the canvas, so no timestep sees another's predicted masks.  A step whose
# glimpse backward drops the filter gradients must fail them.
STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 1e-3,
               'zero_grad_share_max': 1e-4, 'update_rel_l2_max': 1e-2,
               'zero_update_in_lr_max': 2.0}
# From step 30000 on, both knobs are about 0 and the canvas carries the
# model's own masks through 21 feedbacks and the steep output sigmoid.
# There float32 summation-order differences of 1e-7 grow in the forward
# (y_out) and reach the gradients, with the matchings unchanged: two plain
# steps whose glimpse einsums only sum in other orders differed in the
# gradient of all leaves together by 0.005 to 0.050 relative L2, and in
# their worst leaf by 0.015 to 0.26, over five b32 batches (H100).  So the
# step there is held by the loss and by the relative L2 error of all
# gradients at once, at twice the largest of those floors; the control
# measured 0.95 to 0.99.  A limit set as a multiple of the floor of the
# same run would rest on one sample of a floor that spread tenfold over
# those batches (kernel against plain reached 3.7 times it).
OWN_CANVAS_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_all': 0.1}
GRADIENT_GATES = ('grad_rel_l2_max', 'grad_rel_l2_all')
TRAIN_BATCH = 32
TRAIN_CPU_BATCH = 2
# Requests of other sizes than the model's: CVPPP A1's image size at b1,
# and a b8 request of another size.
OTHER_SIZE_REQUESTS = ((1, 530, 500), (8, 300, 400))
# The eval path: the flagship's valid-split size and thresholds (the
# headline of count_calibration.json), at the JAX TrainConfig batch size.
EVAL_EXAMPLES, EVAL_BATCH, EVAL_THRESHOLD = 64, 32, 0.4
# Per example, kernel against plain: |delta SBD| <= twice the largest of
# the float32 floor (plain einsums that sum in another order against the
# plain forward, same run, same 64 examples) plus the CSVs' resolution,
# 1e-4; counts equal.
EVAL_SBD_FLOOR_FACTOR, EVAL_CSV_RESOLUTION = 2.0, 1e-4
# upsample on the card against the CPU: the tolerance the CPU tests hold
# it to against cv2.
UPSAMPLE_ATOL = 1e-6


def emit(phase, **fields):
  print(json.dumps({'phase': phase, **fields}), flush=True)


def nvidia_smi_name_power():
  proc = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60)
  return proc.stdout.strip().splitlines()[0]


def ms(torch, fn, iters=20, warmup=3, sleep=True):
  """Median time of one call of fn, in ms, from CUDA events.

  With sleep, the stream is given a few ms of sleep before each timed call,
  so that the host has enqueued the call before the device reaches it and
  the events time the device's work only.  Without it the stream is idle,
  and the host's launch overhead counts wherever the device waits for it."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if sleep:
      torch.cuda._sleep(5_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


@contextlib.contextmanager
def deterministic_cudnn(torch):
  """cuDNN held to its deterministic algorithms (same result every call)
  inside the block."""
  saved = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    yield
  finally:
    torch.backends.cudnn.deterministic = saved


def forward_diff(got, want):
  """Differences of two forwards' outputs."""
  dy = (got['y_out'].float().cpu() - want['y_out'].float().cpu()).abs()
  ds = (got['s_out'].float().cpu() - want['s_out'].float().cpu()).abs()
  return {'y_out_mean': float(dy.mean()), 'y_out_max': float(dy.max()),
          'y_out_moved_share': float((dy > Y_OUT_MOVED).float().mean()),
          's_out_max': float(ds.max())}


def gate_failures(stats):
  """Names of the limits that the differences of forward_diff exceed."""
  limits = {'y_out_mean': Y_OUT_MEAN_ATOL,
            'y_out_moved_share': Y_OUT_MOVED_SHARE, 's_out_max': S_OUT_ATOL}
  return [k for k, limit in limits.items() if stats[k] > limit]


def forward_agreement(got, want):
  """Differences of two forwards' outputs; raises beyond the limits."""
  stats = forward_diff(got, want)
  if gate_failures(stats):
    raise AssertionError(f'forwards disagree: {stats}')
  return stats


def bound(nbytes, flops):
  """(least ms on the card, 'bytes' or 'operations')."""
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def filters(torch, attention, b, h, w, fh, fw, gen, dev):
  """Filter banks as the model makes them: random boxes inside the image,
  tap variance from box size over glimpse size."""
  def bank(length, taps):
    ctr = torch.rand(b, generator=gen, device=dev) * length
    size = 8 + torch.rand(b, generator=gen, device=dev) * (length - 8)
    lg_var = torch.log(size / taps)
    return attention.get_gaussian_filter(ctr, size, lg_var, length, taps)
  return bank(h, fh), bank(w, fw)


def check_kernel(torch, gk, attention, name, b, h, w, d, fh, fw, gen, dev,
                 timed):
  """Compare one kernel with its plain version; time all three forms."""
  f_y, f_x = filters(torch, attention, b, h, w, fh, fw, gen, dev)
  if name == 'glimpse_extract':
    a = torch.rand((b, h, w, d), generator=gen, device=dev)
    kernel, plain = gk.glimpse_extract, gk.extract_patch_plain
    library = lambda: torch.einsum('bhf,bhwd,bwg->bfgd', f_y, a, f_x)
    nbytes = 4 * (b * h * w * d + b * h * fh + b * w * fw + b * fh * fw * d)
    flops = 2 * b * (fh * h * w * d + fh * w * d * fw)
  else:
    a = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    kernel, plain = gk.glimpse_paste, gk.paste_patch_plain
    library = lambda: torch.einsum('bhf,bfgd,bwg->bhwd', f_y, a, f_x)
    nbytes = 4 * (b * fh * fw * d + b * h * fh + b * w * fw + b * h * w * d)
    flops = 2 * b * (h * fh * fw * d + h * w * fw * d)
  got = kernel(a, f_y, f_x)
  torch.cuda.synchronize()
  want = plain(a, f_y, f_x)
  err = float((got - want).abs().max())
  if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
    raise AssertionError(
        f'{name} {tuple(a.shape)} disagrees with its plain version: max abs '
        f'err {err}, max rel err '
        f'{float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())}')
  result = {'shape': [b, h, w, d, fh, fw], 'max_abs_err': err,
            'max_abs_value': float(want.abs().max())}
  if name == 'glimpse_extract':
    result['route'] = gk.extract_route_of(a, f_y, f_x)
  if timed:
    bound_ms, bound_by = bound(nbytes, flops)
    kernel_ms = ms(torch, lambda: kernel(a, f_y, f_x))
    result.update(
        kernel_ms=kernel_ms,
        plain_ms=ms(torch, lambda: plain(a, f_y, f_x)),
        library_ms=ms(torch, library),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / kernel_ms, bytes=nbytes, flops=flops)
  return result


def check_kernel_grad(torch, gk, attention, name, b, h, w, d, fh, fw, gen,
                      dev, timed):
  """Every input gradient of one differentiable glimpse against plain
  autograd through the einsums; time the kernel's backward use and the
  filter-gradient einsums."""
  f_y, f_x = filters(torch, attention, b, h, w, fh, fw, gen, dev)
  if name == 'glimpse_extract':
    a = torch.rand((b, h, w, d), generator=gen, device=dev)
    g = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    fn, plain = gk.glimpse_extract, attention.extract_patch
  else:
    a = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    g = torch.rand((b, h, w, d), generator=gen, device=dev)
    fn, plain = gk.glimpse_paste, attention.paste_patch

  def grads(f):
    ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
    return torch.autograd.grad(f(*ins), ins, g)

  got = grads(fn)
  torch.cuda.synchronize()
  want = grads(plain)
  result = {'shape': [b, h, w, d, fh, fw]}
  for key, x, y in zip(('d_operand', 'd_f_y', 'd_f_x'), got, want):
    err = float((x - y).abs().max())
    scale = max(1.0, float(y.abs().max()))
    if not torch.allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale):
      raise AssertionError(f'{name} {key} at {result["shape"]} disagrees '
                           f'with plain autograd: max abs err {err}, '
                           f'largest |grad| {scale}')
    result[key] = {'max_abs_err': err, 'max_abs_value': float(y.abs().max())}
  if not timed:
    return result
  # The kernel's backward use: extract's d_x = paste(g); paste's d_p =
  # extract(g).  Bytes: g, both filter banks, the result; operations: the
  # two contractions at the use's shapes.
  if name == 'glimpse_extract':
    use = lambda: gk._paste(g, f_y, f_x)
    use_plain = lambda: attention.paste_patch(g, f_y, f_x)
    use_library = lambda: torch.einsum('bhf,bfgd,bwg->bhwd', f_y, g, f_x)
    nbytes = 4 * (b * fh * fw * d + b * h * fh + b * w * fw + b * h * w * d)
    flops = 2 * b * (h * fh * fw * d + h * w * fw * d)
    use_kernel = 'glimpse_paste'

    def filter_grads():
      xg = torch.einsum('bhwd,bwg->bhgd', a, f_x)
      fyx = torch.einsum('bhf,bhwd->bfwd', f_y, a)
      return (torch.einsum('bfgd,bhgd->bhf', g, xg),
              torch.einsum('bfgd,bfwd->bwg', g, fyx))
  else:
    use = lambda: gk._extract(g, f_y, f_x)
    use_plain = lambda: attention.extract_patch(g, f_y, f_x)
    use_library = lambda: torch.einsum('bhf,bhwd,bwg->bfgd', f_y, g, f_x)
    nbytes = 4 * (b * h * w * d + b * h * fh + b * w * fw + b * fh * fw * d)
    flops = 2 * b * (fh * h * w * d + fh * w * d * fw)
    use_kernel = 'glimpse_extract'

    def filter_grads():
      pfx = torch.einsum('bfgd,bwg->bfwd', a, f_x)
      fyp = torch.einsum('bhf,bfgd->bhgd', f_y, a)
      return (torch.einsum('bhwd,bfwd->bhf', g, pfx),
              torch.einsum('bhwd,bhgd->bwg', g, fyp))
  bound_ms, bound_by = bound(nbytes, flops)
  ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
  out = fn(*ins)
  plain_ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
  plain_out = plain(*plain_ins)
  kernel_ms = ms(torch, use)
  result['backward_use'] = {
      'kernel': use_kernel, 'kernel_ms': kernel_ms,
      'plain_ms': ms(torch, use_plain), 'library_ms': ms(torch, use_library),
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'bound_share': bound_ms / kernel_ms, 'bytes': nbytes, 'flops': flops}
  if use_kernel == 'glimpse_extract':
    result['backward_use']['route'] = gk.extract_route_of(g, f_y, f_x)
  result['filter_grad_einsums_ms'] = ms(torch, filter_grads)
  result['backward_ms'] = ms(torch, lambda: torch.autograd.grad(
      out, ins, g, retain_graph=True))
  result['plain_backward_ms'] = ms(torch, lambda: torch.autograd.grad(
      plain_out, plain_ins, g, retain_graph=True))
  return result


def zero_grad_leaves(model):
  """{bias name: weight name} of the conv layers that a BatchNorm follows
  (their bias gradient is 0 in exact arithmetic)."""
  return {f'{name[:-len(".bn")]}.b': f'{name[:-len(".bn")]}.w'
          for name, module in model.named_modules()
          if name.endswith('.bn') and module is not None}


def match_differences(got, want):
  """{matching: number of examples whose matching differs} of two steps'
  'match', 'match_box' (Hungarian) and 'grd_match' (greedy, [B,T,T])."""
  return {k: int((got[k] != want[k]).flatten(1).any(1).sum())
          for k in ('match', 'match_box', 'grd_match')}


def step_diff(torch, model, got, want, lr):
  """Differences of two train steps from the same state, as one_step
  returns them.  Returns the statistics that STEP_LIMITS names ("_max" ones
  as [leaf, value]); besides them the relative L2 error of all gradients
  but the zero-gradient biases at once, the median leaf's, how many
  examples' matchings differ, and the forwards' differences."""
  zero = zero_grad_leaves(model)
  loss, grads, old, new = got[:4]
  loss_ref, grads_ref, _, new_ref = want[:4]
  stats = {'loss': float(loss), 'loss_ref': float(loss_ref),
           'loss_rel_diff': abs(float(loss) - float(loss_ref))
           / max(abs(float(loss_ref)), 1e-30)}
  grad_rel, update_rel, zero_grad, zero_update = {}, {}, {}, {}

  def rel(x, y):
    return float((x - y).norm() / y.norm().clamp_min(1e-30))
  for k, g in grads.items():
    g_ref = grads_ref[k]
    if not (torch.isfinite(g).all() and torch.isfinite(new[k]).all()):
      raise AssertionError(f'non-finite gradient or parameter: {k}')
    if k in zero:
      w_ref = float(grads_ref[zero[k]].abs().max())
      zero_grad[k] = max(float(g.abs().max()),
                         float(g_ref.abs().max())) / max(w_ref, 1e-30)
      zero_update[k] = float((new[k] - new_ref[k]).abs().max()) / lr
    else:
      grad_rel[k] = rel(g, g_ref)
      update_rel[k] = rel(new[k] - old[k], new_ref[k] - old[k])
  worst = lambda d: max(d.items(), key=lambda kv: kv[1])
  live = [k for k in grads if k not in zero]
  stats.update(grad_rel_l2_max=worst(grad_rel),
               update_rel_l2_max=worst(update_rel),
               zero_grad_share_max=worst(zero_grad),
               zero_update_in_lr_max=worst(zero_update),
               grad_rel_l2_all=rel(torch.cat([grads[k].flatten()
                                              for k in live]),
                                   torch.cat([grads_ref[k].flatten()
                                              for k in live])),
               grad_rel_l2_median=statistics.median(grad_rel.values()),
               matches_differ=match_differences(got[4], want[4]),
               forward=forward_diff(got[4], want[4]))
  return stats


def step_gate_failures(stats, limits):
  """Names of the limits that step_diff's statistics exceed."""
  def value(v):
    return v[1] if isinstance(v, (list, tuple)) else v
  return [k for k, limit in limits.items() if value(stats[k]) > limit]


@contextlib.contextmanager
def hungarian_calls(matching, solve_fn):
  """Inside the block every Hungarian solve of the loss calls
  solve_fn(solve, weights), where solve is the host solver."""
  solve = matching.hungarian_lib.hungarian
  matching.hungarian_lib.hungarian = lambda w: solve_fn(solve, w)
  try:
    yield
  finally:
    matching.hungarian_lib.hungarian = solve


def one_step(torch, ts, matching, model, opt_state, batch, draws, step,
             glimpse, pinned=None):
  """One train step on copies of model and opt_state: (loss, grads, old
  params, new params, matches).  matches holds the step's Hungarian
  matchings 'match' and 'match_box', its greedy matches 'grd_match', the
  host solver's answer 'solved', and the forward's 'y_out' and 's_out'.  With pinned (another step's
  'solved'), the solve returns that answer instead of solving."""
  model = copy.deepcopy(model)
  opt_state = copy.deepcopy(opt_state)
  old = {k: v.detach().clone() for k, v in model.named_parameters()}
  solved = []

  def solve_fn(solve, w):
    solved.append(solve(w) if pinned is None else pinned)
    return solved[-1]
  with hungarian_calls(matching, solve_fn):
    loss, aux, grads = ts.loss_and_grads(model, batch, draws, step, glimpse)
  ts.apply_updates(model, opt_state, grads, aux['new_bn'])
  new = {k: v.detach().clone() for k, v in model.named_parameters()}
  (solution,) = solved
  outs = aux['outputs']
  matches = {'match': aux['match'], 'match_box': aux['match_box'],
             'grd_match': outs['grd_match'], 'solved': solution,
             'y_out': outs['y_out'].detach(), 's_out': outs['s_out'].detach()}
  return loss.detach(), grads, old, new, matches


def without_filter_grads(torch, gk):
  """Glimpse functions whose backward drops d_f_y and d_f_x: the negative
  control of the train-step gates."""
  class Drop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f):
      return f.view_as(f)

    @staticmethod
    def backward(ctx, g):
      return torch.zeros_like(g)

  return (lambda x, f_y, f_x: gk.glimpse_extract(x, Drop.apply(f_y),
                                                 Drop.apply(f_x)),
          lambda p, f_y, f_x: gk.glimpse_paste(p, Drop.apply(f_y),
                                               Drop.apply(f_x)))


def reordered_plain(torch):
  """Plain glimpse einsums that contract in the other order (W before H for
  extract, G before F for paste): the same functions, other float32
  rounding."""
  return (lambda x, f_y, f_x: torch.einsum(
              'bhf,bhgd->bfgd', f_y, torch.einsum('bhwd,bwg->bhgd', x, f_x)),
          lambda p, f_y, f_x: torch.einsum(
              'bhf,bfwd->bhwd', f_y, torch.einsum('bfgd,bwg->bfwd', p, f_x)))


def to_device(draws, dev):
  return {k: (v if k == 'aug' else v.to(dev)) for k, v in draws.items()}


def held_steps(torch, model, run, want, lr, limits):
  """A train step held against the reference step want (as one_step gives
  them).  run(pinned) takes the step, solving its matchings, or with the
  host solver's answer pinned.  Yields (suffix, stats, gated): the step as
  it solves ('', gated where its Hungarian matchings agree with want's in
  every example) and, where they do not, the step with want's answer pinned
  ('_pinned', gated)."""
  def diff(got):
    stats = step_diff(torch, model, got, want, lr)
    stats['failed'] = step_gate_failures(stats, limits)
    return stats
  stats = diff(run(None))
  agree = not (stats['matches_differ']['match']
               or stats['matches_differ']['match_box'])
  yield '', stats, agree
  if not agree:
    yield '_pinned', diff(run(want[4]['solved'])), True


def step_gates(torch, ts, matching, gk, model, opt, batch, draws, step, lr,
               limits):
  """Kernel glimpses against plain ones on one train step at global step
  ``step``, from the same parameters, Adam state, batch and draws, with
  cuDNN held to its deterministic algorithms, held to ``limits``.  Beside
  it: two plain steps whose einsums sum in other orders (the float32 noise
  floor), and the step whose glimpse backward drops the filter gradients,
  with the plain step's matchings pinned, which must fail the gradient
  limits.  Returns (gates {name: stats}, failures)."""
  def run(glimpse):
    def step_fn(pinned):
      with deterministic_cudnn(torch):
        return one_step(torch, ts, matching, model, opt, batch, draws, step,
                        glimpse, pinned)
    return step_fn
  plain = run('plain')(None)
  gates, failures = {}, []
  for name, stats, _ in held_steps(torch, model, run(reordered_plain(torch)),
                                   plain, lr, limits):
    gates['noise_floor' + name] = stats
  for name, stats, gated in held_steps(torch, model, run('kernel'), plain,
                                       lr, limits):
    gates['kernel_vs_plain' + name] = stats
    if gated and stats['failed']:
      failures.append(f'kernel_vs_plain{name}: fails {stats["failed"]}')
  control = run(without_filter_grads(torch, gk))(plain[4]['solved'])
  stats = step_diff(torch, model, control, plain, lr)
  stats['failed'] = step_gate_failures(stats, limits)
  gates['dropped_filter_grads_vs_plain_pinned'] = stats
  if not set(GRADIENT_GATES) & set(stats['failed']):
    failures.append('dropped_filter_grads_vs_plain_pinned: the gradient '
                    'gate passes it')
  return gates, failures


def read_scores(folder, name):
  """{example id: value} of an analyzer's CSV (the ID,Score lines)."""
  with open(os.path.join(folder, f'{name}.csv')) as f:
    rows = [line.strip().split(',') for line in f.readlines()[1:]]
  return {r[0]: float(r[1]) for r in rows if r[0] not in ('Mean', 'Std')}


def eval_phase(torch, cfg, gk):
  """The eval path: eval_split over a synthetic split with the kernel
  glimpses, the plain ones and the reordered plain ones (the float32
  floor), cuDNN deterministic; launches counted on the kernel run."""
  from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS
  from rec_attend_tpu_torch.cli.eval import eval_split
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.utils import postprocess as pp

  T = cfg.timespan
  ds = SyntheticDataset(EVAL_EXAMPLES, cfg.inp_height, cfg.inp_width, T,
                        seed=4)
  n_batches = -(-EVAL_EXAMPLES // EVAL_BATCH)
  names = DEFAULT_ANALYZERS + ['count']

  def run(glimpse, label):
    exp = EvalExperiment(CHECKPOINT_DIR, cfg=cfg, device='cuda',
                         glimpse=glimpse)
    out = os.path.join(csv_root, label)
    timings = {}
    t0 = time.time()
    with deterministic_cudnn(torch):
      summary = eval_split(exp, ds, out, [EVAL_THRESHOLD], names,
                           batch_size=EVAL_BATCH,
                           score_threshold=EVAL_THRESHOLD, timings=timings)
    seconds = time.time() - t0
    means = {k.split()[0]: float(v[0])
             for k, v in summary[EVAL_THRESHOLD].items()}
    if not all(math.isfinite(v) for v in means.values()):
      raise AssertionError(f'eval {label}: means {means}')
    per_example = {n: read_scores(out, n) for n in ('sbd', 'dic')}
    if len(per_example['sbd']) != EVAL_EXAMPLES:
      raise AssertionError(f'eval {label}: {len(per_example["sbd"])} rows')
    return {'means': means, 'per_example': per_example, 'seconds': seconds,
            'timings': timings}

  # The analyzers' CSVs go to a temporary folder inside the checkout.
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_eval-',
                                   dir=REPO) as csv_root:
    gk.reset_launch_counts()
    kernel = run('kernel', 'kernel')
    launches = gk.launch_counts()
    want = {'glimpse_extract': T * n_batches,
            'glimpse_paste': 2 * T * n_batches}
    if launches != want:
      raise AssertionError(f'eval: kernel launches {launches}, want {want}')
    plain = run('plain', 'plain')
    floor = run(reordered_plain(torch), 'reordered_plain')

  def compare(got, ref):
    sbd, sbd_ref = got['per_example']['sbd'], ref['per_example']['sbd']
    dic, dic_ref = got['per_example']['dic'], ref['per_example']['dic']
    return {'sbd_max_abs_diff': max(abs(sbd[k] - sbd_ref[k]) for k in sbd),
            'sbd_differ': sorted(k for k in sbd if sbd[k] != sbd_ref[k]),
            'count_differ': sorted(k for k in dic if dic[k] != dic_ref[k])}
  floor_stats = compare(floor, plain)
  kernel_stats = compare(kernel, plain)
  sbd_limit = (EVAL_SBD_FLOOR_FACTOR * floor_stats['sbd_max_abs_diff']
               + EVAL_CSV_RESOLUTION)
  failures = []
  if kernel_stats['sbd_max_abs_diff'] > sbd_limit:
    failures.append(f'SBD differs by {kernel_stats["sbd_max_abs_diff"]}, '
                    f'limit {sbd_limit}')
  if kernel_stats['count_differ']:
    failures.append(f'counts differ at {kernel_stats["count_differ"]}')

  # upsample on the card against the CPU, on the same confidence-weighted
  # maps: at the model's size (the eval path) and at 530x500 (serving).
  exp = EvalExperiment(CHECKPOINT_DIR, cfg=cfg, device='cuda')
  with torch.inference_mode():
    x = torch.from_numpy(ds.get_batch(range(min(8, EVAL_EXAMPLES)))['x'])
    out = full_model_forward(exp.model, x.cuda())
    maps = out['y_out'] * out['s_out'][:, :, None, None]
  upsample = {}
  for b, size in ((len(x), (cfg.inp_height, cfg.inp_width)),
                  (2, (530, 500))):
    got = pp.upsample(maps[:b], [size] * b).cpu()
    want = pp.upsample(maps[:b].cpu(), [size] * b)
    err = float((got - want).abs().max())
    upsample[f'b{b}_{size[0]}x{size[1]}'] = err
    if err > UPSAMPLE_ATOL:
      failures.append(f'upsample to {size} on the card differs from the '
                      f'CPU by {err}')
  if failures:
    raise AssertionError(f'eval gates: {failures}')
  median = lambda v: statistics.median(v) if v else None
  return {
      'examples': EVAL_EXAMPLES, 'batch': EVAL_BATCH,
      'thresholds': {'score': EVAL_THRESHOLD, 'mask': EVAL_THRESHOLD},
      'launches': launches,
      'means': {'kernel': kernel['means'], 'plain': plain['means'],
                'reordered_plain': floor['means']},
      'kernel_vs_plain': kernel_stats,
      'reordered_plain_vs_plain': floor_stats,
      'limits': {'sbd_max_abs_diff': sbd_limit, 'count_differ': 0,
                 'upsample_card_vs_cpu': UPSAMPLE_ATOL},
      'upsample_card_vs_cpu_max_abs': upsample,
      'seconds': {k: v['seconds'] for k, v in (
          ('kernel', kernel), ('plain', plain), ('reordered_plain', floor))},
      'host_seconds_per_batch_median': {
          k: median(v) for k, v in kernel['timings'].items()},
      'host_seconds_per_batch': kernel['timings']}


def flagship_segmenter(cfg):
  """(InstanceSegmenter on the card, checkpoint path): the flagship
  checkpoint.  Raises where the checkout lacks it."""
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.serving import InstanceSegmenter
  ckpt = saver.latest_checkpoint(CHECKPOINT_DIR)
  return (InstanceSegmenter.from_checkpoint(CHECKPOINT_DIR, cfg=cfg,
                                            device='cuda'),
          os.path.relpath(ckpt, REPO))


def train_phase(torch, np, cfg, dev, gk, name_power):
  """The training path: restore, gate one step, take 5 + 2 steps."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching

  trainer = Trainer(cfg, device=dev, seed=0)
  ckpt = trainer.restore(CHECKPOINT_DIR)
  if trainer.step != 30000 or trainer.opt_state['count'] != 30000:
    raise AssertionError(f'restored step {trainer.step}, Adam count '
                         f'{trainer.opt_state["count"]}')
  T, b = cfg.timespan, TRAIN_BATCH

  def batches(seed0):
    seed = seed0
    while True:
      yield synthetic_instances(b, cfg.inp_height, cfg.inp_width, T,
                                seed=seed)
      seed += 1

  # ---- gates: one step from the restored state ------------------------
  batch = {k: v.to(dev) for k, v in next(batches(1000)).items()}
  draws = draw_train_randoms(cfg, b, torch.Generator(dev).manual_seed(1))
  lr = learn_rate(cfg, trainer.opt_state['count'])
  gates, failures = {}, []
  for step, limits in ((0, STEP_LIMITS), (30000, OWN_CANVAS_LIMITS)):
    g, f = step_gates(torch, ts, matching, gk, trainer.model,
                      trainer.opt_state, batch, draws, step, lr, limits)
    gates.update({f'{k}_b{b}_step{step}': v for k, v in g.items()})
    failures += [f'step {step}: {x}' for x in f]
  # The card against the CPU, b2, at step 0.
  cpu_model = FullModel(cfg, device='cpu')
  cpu_model.load_state_dict(trainer.model.state_dict())
  cpu_opt = {'count': trainer.opt_state['count'],
             'mu': {k: v.cpu() for k, v in trainer.opt_state['mu'].items()},
             'nu': {k: v.cpu() for k, v in trainer.opt_state['nu'].items()}}
  nb = TRAIN_CPU_BATCH
  small = {k: v[:nb] for k, v in batch.items()}
  small_draws = draw_train_randoms(cfg, nb,
                                   torch.Generator(dev).manual_seed(2))
  host = one_step(torch, ts, matching, cpu_model, cpu_opt,
                  {k: v.cpu() for k, v in small.items()},
                  to_device(small_draws, 'cpu'), 0, 'kernel')
  host = tuple(({k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in x.items()} if isinstance(x, dict) else x.to(dev))
               for x in host)

  def card(pinned):
    with deterministic_cudnn(torch):
      return one_step(torch, ts, matching, trainer.model, trainer.opt_state,
                      small, small_draws, 0, 'kernel', pinned)
  for name, stats, gated in held_steps(torch, trainer.model, card, host, lr,
                                       STEP_LIMITS):
    gates[f'card_vs_cpu{name}_b{nb}_step0'] = stats
    if gated and stats['failed']:
      failures.append(f'card_vs_cpu{name}: fails {stats["failed"]}')
  if failures:
    raise AssertionError(f'train step gates: {failures}; {gates}')

  # ---- the main path: 5 steps from 30000, 2 from 0 ---------------------
  solve_ms = []

  def timed_solve(solve, w):
    t0 = time.perf_counter()
    out = solve(w)
    solve_ms.append((time.perf_counter() - t0) * 1e3)
    return out
  data = batches(0)
  steps = []
  forward_launches = {'glimpse_extract': 0, 'glimpse_paste': 0}
  backward_launches = dict(forward_launches)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with hungarian_calls(matching, timed_solve):
    for i in range(7):
      if i == 5:
        trainer.step = 0
      step = trainer.step
      gk.reset_launch_counts()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      (metrics,) = trainer.run(1, data)
      end.record()
      end.synchronize()
      total, bwd = gk.launch_counts(), gk.launch_counts(backward=True)
      want = {'glimpse_extract': 4 * T, 'glimpse_paste': 4 * T}
      want_bwd = {'glimpse_extract': 2 * T, 'glimpse_paste': 0}
      if total != want or bwd != want_bwd:
        raise AssertionError(f'step {step}: launches {total} (backward '
                             f'{bwd}), want {want} (backward {want_bwd})')
      for k in total:
        forward_launches[k] += total[k] - bwd[k]
        backward_launches[k] += bwd[k]
      if not np.isfinite(metrics['loss']):
        raise AssertionError(f'step {step}: loss {metrics["loss"]}')
      steps.append({'step': step, 'ms': start.elapsed_time(end),
                    'solve_ms': solve_ms[-1], 'launches': total,
                    'backward_launches': bwd,
                    **{k: metrics[k] for k in (
                        'loss', 'box_loss', 'segm_loss', 'conf_loss',
                        'iou_soft', 'count_acc', 'learn_rate')}})
  peak = torch.cuda.max_memory_allocated()
  for k, v in trainer.model.state_dict().items():
    if not torch.isfinite(v).all():
      raise AssertionError(f'non-finite parameter after training: {k}')
  if trainer.opt_state['count'] != 30007:
    raise AssertionError(f'Adam count {trainer.opt_state["count"]}')
  step_ms = statistics.median(s['ms'] for s in steps)
  solve_med = statistics.median(s['solve_ms'] for s in steps)
  return {
      'weights': os.path.relpath(ckpt, REPO), 'batch': b,
      'gates': gates,
      'limits': {'step0': STEP_LIMITS, 'step30000': OWN_CANVAS_LIMITS},
      'steps': steps, 'step_ms_median': step_ms,
      'instances_per_s': b * T / (step_ms / 1e3),
      'max_memory_allocated_bytes': peak,
      'hungarian_solve_ms_median': solve_med,
      'hungarian_share': solve_med / step_ms,
      'forward_launches': forward_launches,
      'backward_launches': backward_launches,
      'adam_count': trainer.opt_state['count'], 'nvidia_smi': name_power}


def main():
  import torch
  if not torch.cuda.is_available():
    sys.exit('chip_smoke: CUDA is not available; this script runs on a card')
  import numpy as np
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.data.synthetic import synthetic_images
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.ops import attention
  from rec_attend_tpu_torch.ops.cuda import build
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  # ---- device ----------------------------------------------------------
  start = time.time()
  name_power = nvidia_smi_name_power()
  dev = torch.device('cuda')
  kind = torch.cuda.get_device_name(0)
  emit('device', kind=kind, count=torch.cuda.device_count(),
       nvidia_smi=name_power, torch=torch.__version__,
       cuda=torch.version.cuda)

  # ---- build -----------------------------------------------------------
  t0 = time.time()
  paths = build.build()
  build.load()
  build.load_hungarian()
  resources = build.kernel_resources(build.compile_log('glimpse'))
  for prefix in ('paste_kernel', 'extract_tiled_kernel',
                 'extract_kernel_general'):
    if not any(k.startswith(prefix) for k in resources):
      raise AssertionError(f'nvcc -Xptxas -v reported no {prefix}')
  emit('build', seconds=time.time() - t0,
       libraries={k: os.path.relpath(v, REPO) for k, v in paths.items()},
       kernel_resources=resources,
       extract_kernels={k: v for k, v in resources.items()
                        if k.startswith('extract')})

  # ---- kernels ---------------------------------------------------------
  # Full float32 everywhere: matmuls and convolutions off TF32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gen = torch.Generator(device=dev).manual_seed(0)
  cfg = cvppp_full_config()
  main_dims = {
      'glimpse_extract': (128, cfg.inp_height, cfg.inp_width,
                          cfg.acnn_inp_depth, cfg.filter_height,
                          cfg.filter_width),
      'glimpse_paste': (128, cfg.inp_height, cfg.inp_width, 1,
                        cfg.filter_height, cfg.filter_width),
  }
  ragged_dims = (16, 128, 448, 13, 48, 64)
  checks = {}
  for name, dims in main_dims.items():
    checks[name] = check_kernel(torch, gk, attention, name, *dims, gen, dev,
                                timed=True)
    checks[name]['ragged'] = check_kernel(torch, gk, attention, name,
                                          *ragged_dims, gen, dev, timed=False)
  # The small requests of the serving path: 8 images, and one.
  for name, dims in main_dims.items():
    for b in (8, 1):
      checks[name][f'b{b}'] = check_kernel(torch, gk, attention, name, b,
                                           *dims[1:], gen, dev, timed=True)
  # The main path's extracts take the tiled kernel, the ragged one the
  # general kernel.
  ex = checks['glimpse_extract']
  routes = [c['route']['kernel'] for c in (ex, ex['b8'], ex['b1'],
                                           ex['ragged'])]
  if routes != ['extract_tiled_kernel'] * 3 + ['extract_kernel_general']:
    raise AssertionError(f'extract routes (b128, b8, b1, ragged): {routes}')
  emit('kernels', tf32=False, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
       nvidia_smi=name_power, kernels=checks)

  # ---- kernels_grad ----------------------------------------------------
  # The train step's shapes: extract takes x [32,224,224,4]; paste writes
  # [32,224,224,1], so its backward extracts at D=1.
  b = TRAIN_BATCH
  train_dims = {
      'glimpse_extract': (b, cfg.inp_height, cfg.inp_width,
                          cfg.acnn_inp_depth, cfg.filter_height,
                          cfg.filter_width),
      'glimpse_paste': (b, cfg.inp_height, cfg.inp_width, 1,
                        cfg.filter_height, cfg.filter_width),
  }
  grad_checks = {}
  for name, dims in train_dims.items():
    grad_checks[name] = check_kernel_grad(torch, gk, attention, name, *dims,
                                          gen, dev, timed=True)
    grad_checks[name]['ragged'] = check_kernel_grad(
        torch, gk, attention, name, *ragged_dims, gen, dev, timed=False)
  emit('kernels_grad', tf32=False, rtol=GRAD_RTOL, atol=GRAD_ATOL,
       atol_scaled_by='max(1, largest |grad|)', nvidia_smi=name_power,
       functions=grad_checks)

  # ---- serve -----------------------------------------------------------
  seg, weights = flagship_segmenter(cfg)
  T = cfg.timespan
  images = {b: synthetic_images(b, cfg.inp_height, cfg.inp_width, seed=b)
            for b in (8, 32, 128)}
  other_sizes = [synthetic_images(b, h, w, seed=h).numpy()
                 for b, h, w in OTHER_SIZE_REQUESTS]
  gk.reset_launch_counts()
  requests = []
  for imgs in [v.numpy() for v in images.values()] + other_sizes:
    b, h, w = imgs.shape[:3]
    before = gk.launch_counts()
    t0 = time.time()
    result = seg.predict(imgs)
    seconds = time.time() - t0
    launched = {k: v - before[k] for k, v in gk.launch_counts().items()}
    if launched != {'glimpse_extract': T, 'glimpse_paste': 2 * T}:
      raise AssertionError(f'b={b}: kernel launches {launched}, want '
                           f'{T} extract and {2 * T} paste')
    if result['masks'].shape != (b, T, h, w):
      raise AssertionError(f'masks {result["masks"].shape}')
    if not (np.isfinite(result['scores']).all()
            and np.isfinite(result['soft_masks']).all()):
      raise AssertionError('non-finite outputs')
    if result['counts'].min() < 0 or result['counts'].max() > T:
      raise AssertionError(f'counts {result["counts"]}')
    requests.append({'batch': b, 'size': [h, w], 'seconds': seconds,
                     'launches': launched,
                     'counts': result['counts'].tolist()[:8],
                     'mask_pixels': int(result['masks'].sum())})
  launches = gk.launch_counts()

  # Requests of other sizes, the card against the CPU through the same
  # predict: scores within the serving gate's s_out limit, the share of
  # mask pixels that differ within its moved-pixel share, counts equal.
  from rec_attend_tpu_torch.serving import InstanceSegmenter
  cpu_seg = InstanceSegmenter(seg.model.state_dict(), cfg, device='cpu')
  other_sizes_vs_cpu = {}
  for imgs in other_sizes:
    with deterministic_cudnn(torch):
      got = seg.predict(imgs)
    want = cpu_seg.predict(imgs)
    stats = {
        'scores_max_abs': float(np.abs(got['scores'] - want['scores']).max()),
        'mask_pixels_differ_share': float(
            (got['masks'] != want['masks']).mean()),
        'soft_masks_max_abs': float(
            np.abs(got['soft_masks'] - want['soft_masks']).max()),
        'counts_equal': bool((got['counts'] == want['counts']).all())}
    other_sizes_vs_cpu['b{}_{}x{}'.format(*imgs.shape[:3])] = stats
    if (stats['scores_max_abs'] > S_OUT_ATOL
        or stats['mask_pixels_differ_share'] > Y_OUT_MOVED_SHARE
        or not stats['counts_equal']):
      raise AssertionError(f'request {imgs.shape}: card against CPU {stats}')

  with torch.inference_mode():
    x32 = images[32].to(dev)
    # cuDNN's default algorithms may sum in another order from one call to
    # the next (atomics), and the forward's feedbacks carry such 1e-7
    # differences to s_out: two plain forwards of the same batch differ.
    # The gates compare with cuDNN held to its deterministic algorithms.
    want = full_model_forward(seg.model, x32, glimpse='plain')
    plain_repeat = forward_diff(
        full_model_forward(seg.model, x32, glimpse='plain'), want)
  with deterministic_cudnn(torch), torch.inference_mode():
    want = full_model_forward(seg.model, x32, glimpse='plain')
    plain_repeat_det = forward_diff(
        full_model_forward(seg.model, x32, glimpse='plain'), want)
    # The float32 floor beside the gate: plain einsums that sum in another
    # order, against the plain forward (reported, not gated).
    reordered = forward_diff(full_model_forward(
        seg.model, x32, glimpse=reordered_plain(torch)), want)
    # Kernel glimpses against the plain einsum forms, b32.
    got32 = full_model_forward(seg.model, x32, glimpse='kernel')
    plain_err = forward_agreement(got32, want)
    # The card against the CPU on a small batch.
    cpu_model = FullModel(cfg, device='cpu')
    cpu_model.load_state_dict(seg.model.state_dict())
    x2 = images[8][:2]
    got = full_model_forward(seg.model, x2.to(dev))
    want = full_model_forward(cpu_model, x2)
    cpu_err = forward_agreement(got, want)
    # The gates must reject a lower-precision forward: the same weights with
    # the bf16 islands on, against the float32 kernel forward, b32.
    bf16_model = FullModel(cfg.replace(dtype='bfloat16'), device='cuda')
    bf16_model.load_state_dict(seg.model.state_dict())
    bf16_err = forward_diff(full_model_forward(bf16_model, x32), got32)
    bf16_err['failed'] = gate_failures(bf16_err)
    if not bf16_err['failed']:
      raise AssertionError(f'the gates pass a bf16 forward: {bf16_err}')
  with torch.inference_mode():
    # b128 forward time.
    x128 = images[128].to(dev)
    forward_ms = ms(torch, lambda: full_model_forward(seg.model, x128),
                    iters=5, warmup=1, sleep=False)
  emit('serve', weights=weights, requests=requests, launches=launches,
       plain_vs_plain_b32=plain_repeat,
       plain_vs_plain_b32_deterministic=plain_repeat_det,
       reordered_plain_vs_plain_b32=reordered,
       kernel_vs_plain_b32=plain_err, card_vs_cpu_b2=cpu_err,
       other_sizes_card_vs_cpu=other_sizes_vs_cpu,
       bf16_vs_f32_b32=bf16_err,
       limits={'y_out_mean': Y_OUT_MEAN_ATOL,
               'y_out_moved_share': Y_OUT_MOVED_SHARE,
               'y_out_moved': Y_OUT_MOVED, 's_out_max': S_OUT_ATOL},
       forward_ms_b128=forward_ms,
       instances_per_s_b128=128 * T / (forward_ms / 1e3),
       nvidia_smi=name_power)

  train = train_phase(torch, np, cfg, dev, gk, name_power)
  emit('train', **train)

  evals = eval_phase(torch, cfg, gk)
  emit('eval', nvidia_smi=name_power, **evals)

  table = []
  for name, c in checks.items():
    table.append({
        'name': name, 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES[name], 'use': 'forward',
        'launches': (launches[name] + train['forward_launches'][name]
                     + evals['launches'][name]),
        'launches_by_path': {'serve': launches[name],
                             'train': train['forward_launches'][name],
                             'eval': evals['launches'][name]},
        'max_abs_err': max(c['max_abs_err'], c['ragged']['max_abs_err']),
        'ms': c['kernel_ms'], 'plain_ms': c['plain_ms'],
        'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
        'bound_share': c['bound_share'], 'library_ms': c['library_ms'],
        **({'kernel_route': c['route']} if 'route' in c else {}),
        **{f'b{b}': {k: c[f'b{b}'][k] for k in (
            'kernel_ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
            'bound_share', 'route') if k in c[f'b{b}']} for b in (8, 1)}})
  # The kernels' backward uses that the main paths run: extract as d_p of
  # paste (paste as d_x of extract is not on them: the flagship's glimpse
  # input needs no gradient; kernels_grad checks and times it).
  for fn_name, c in grad_checks.items():
    use = c['backward_use']
    name = use['kernel']
    launched = train['backward_launches'][name]
    if not launched:
      continue
    table.append({
        'name': name, 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES[name], 'use': BACKWARD_USES[name],
        'launches': launched, 'launches_by_path': {'train': launched},
        'max_abs_err': max(c['d_operand']['max_abs_err'],
                           c['ragged']['d_operand']['max_abs_err']),
        'ms': use['kernel_ms'], 'plain_ms': use['plain_ms'],
        'bound_ms': use['bound_ms'], 'bound_by': use['bound_by'],
        'bound_share': use['bound_share'], 'library_ms': use['library_ms'],
        **({'kernel_route': use['route']} if 'route' in use else {})})
  emit('done', seconds=time.time() - start)
  print(json.dumps({'kernels': table}), flush=True)
  print(name_power, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)


if __name__ == '__main__':
  main()
