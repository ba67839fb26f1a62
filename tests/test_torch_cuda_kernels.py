"""The hand-written kernels on the card (the glimpse kernels and the
Hungarian solver), against their plain versions.  Marked ``cuda``; they
skip where there is no card.  On the machine with the card (which has no
JAX, so without the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-4 / atol 1e-5, those of tests/test_pallas_glimpse.py
(both float32; the kernel sums in another order than cuBLAS).  Gradients
(the Functions' backward, whose operand gradient is the other kernel,
against plain autograd through the einsums): rtol 1e-3 / atol 1e-4 times
max(1, the gradient's largest magnitude), the gradient tolerance of
ROADMAP B.  The Hungarian kernel: the same bits as its plain version.
"""

import pytest
import torch

from rec_attend_tpu_torch.ops import attention
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5

# (B, H, W, D, FH, FW): CVPPP, KITTI with its 13 packed channels and a
# 48x64 glimpse, Cityscapes with 21, odd sizes everywhere, one channel wider
# than a W strip is long, and the widest channel count the kernel takes.
SHAPES = [(4, 224, 224, 4, 48, 48), (2, 128, 448, 13, 48, 64),
          (1, 256, 512, 21, 48, 48), (3, 33, 45, 3, 7, 9),
          (2, 17, 300, 1, 5, 70), (1, 40, 50, 128, 20, 12)]
# The paste kernel's tile edges: a thread computes TM rows (7 or 2; 1 at
# D=4) x 4 columns, a block NTY*TM rows of whole 4*NTX-column passes (NTX <= 64
# column quads); one row past and one short of a row tile and of a 256-
# column pass, W*D not a multiple of 4 (no 16-byte stores: 257, 255, 43),
# D=4 (4 channels a thread), B=1 and B=8 at 224x224 D=1 (the serving
# path's smallest requests, two rows a thread), extract's d_x shape of
# the train step (b32, D=4), and three whose staged filters only fit in
# shared memory as narrower passes, column tiles or fewer rows a block.
PASTE_SHAPES = SHAPES + [
    (1, 33, 257, 1, 48, 48), (1, 31, 255, 1, 48, 48),
    (2, 65, 64, 4, 48, 48), (2, 63, 63, 4, 48, 48), (2, 40, 43, 1, 12, 10),
    (1, 224, 224, 1, 48, 48), (8, 224, 224, 1, 48, 48),
    (32, 224, 224, 4, 48, 48),
    (1, 40, 224, 1, 48, 200), (1, 16, 1100, 1, 8, 48),
    (2, 300, 16, 1, 1500, 8)]
# Inputs 4 bytes past a 16-byte boundary (a contiguous view with a storage
# offset): the kernel then copies them 4 bytes at a time, takes one channel
# a pass at any D and stores scalars.
UNALIGNED = [((8, 224, 224, 1, 48, 48), 'p'), ((8, 224, 224, 1, 48, 48), 'f_x'),
             ((32, 224, 224, 4, 48, 48), 'p'),
             ((32, 224, 224, 4, 48, 48), 'f_x'),
             ((3, 33, 45, 3, 7, 9), 'f_y')]

# Extract has three routes, picked by the shape and the pointers' alignment.
# The tiled route takes a 224x224 image, a 48x48 glimpse, D = 1 or 4 and
# 16-byte aligned pointers, at any B (output rows a block: 48 from 96 images
# on, 12 from 24, else 4).  The strip route takes the other 48x48 glimpses
# with D <= 32 and W*D a multiple of 4, aligned, at any H and W (output rows
# a block: 12, or 8 at D > 21).  The general route takes every other shape.
# So: the tiled route at B = 1, 8, 32, 128 (D=4) and 1, 8, 32 (D=1), each
# FT at both D; one change away from it (H or W 223 or 225, FH or FW 47 or
# 49, D = 2 or 3), which the strip route takes where the glimpse stays
# 48x48 and W*D a multiple of 4; and inputs 4 bytes past a 16-byte boundary,
# x, f_y and f_x in turn.
TILED = [(1, 224, 224, 4, 48, 48), (8, 224, 224, 4, 48, 48),
         (32, 224, 224, 4, 48, 48), (128, 224, 224, 4, 48, 48),
         (1, 224, 224, 1, 48, 48), (8, 224, 224, 1, 48, 48),
         (32, 224, 224, 1, 48, 48)]
OFF_TILED_STRIP = [(4, 223, 224, 4, 48, 48), (4, 225, 224, 4, 48, 48),
                   (4, 224, 223, 4, 48, 48), (4, 224, 224, 2, 48, 48),
                   (4, 224, 224, 3, 48, 48)]
OFF_TILED_GENERAL = [(4, 224, 225, 1, 48, 48), (4, 224, 224, 4, 47, 48),
                     (4, 224, 224, 1, 49, 48), (4, 224, 224, 4, 48, 47),
                     (4, 224, 224, 4, 48, 49)]
OFF_TILED = OFF_TILED_STRIP + OFF_TILED_GENERAL
# The strip route at the edges of its tiles: the instance changes at D = 4,
# 15 and 22 (D = 1, 2, 3, 5, 13, 14, 21, 22, 32 here); a strip holds 1024
# floats of a row (256 at D <= 3) and a chunk 8 rows of it (32 at D <= 3),
# so H and W*D that are not multiples of them, rows shorter than one strip,
# strips of one or two chunks (H = 4, 5, 9) and strips that end on a whole
# column (W*D = 5200, 14000); B = 1, 2 and 32 (the synth3 chain's and
# Cityscapes' b32 forwards, paste's d_p at the KITTI size).
STRIP = [(1, 17, 100, 13, 48, 48), (2, 9, 400, 13, 48, 48),
         (2, 4, 8, 13, 48, 48),
         (1, 5, 1000, 14, 48, 48), (2, 33, 52, 21, 48, 48),
         (1, 30, 50, 22, 48, 48), (1, 20, 45, 32, 48, 48),
         (2, 130, 300, 1, 48, 48), (1, 9, 202, 2, 48, 48),
         (2, 40, 100, 3, 48, 48), (1, 25, 120, 5, 48, 48),
         (32, 128, 448, 13, 48, 48), (32, 256, 512, 21, 48, 48),
         (32, 128, 448, 1, 48, 48)]
EXTRACT_SHAPES = SHAPES + TILED + OFF_TILED + STRIP
EXTRACT_UNALIGNED = [((8, 224, 224, 4, 48, 48), 'x'),
                     ((8, 224, 224, 4, 48, 48), 'f_y'),
                     ((32, 224, 224, 1, 48, 48), 'f_x'),
                     ((2, 128, 448, 13, 48, 48), 'x'),
                     ((2, 128, 448, 1, 48, 48), 'f_x')]


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


def _inputs(shape, dev, seed=0):
  b, h, w, d, fh, fw = shape
  g = torch.Generator(device=dev).manual_seed(seed)

  def bank(length, taps):
    ctr = torch.rand(b, generator=g, device=dev) * length
    size = 4 + torch.rand(b, generator=g, device=dev) * length
    return attention.get_gaussian_filter(ctr, size, torch.log(size / taps),
                                         length, taps)
  return (torch.rand((b, h, w, d), generator=g, device=dev),
          torch.rand((b, fh, fw, d), generator=g, device=dev),
          bank(h, fh), bank(w, fw))


@pytest.mark.parametrize(
    'shape, unaligned',
    [pytest.param(s, None, id=str(s)) for s in EXTRACT_SHAPES]
    + [pytest.param(s, name, id=f'{s}-unaligned-{name}')
       for s, name in EXTRACT_UNALIGNED])
def test_extract_kernel_matches_plain(dev, shape, unaligned):
  x, _, f_y, f_x = _inputs(shape, dev)
  if unaligned == 'x':
    x = _unaligned(x)
  elif unaligned == 'f_y':
    f_y = _unaligned(f_y)
  elif unaligned == 'f_x':
    f_x = _unaligned(f_x)
  before = gk.glimpse_extract.launches
  got = gk.glimpse_extract(x, f_y, f_x)
  torch.cuda.synchronize()
  assert gk.glimpse_extract.launches == before + 1
  want = attention.extract_patch(x, f_y, f_x)
  torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
  # The tiled and strip routes return the plain version's memory layout.
  if gk.extract_route_of(x, f_y, f_x)['kernel'] != 'extract_kernel_general':
    assert got.stride() == want.stride()


@pytest.mark.parametrize('shape', STRIP, ids=str)
def test_strip_route_is_deterministic(dev, shape):
  """No sum crosses blocks and nothing is atomic: two launches on the same
  inputs give the same bits, in the plain version's layout."""
  x, _, f_y, f_x = _inputs(shape, dev)
  assert gk.extract_route_of(x, f_y, f_x)['kernel'] == 'extract_strip_kernel'
  first = gk.glimpse_extract(x, f_y, f_x)
  second = gk.glimpse_extract(x, f_y, f_x)
  torch.cuda.synchronize()
  assert torch.equal(first, second)
  assert first.stride() == attention.extract_patch(x, f_y, f_x).stride()


def test_extract_route(dev):
  """The tiled route takes the main path's shapes, with the output rows a
  block that fill about one wave; the strip route the other 48x48 glimpses
  with D <= 32 and W*D a multiple of 4; an unaligned pointer, another
  glimpse size, D > 32 or W*D not a multiple of 4 sends a shape to the
  general route, which takes every other shape up to D = 128."""
  want_ft = {1: 4, 8: 4, 32: 12, 128: 48}
  general = {'kernel': 'extract_kernel_general'}
  for shape in TILED:
    assert gk.extract_route(*shape) == {'kernel': 'extract_tiled_kernel',
                                        'ft': want_ft[shape[0]]}, shape
    assert gk.extract_route(*shape, aligned=False) == general, shape
  for shape in STRIP + OFF_TILED_STRIP + [SHAPES[2]]:
    assert gk.extract_route(*shape) == {
        'kernel': 'extract_strip_kernel',
        'ft': 8 if shape[3] > 21 else 12}, shape
    assert gk.extract_route(*shape, aligned=False) == general, shape
  for shape in ([SHAPES[1]] + SHAPES[3:] + OFF_TILED_GENERAL
                + [(1, 32, 40, 33, 48, 48), (16, 128, 448, 13, 48, 64),
                   (1, 10, 15, 3, 48, 48), (2, 17, 301, 1, 48, 48)]):
    assert gk.extract_route(*shape) == general, shape
  with pytest.raises(ValueError, match='no kernel takes'):
    gk.extract_route(1, 32, 40, 129, 8, 8)


def _unaligned(t):
  """A copy of t that lies 4 bytes past a 16-byte boundary."""
  moved = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
  assert moved.is_contiguous() and moved.data_ptr() % 16 == 4
  return moved.copy_(t)


@pytest.mark.parametrize(
    'shape, unaligned',
    [pytest.param(s, None, id=str(s)) for s in PASTE_SHAPES]
    + [pytest.param(s, name, id=f'{s}-unaligned-{name}')
       for s, name in UNALIGNED])
def test_paste_kernel_matches_plain(dev, shape, unaligned):
  _, p, f_y, f_x = _inputs(shape, dev)
  if unaligned == 'p':
    p = _unaligned(p)
  elif unaligned == 'f_y':
    f_y = _unaligned(f_y)
  elif unaligned == 'f_x':
    f_x = _unaligned(f_x)
  before = gk.glimpse_paste.launches
  got = gk.glimpse_paste(p, f_y, f_x)
  torch.cuda.synchronize()
  assert gk.glimpse_paste.launches == before + 1
  torch.testing.assert_close(got, attention.paste_patch(p, f_y, f_x),
                             rtol=RTOL, atol=ATOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
  x, p, f_y, f_x = _inputs((2, 32, 40, 3, 8, 8), dev)
  with pytest.raises(TypeError):
    gk.glimpse_extract(x.double(), f_y.double(), f_x.double())
  strided = torch.rand(2, 32, 80, 3, device=dev)[:, :, ::2]
  with pytest.raises(ValueError, match='contiguous'):
    gk.glimpse_extract(strided, f_y, f_x)
  with pytest.raises(ValueError):
    gk.glimpse_extract(x, f_y.cpu(), f_x)
  with pytest.raises(ValueError):
    gk.glimpse_extract(torch.rand(1, 32, 40, 129, device=dev), f_y[:1],
                       f_x[:1])
  # A patch whose filter taps do not fit in shared memory, at any tiling.
  wide = torch.rand(1, 4, 20000, 1, device=dev)
  with pytest.raises(RuntimeError, match='glimpse_paste launch failed'):
    gk.glimpse_paste(wide, torch.rand(1, 8, 4, device=dev),
                     torch.rand(1, 8, 20000, device=dev))
  # An input that requires a gradient is taken: the backward launches the
  # other kernel.
  out = gk.glimpse_paste(p.requires_grad_(), f_y, f_x)
  assert out.grad_fn is not None
  with torch.no_grad():
    assert gk.glimpse_paste(p, f_y, f_x).grad_fn is None


def _grads(fn, ins, g):
  ins = [t.detach().clone().requires_grad_() for t in ins]
  return torch.autograd.grad(fn(*ins), ins, g)


def _assert_grads_close(got, want):
  for a, b in zip(got, want):
    torch.testing.assert_close(
        a, b, rtol=1e-3, atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize('shape', PASTE_SHAPES, ids=str)
def test_extract_grads_match_plain_autograd(dev, shape):
  """d_x = paste kernel (g), d_f_y and d_f_x einsums."""
  x, p, f_y, f_x = _inputs(shape, dev)
  g = torch.rand_like(p)
  before = gk.launch_counts(backward=True)
  got = _grads(gk.glimpse_extract, (x, f_y, f_x), g)
  torch.cuda.synchronize()
  after = gk.launch_counts(backward=True)
  assert after['glimpse_paste'] == before['glimpse_paste'] + 1
  _assert_grads_close(got, _grads(attention.extract_patch, (x, f_y, f_x), g))


@pytest.mark.parametrize('shape', EXTRACT_SHAPES, ids=str)
def test_paste_grads_match_plain_autograd(dev, shape):
  """d_p = extract kernel (g), d_f_y and d_f_x einsums."""
  x, p, f_y, f_x = _inputs(shape, dev)
  g = torch.rand_like(x)
  before = gk.launch_counts(backward=True)
  got = _grads(gk.glimpse_paste, (p, f_y, f_x), g)
  torch.cuda.synchronize()
  after = gk.launch_counts(backward=True)
  assert after['glimpse_extract'] == before['glimpse_extract'] + 1
  _assert_grads_close(got, _grads(attention.paste_patch, (p, f_y, f_x), g))


def test_backward_launches_only_what_is_needed(dev):
  """The flagship's case: the glimpse input needs no gradient (the canvas
  is cut), so extract's backward launches no paste; the filters still get
  theirs."""
  x, p, f_y, f_x = _inputs((4, 224, 224, 4, 48, 48), dev)
  f_y.requires_grad_()
  f_x.requires_grad_()
  gk.reset_launch_counts()
  gk.glimpse_extract(x, f_y, f_x).sum().backward()
  assert gk.launch_counts() == {'glimpse_extract': 1, 'glimpse_paste': 0}
  assert f_y.grad is not None and f_x.grad is not None
  gk.reset_launch_counts()
  gk.glimpse_paste(p, f_y.detach(), f_x.detach().requires_grad_()).sum(
  ).backward()
  assert gk.launch_counts() == {'glimpse_extract': 0, 'glimpse_paste': 1}


# ---------------------------------------------------------------------------
# The Hungarian kernel (csrc/hungarian.cu) against its plain version,
# ops/hungarian.hungarian_plain, bit for bit: the same float32 operations in
# the same order (tests/test_torch_hungarian.py holds the plain version to
# JAX's solver on the CPU).
# (B, n_x, n_y[, a column of inf]): the flagship's stacked step solve, a
# rectangular one, one problem larger than a warp (two and three entries a
# lane), one whose cost matrix needs more than 48 KB of shared memory, one
# past 128 columns (five entries a lane: the kernel's CPL = 8 instance),
# and, at two entries a lane, problems with an infinite column, whose
# arithmetic makes NaN and whose rows reach the iteration cap.
HUNGARIAN_SHAPES = [(64, 21, 21), (8, 5, 9), (3, 40, 40), (1, 70, 50),
                    (1, 120, 120), (2, 140, 131), (2, 40, 40, 1)]


def _hungarian_weights(shape, seed=0):
  """Weights as f_segm_match makes them, with 70 % zero IoU (many ties);
  a fourth entry of shape names a column made infinite."""
  g = torch.Generator().manual_seed(seed)
  iou = torch.rand(shape[:3], generator=g)
  iou[torch.rand(shape[:3], generator=g) < 0.7] = 0
  w = torch.round(iou * 1e6) / 1e6 + 1e-5
  if len(shape) > 3:
    w[:, :, shape[3]] = float('inf')
  return w


def _same_bits(got, want):
  return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
             for a, b in zip(got, want))


@pytest.mark.parametrize('shape', HUNGARIAN_SHAPES, ids=str)
def test_hungarian_kernel_matches_plain_bit_for_bit(dev, shape):
  from rec_attend_tpu_torch.ops import hungarian as H
  from rec_attend_tpu_torch.ops.cuda import hungarian as hk
  w = _hungarian_weights(shape)
  before = hk.hungarian.launches
  got = hk.hungarian(w.to(dev))
  again = hk.hungarian(w.to(dev))
  torch.cuda.synchronize()
  assert hk.hungarian.launches == before + 2
  want = H.hungarian_plain(w.to(dev))
  assert _same_bits(got, want) and _same_bits(again, want)
  # The plain version gives the same bits on the card as on the CPU.
  assert _same_bits([t.cpu() for t in want], H.hungarian_plain(w))


def test_segm_match_solves_on_the_card(dev, monkeypatch):
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops import native
  from rec_attend_tpu_torch.ops.cuda import hungarian as hk
  iou, s_gt = _hungarian_weights((8, 21, 21)), torch.ones(8, 21)
  want = matching.f_segm_match(iou, s_gt)
  monkeypatch.setattr(native, 'hungarian_native', None)
  before = hk.hungarian.launches
  got = matching.f_segm_match(iou.to(dev), s_gt.to(dev))
  assert hk.hungarian.launches == before + 1
  assert got.device.type == 'cuda' and torch.equal(got.cpu(), want)


def test_hungarian_kernel_refuses_what_it_does_not_take(dev):
  from rec_attend_tpu_torch.ops.cuda import hungarian as hk
  w = torch.rand(2, 4, 4, device=dev)
  with pytest.raises(TypeError):
    hk.hungarian(w.double())
  with pytest.raises(ValueError):
    hk.hungarian(w.transpose(1, 2))
  with pytest.raises(ValueError):
    hk.hungarian(w[0])
  n = hk.max_n()
  assert n == 240
  with pytest.raises(ValueError):
    hk.hungarian(torch.rand(1, n + 1, 2, device=dev))
