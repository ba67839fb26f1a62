"""The port's PNG codec (``rec_attend_tpu_torch/utils/png.py``) and uint8
resize (``utils/image.py``) against cv2, which is here only the reference
(PIL writes some of the files: palettes at 1, 2, 4 and 8 bits, 1-bit gray,
gray with alpha).

1. Decode equals ``cv2.imdecode`` for IMREAD_UNCHANGED, IMREAD_COLOR and
   IMREAD_GRAYSCALE, exactly (dtype, shape and values): every colour type
   and bit depth, palettes with and without tRNS, RGB and gray with tRNS,
   each of the five row filters forced on every row, files written by cv2
   (libpng's own filter choices) and by PIL, shapes from hypothesis.
2. The port's encode decodes in cv2 to the array it was given.
3. ``resize_u8`` equals ``cv2.resize`` with INTER_NEAREST bit for bit, at
   the CVPPP (530x500 -> 224x224) and KITTI (375x1242 -> 448x128)
   downscales, at an upscale and at a 2x downscale.  INTER_CUBIC: this cv2
   resizes uint8 through IPP, whose arithmetic is not published; the port
   sums in double precision and rounds once, and the two differ by one
   level where the exact value lies within about 2e-5 of a half: 13 of
   the 451,584 values of three 530x500 colour images and three smoothed
   ones, 3 of the 516,096 of the KITTI size, pinned below (the JAX
   package's files hold cv2's, so the port's x differs there by 1/255 in
   those values).  None at the 2x downscale or the 48 -> 64 upscale.
4. What the codec does not read raises ``PNGFormatError``, naming the file
   and the feature; ``chip_smoke.py``'s codec gate passes and its control
   (Paeth read as Up) fails.
"""

import io
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st
from PIL import Image

from rec_attend_tpu_torch.utils import png
from rec_attend_tpu_torch.utils.image import resize_u8

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402

FLAGS = (png.IMREAD_UNCHANGED, png.IMREAD_COLOR, png.IMREAD_GRAYSCALE)
assert FLAGS == (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR,
                 cv2.IMREAD_GRAYSCALE)


def _same_as_cv2(blob):
  blob = np.frombuffer(bytes(blob), np.uint8)
  for flags in FLAGS:
    want = cv2.imdecode(blob, flags)
    got = png.decode(blob, flags)
    assert got.dtype == want.dtype and got.shape == want.shape, flags
    np.testing.assert_array_equal(got, want, err_msg=str(flags))


def _pil(img, **kw):
  out = io.BytesIO()
  img.save(out, 'PNG', **kw)
  return out.getvalue()


@pytest.mark.parametrize('colour_type,depth', [
    (t, d) for t, depths in png.DEPTHS.items() for d in depths])
@pytest.mark.parametrize('filter_type', [0, 1, 2, 3, 4, None])
def test_every_colour_type_depth_and_filter_decodes_as_cv2(
    colour_type, depth, filter_type):
  rng = np.random.RandomState(colour_type * 100 + depth)
  n = png.CHANNELS[colour_type]
  s = rng.randint(0, 1 << depth, (13, 27, n)).astype(
      np.uint16 if depth == 16 else np.uint8)
  palettes = [None]
  if colour_type == 3:
    pal = rng.randint(0, 256, (1 << depth, 3)).astype(np.uint8)
    palettes = [(pal, None), (pal, bytes(rng.randint(
        0, 256, max(1, len(pal) // 2)).astype(np.uint8)))]
  for entry in palettes:
    pal, trns = entry if entry else (None, None)
    _same_as_cv2(png.encode_samples(s, colour_type, depth, palette=pal,
                                    trns=trns, filter_type=filter_type))


def test_files_that_cv2_writes_decode_as_cv2():
  rng = np.random.RandomState(0)
  for shape in ((1, 1), (5, 9), (64, 3), (17, 33, 3), (17, 33, 4),
                (40, 41, 1)):
    for dtype in (np.uint8, np.uint16):
      a = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
      # Smooth halves too, so that libpng picks every filter.
      a[: shape[0] // 2] = np.sort(a[: shape[0] // 2], axis=1)
      _same_as_cv2(cv2.imencode('.png', a)[1])


@pytest.mark.parametrize('bits', [1, 2, 4, 8])
def test_palette_files_that_pil_writes_decode_as_cv2(bits):
  rng = np.random.RandomState(bits)
  n = min(1 << bits, 200)
  img = Image.fromarray(rng.randint(0, n, (23, 31)).astype(np.uint8), 'P')
  img.putpalette(list(rng.randint(0, 256, 3 * n)))
  _same_as_cv2(_pil(img, bits=bits))
  img.info['transparency'] = bytes(rng.randint(0, 256, n // 2 + 1).astype(
      np.uint8))
  _same_as_cv2(_pil(img, bits=bits))


def test_other_files_that_pil_writes_decode_as_cv2():
  rng = np.random.RandomState(1)
  _same_as_cv2(_pil(Image.fromarray(rng.rand(9, 30) > 0.5)))       # 1 bit
  _same_as_cv2(_pil(Image.fromarray(
      rng.randint(0, 256, (9, 30, 2)).astype(np.uint8), 'LA')))
  rgb = rng.randint(0, 4, (9, 30, 3)).astype(np.uint8)
  _same_as_cv2(_pil(Image.fromarray(rgb, 'RGB'), transparency=(1, 2, 3)))
  _same_as_cv2(_pil(Image.fromarray(rgb[..., 0], 'L'), transparency=2))
  _same_as_cv2(_pil(Image.fromarray(
      rng.randint(0, 65536, (9, 30)).astype(np.uint16))))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       channels=st.sampled_from([None, 1, 3, 4]),
       filter_type=st.sampled_from([None, 0, 1, 2, 3, 4]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_encode_decodes_in_cv2_to_the_array(h, w, channels, filter_type,
                                            seed):
  rng = np.random.RandomState(seed)
  shape = (h, w) if channels is None else (h, w, channels)
  a = rng.randint(0, 256, shape).astype(np.uint8)
  blob = png.encode(a, filter_type=filter_type)
  want = a[..., 0] if channels == 1 else a
  np.testing.assert_array_equal(cv2.imdecode(blob, cv2.IMREAD_UNCHANGED),
                                want)
  np.testing.assert_array_equal(png.decode(blob, png.IMREAD_UNCHANGED), want)
  _same_as_cv2(blob)


def test_imread_reads_files_as_cv2(tmp_path):
  rng = np.random.RandomState(2)
  a = rng.randint(0, 256, (30, 20, 3)).astype(np.uint8)
  path = str(tmp_path / 'a.png')
  cv2.imwrite(path, a)
  np.testing.assert_array_equal(png.imread(path), cv2.imread(path))
  png.imwrite(str(tmp_path / 'b.png'), a)
  np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'b.png')), a)
  with pytest.raises(FileNotFoundError):
    png.imread(str(tmp_path / 'missing.png'))


def test_bgr_order_is_cv2s():
  """An RGB file decodes to BGR: the channel order the models learnt."""
  rgb = np.zeros((2, 2, 3), np.uint8)
  rgb[..., 0] = 255                                   # red in the file
  blob = png.encode_samples(rgb, 2)
  assert png.decode(blob)[0, 0].tolist() == [0, 0, 255]
  assert cv2.imdecode(blob, cv2.IMREAD_COLOR)[0, 0].tolist() == [0, 0, 255]


RESIZES = [((530, 500, 3), (224, 224)), ((375, 1242, 3), (448, 128)),
           ((48, 48, 3), (64, 64)), ((30, 41, 3), (97, 53)),
           ((530, 500), (224, 224)), ((64, 64, 3), (32, 32))]


@pytest.mark.parametrize('shape,size', RESIZES)
def test_nearest_resize_is_cv2s(shape, size):
  rng = np.random.RandomState(3)
  for a in (rng.randint(0, 256, shape).astype(np.uint8),
            (rng.rand(*shape[:2]) > 0.7).astype(np.uint8),
            rng.rand(*shape[:2])):
    np.testing.assert_array_equal(
        resize_u8(a, size, 'nearest'),
        cv2.resize(a, size, interpolation=cv2.INTER_NEAREST))


# (shape, size): the values of three noise images (seeds 0-2) and of the
# same smoothed that differ from cv2's INTER_CUBIC, each by one level (see
# the module's docstring).
CUBIC_RESIDUALS = {((530, 500, 3), (224, 224)): (4, 9),
                   ((375, 1242, 3), (448, 128)): (1, 2),
                   ((48, 48, 3), (64, 64)): (0, 0),
                   ((30, 41, 3), (97, 53)): (0, 1),
                   ((530, 500), (224, 224)): (3, 1),
                   ((64, 64, 3), (32, 32)): (0, 0)}


@pytest.mark.parametrize('shape,size', RESIZES)
def test_cubic_resize_is_cv2s_but_for_a_pinned_residual(shape, size):
  differ = [0, 0]
  for seed in range(3):
    a = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    for i, img in enumerate((a, cv2.GaussianBlur(a, (0, 0), 2))):
      got = resize_u8(img, size, 'cubic').astype(int)
      want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC).astype(int)
      assert got.shape == want.shape
      assert np.abs(got - want).max() <= 1
      differ[i] += int((got != want).sum())
  assert tuple(differ) == CUBIC_RESIDUALS[shape, size]


def _chunk(kind, body):
  return (struct.pack('>I', len(body)) + kind + body
          + struct.pack('>I', zlib.crc32(kind + body)))


def _raises(blob, feature, flags=png.IMREAD_UNCHANGED):
  with pytest.raises(png.PNGFormatError) as e:
    png.decode(blob, flags, path='x.png')
  assert 'x.png' in str(e.value) and feature in str(e.value)


def test_what_the_codec_does_not_read_raises():
  good = png.encode(np.zeros((4, 5, 3), np.uint8)).tobytes()
  ihdr = struct.pack('>IIBBBBB', 5, 4, 8, 2, 0, 0, 1)     # Adam7
  interlaced = good[:8] + _chunk(b'IHDR', ihdr) + good[33:]
  _raises(interlaced, 'Adam7')
  _raises(b'GIF89a' + good[6:], 'signature')
  _raises(good[:20] + bytes([good[20] ^ 1]) + good[21:], 'CRC')
  _raises(good[:-12], 'IEND')
  _raises(good[:33] + _chunk(b'ABCD', b'') + good[33:], 'critical')
  pal = png.encode_samples(np.full((2, 2), 3, np.uint8), 3, 8,
                           palette=np.zeros((2, 3), np.uint8))
  _raises(pal, 'palette index')
  gray = struct.pack('>IIBBBBB', 2, 2, 8, 0, 0, 0, 0)
  bad_filter = (good[:8] + _chunk(b'IHDR', gray) + _chunk(
      b'IDAT', zlib.compress(b'\x00\x01\x02\x05\x03\x04'))
      + _chunk(b'IEND', b''))
  _raises(bad_filter, 'the filter type 5 (row 1)')
  gamma = good[:33] + _chunk(b'gAMA', struct.pack('>I', 45455)) + good[33:]
  _raises(gamma, 'gamma', png.IMREAD_GRAYSCALE)
  np.testing.assert_array_equal(png.decode(gamma), cv2.imdecode(
      np.frombuffer(gamma, np.uint8), cv2.IMREAD_COLOR))
  with pytest.raises(png.PNGFormatError, match='float32'):
    png.encode(np.zeros((2, 2), np.float32))
  with pytest.raises(png.PNGFormatError, match='shape'):
    png.encode(np.zeros((2, 2, 2), np.uint8))


def test_chip_smoke_codec_gate_on_cpu():
  failures, control = cs.png_round_trips()
  assert failures == [] and control


def test_the_host_unfilter_routine_is_the_built_library():
  """Every row, whatever its filter, goes to csrc/png_filter.cc, built
  like the Hungarian library into rec_attend_tpu_torch/_build/."""
  from rec_attend_tpu_torch.ops.cuda import build
  path = build.build(('png_filter',))['png_filter']
  assert os.path.exists(path) and path.startswith(build.BUILD_DIR)
  a = np.random.RandomState(4).randint(0, 256, (6, 7, 3)).astype(np.uint8)
  for f in png.FILTERS:
    np.testing.assert_array_equal(png.decode(png.encode(a, filter_type=f)),
                                  a)
