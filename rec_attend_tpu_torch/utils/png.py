"""Read and write PNG images without cv2: zlib, numpy and a host routine.

The port's stand-in for ``cv2.imdecode``, ``cv2.imencode`` and
``cv2.imread`` where the JAX package's datasets use them
(``rec_attend_tpu/data/assembler.py:31-35``, the assemblers'
``cv2.imread``): the card's machine has no cv2.  ``decode`` returns what
cv2 (on libpng) returns for the three flags the JAX package passes:

  IMREAD_UNCHANGED (-1)  the samples as stored: gray [H,W], colour [H,W,3]
                         in BGR order, BGRA [H,W,4] where the file has an
                         alpha channel or a tRNS chunk on a colour or
                         palette image; uint16 for 16-bit files, gray
                         1/2/4-bit samples scaled to 8 bits;
  IMREAD_COLOR (1)       [H,W,3] uint8 BGR: gray replicated, palettes
                         expanded, alpha dropped, 16-bit samples cut to
                         their high byte;
  IMREAD_GRAYSCALE (0)   [H,W] uint8: colour samples weighed as libpng's
                         ``png_set_rgb_to_gray(0.299, 0.587)`` does
                         (fixed point, truncated; at 16 bits rounded and
                         then cut to the high byte).

BGR is the order the committed models were trained on: a decoder that
returns RGB trains on swapped channels and still passes every shape check.

The five row filters are undone by ``csrc/png_filter.cc`` (built by
``ops/cuda/build.py`` with the host compiler): Average and Paeth run in
sequence along each row, and an image may mix all five.  ``encode`` writes
8-bit gray, BGR and BGRA arrays (colour types 0, 2 and 6), each row with
the filter that libpng's heuristic would pick (the least sum of absolute
signed bytes) or the one asked for; ``encode_samples`` writes raw samples
of any colour type and bit depth (palette images among them).

Anything else raises ``PNGFormatError`` naming the file and the feature:
Adam7 interlacing, an unknown critical chunk, a bad CRC or signature, a
palette index past the palette, a grey conversion of a colour image that
carries gamma (gAMA, sRGB or iCCP), a 16-bit palette.  There is no
fallback to cv2 or PIL.

    img = png.imread('plant001_rgb.png')            # [H,W,3] BGR uint8
    seg = png.decode(blob, png.IMREAD_GRAYSCALE)    # a blob of an H5 file
    blob = png.encode(mask)                         # uint8 array of bytes
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1
SIGNATURE = b'\x89PNG\r\n\x1a\n'
# Colour types: samples per pixel.
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# libpng's png_set_rgb_to_gray_fixed(29900, 58700) coefficients in 1/32768
# (x * 32768 / 100000, truncated); blue takes the rest.
GRAY_RED, GRAY_GREEN = 29900 * 32768 // 100000, 58700 * 32768 // 100000
GRAY_BLUE = 32768 - GRAY_RED - GRAY_GREEN
FILTERS = ('none', 'sub', 'up', 'average', 'paeth')


class PNGFormatError(ValueError):
  """A PNG file, or a part of it, that this codec does not read or write."""

  def __init__(self, path, feature):
    super().__init__(f'{path}: {feature} is not supported by the port\'s '
                     'PNG codec (rec_attend_tpu_torch/utils/png.py)')
    self.path, self.feature = path, feature


# ---- decoding ---------------------------------------------------------

def _chunks(data, path):
  """{'IHDR': body, 'PLTE': body, 'tRNS': body, 'IDAT': joined bodies,
  'gamma': whether gAMA, sRGB or iCCP is present}."""
  if data[:8] != SIGNATURE:
    raise PNGFormatError(path, 'a file without the PNG signature')
  out = {'IDAT': [], 'gamma': False}
  p = 8
  while True:
    if p + 8 > len(data):
      raise PNGFormatError(path, 'a file that ends before its IEND chunk')
    n, kind = struct.unpack('>I4s', data[p:p + 8])
    body = data[p + 8:p + 8 + n]
    crc = data[p + 8 + n:p + 12 + n]
    if len(body) != n or len(crc) != 4:
      raise PNGFormatError(path, f'a truncated {kind!r} chunk')
    critical = not kind[0] & 0x20
    if critical and zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
      raise PNGFormatError(path, f'a bad CRC in the {kind!r} chunk')
    p += 12 + n
    if kind == b'IEND':
      break
    if kind == b'IDAT':
      out['IDAT'].append(body)
    elif kind in (b'IHDR', b'PLTE', b'tRNS'):
      out[kind.decode()] = body
    elif kind in (b'gAMA', b'sRGB', b'iCCP'):
      out['gamma'] = True
    elif critical:
      raise PNGFormatError(path, f'the critical chunk {kind!r}')
  if 'IHDR' not in out or not out['IDAT']:
    raise PNGFormatError(path, 'a file without IHDR or IDAT')
  out['IDAT'] = b''.join(out['IDAT'])
  return out


def _unfilter(raw, height, rowbytes, bpp, path):
  """[height, rowbytes] uint8 of the decompressed stream ``raw``."""
  rows = np.frombuffer(raw, np.uint8)
  if rows.size < height * (rowbytes + 1):
    raise PNGFormatError(path, f'image data of {rows.size} bytes for '
                         f'{height} rows of {rowbytes}')
  rows = np.ascontiguousarray(
      rows[:height * (rowbytes + 1)].reshape(height, rowbytes + 1))
  from rec_attend_tpu_torch.ops.cuda import build
  out = np.empty((height, rowbytes), np.uint8)
  err = build.load_png_filter().png_unfilter(
      rows.ctypes.data, height, rowbytes, bpp, out.ctypes.data)
  if err:
    raise PNGFormatError(path, f'the filter type {rows[err - 1, 0]} (row '
                         f'{err - 1})')
  return out


def _samples(rows, width, depth, channels):
  """[H, W, channels] samples (uint8, or uint16 at 16 bits) of unfiltered
  rows."""
  h = rows.shape[0]
  if depth == 8:
    return rows[:, :width * channels].reshape(h, width, channels)
  if depth == 16:
    return (rows[:, :width * channels * 2].view('>u2').astype(np.uint16)
            .reshape(h, width, channels))
  per = 8 // depth
  shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
  s = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
  return s.reshape(h, -1)[:, :width].reshape(h, width, 1)


def _to_gray(rgb, path, gamma):
  """libpng's rgb_to_gray without gamma: [H,W,3] RGB -> [H,W]."""
  if gamma:
    raise PNGFormatError(path, 'a grey conversion of a colour image with '
                         'gamma or colour-space chunks')
  r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
  s = GRAY_RED * r + GRAY_GREEN * g + GRAY_BLUE * b
  if rgb.dtype == np.uint16:
    return ((s + 16384) >> 15).astype(np.uint16)
  return (s >> 15).astype(np.uint8)


def _strip16(a):
  return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


def decode(buf, flags=IMREAD_COLOR, path='<buffer>'):
  """Decode the PNG bytes ``buf`` (bytes or a uint8 array) as cv2.imdecode
  does with ``flags`` (IMREAD_UNCHANGED, IMREAD_COLOR or
  IMREAD_GRAYSCALE)."""
  if flags not in (IMREAD_UNCHANGED, IMREAD_COLOR, IMREAD_GRAYSCALE):
    raise PNGFormatError(path, f'the imread flags {flags}')
  data = buf if isinstance(buf, bytes) else np.asarray(buf, np.uint8).tobytes()
  ch = _chunks(data, path)
  width, height, depth, ctype, comp, filt, interlace = struct.unpack(
      '>IIBBBBB', ch['IHDR'][:13])
  if ctype not in CHANNELS or depth not in DEPTHS[ctype]:
    raise PNGFormatError(path, f'colour type {ctype} at bit depth {depth}')
  if comp or filt:
    raise PNGFormatError(path, f'compression method {comp}, filter method '
                         f'{filt}')
  if interlace:
    raise PNGFormatError(path, 'Adam7 interlacing')
  if not width or not height:
    raise PNGFormatError(path, f'an image of {width}x{height}')
  channels = CHANNELS[ctype]
  rowbytes = (width * channels * depth + 7) // 8
  bpp = max(1, channels * depth // 8)
  try:
    raw = zlib.decompress(ch['IDAT'])
  except zlib.error as e:
    raise PNGFormatError(path, f'image data zlib cannot inflate ({e})')
  s = _samples(_unfilter(raw, height, rowbytes, bpp, path), width, depth,
               channels)
  trns = ch.get('tRNS')

  if ctype == 3:
    plte = np.frombuffer(ch.get('PLTE', b''), np.uint8)
    if plte.size == 0 or plte.size % 3:
      raise PNGFormatError(path, 'a palette image without a valid PLTE')
    plte = plte.reshape(-1, 3)
    idx = s[..., 0]
    if idx.max() >= len(plte):
      raise PNGFormatError(path, f'the palette index {idx.max()} of a '
                           f'palette of {len(plte)}')
    rgb = plte[idx]
    if flags == IMREAD_GRAYSCALE:
      return _to_gray(rgb, path, ch['gamma'])
    if flags == IMREAD_UNCHANGED and trns:
      alpha = np.full(len(plte), 255, np.uint8)
      t = np.frombuffer(trns, np.uint8)[:len(plte)]
      alpha[:len(t)] = t
      return np.ascontiguousarray(np.concatenate(
          [rgb[..., ::-1], alpha[idx][..., None]], axis=2))
    return np.ascontiguousarray(rgb[..., ::-1])

  if ctype == 0 and depth < 8:
    s = s * np.uint8(255 // ((1 << depth) - 1))
  if ctype in (0, 4):
    gray = s[..., 0]
    if flags == IMREAD_GRAYSCALE:
      return np.ascontiguousarray(_strip16(gray))
    if flags == IMREAD_COLOR:
      return np.ascontiguousarray(np.repeat(_strip16(gray)[..., None], 3,
                                            axis=2))
    if ctype == 0:
      return np.ascontiguousarray(gray)
    return np.ascontiguousarray(s[..., [0, 0, 0, 1]])

  rgb = s[..., :3]
  if flags == IMREAD_GRAYSCALE:
    return _strip16(_to_gray(rgb, path, ch['gamma']))
  if flags == IMREAD_COLOR:
    return np.ascontiguousarray(_strip16(rgb[..., ::-1]))
  if ctype == 6:
    return np.ascontiguousarray(s[..., [2, 1, 0, 3]])
  if trns:
    if len(trns) < 6:
      raise PNGFormatError(path, 'a tRNS chunk of the wrong size')
    key = np.array(struct.unpack('>3H', trns[:6]), np.uint16)
    if depth == 8:
      key = key.astype(np.uint8)
    opaque = np.iinfo(rgb.dtype).max
    alpha = np.where((rgb == key).all(axis=2), 0, opaque).astype(rgb.dtype)
    return np.ascontiguousarray(np.concatenate(
        [rgb[..., ::-1], alpha[..., None]], axis=2))
  return np.ascontiguousarray(rgb[..., ::-1])


def imread(path, flags=IMREAD_COLOR):
  """``cv2.imread``: the image in the PNG file at ``path``, decoded with
  ``flags``; a missing file raises FileNotFoundError (cv2 returns None,
  which every caller in the JAX package turns into that error)."""
  with open(path, 'rb') as f:
    return decode(f.read(), flags, path=str(path))


# ---- encoding ---------------------------------------------------------

def _filtered(raw, bpp):
  """[5, H, rowbytes] uint8: every row under each of the five filters."""
  x = raw.astype(np.int16)
  a = np.zeros_like(x)
  a[:, bpp:] = x[:, :-bpp]
  b = np.zeros_like(x)
  b[1:] = x[:-1]
  c = np.zeros_like(x)
  c[1:, bpp:] = x[:-1, :-bpp]
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
  return np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - pred]).astype(
      np.uint8)


def _pack_bits(samples, depth):
  """[H, W] samples of 1, 2 or 4 bits -> [H, rowbytes] bytes, the first
  sample in the high bits."""
  h, w = samples.shape
  per = 8 // depth
  padded = np.zeros((h, -(-w // per) * per), np.uint8)
  padded[:, :w] = samples
  shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
  return (padded.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint8)


def encode_samples(samples, colour_type, bit_depth=8, palette=None,
                   trns=None, filter_type=None, level=1):
  """PNG bytes (a 1-d uint8 array) of raw samples in the file's own order:
  [H, W] or [H, W, channels] of colour type 0 (gray), 2 (RGB), 3 (palette
  indices, with ``palette`` [N, 3] RGB), 4 (gray and alpha) or 6 (RGBA),
  at ``bit_depth`` (uint16 samples at 16); ``trns`` the tRNS chunk's bytes.
  ``filter_type``: None picks each row's filter as libpng's heuristic does
  (the least sum of absolute signed bytes); a name of ``FILTERS`` or a
  filter number forces it on every row, a sequence of them gives each
  row's.  ``level``: the zlib level (cv2's default is 1)."""
  s = np.asarray(samples)
  if colour_type not in CHANNELS or bit_depth not in DEPTHS[colour_type]:
    raise PNGFormatError('<array>', f'colour type {colour_type} at bit '
                         f'depth {bit_depth}')
  n = CHANNELS[colour_type]
  s = s.reshape(s.shape[0], s.shape[1], -1) if s.ndim >= 2 else s
  if s.ndim != 3 or s.shape[2] != n or not s.shape[0] or not s.shape[1]:
    raise PNGFormatError('<array>', f'encoding samples of shape {s.shape} '
                         f'as colour type {colour_type}')
  h, w, _ = s.shape
  if bit_depth < 8:
    raw = _pack_bits(s[..., 0].astype(np.uint8), bit_depth)
  elif bit_depth == 16:
    raw = s.astype('>u2').reshape(h, -1).view(np.uint8)
  else:
    raw = s.astype(np.uint8).reshape(h, w * n)
  bpp = max(1, n * bit_depth // 8)
  cand = _filtered(raw, bpp)
  if filter_type is None:
    # |byte as int8|: the byte or its negation modulo 256, the smaller.
    cost = np.minimum(cand, -cand).sum(axis=2, dtype=np.int64)
    cost[0] = raw.sum(axis=1, dtype=np.int64)    # None: the bytes unsigned
    types = np.argmin(cost, axis=0)
  else:
    spec = ([filter_type] if isinstance(filter_type, (str, int))
            else list(filter_type))
    types = np.array([FILTERS.index(t) if isinstance(t, str) else int(t)
                      for t in spec])
    types = np.broadcast_to(types, (h,)) if len(types) == 1 else types
    if types.shape != (h,) or types.min() < 0 or types.max() > 4:
      raise PNGFormatError('<array>', f'the row filters {filter_type!r}')
  rows = cand[types, np.arange(h)]
  stream = np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)

  def chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))

  out = SIGNATURE + chunk(b'IHDR', struct.pack(
      '>IIBBBBB', w, h, bit_depth, colour_type, 0, 0, 0))
  if palette is not None:
    out += chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
  if trns is not None:
    out += chunk(b'tRNS', bytes(trns))
  out += (chunk(b'IDAT', zlib.compress(stream.tobytes(), level))
          + chunk(b'IEND', b''))
  return np.frombuffer(out, np.uint8)


def encode(img, filter_type=None, level=1):
  """PNG bytes (a 1-d uint8 array, as ``cv2.imencode('.png', img)[1]``)
  of an 8-bit [H,W] or [H,W,1] gray, [H,W,3] BGR or [H,W,4] BGRA array, that
  cv2 decodes with IMREAD_UNCHANGED to the same array.  ``filter_type``
  and ``level`` as ``encode_samples`` takes them."""
  img = np.asarray(img)
  if img.dtype != np.uint8:
    raise PNGFormatError('<array>', f'encoding {img.dtype} data')
  if img.ndim == 3 and img.shape[2] == 1:
    img = img[..., 0]
  if img.ndim == 2:
    return encode_samples(img, 0, filter_type=filter_type, level=level)
  if img.ndim == 3 and img.shape[2] in (3, 4):
    order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
    return encode_samples(img[..., order], 2 if img.shape[2] == 3 else 6,
                          filter_type=filter_type, level=level)
  raise PNGFormatError('<array>', f'encoding an array of shape {img.shape}')


def imwrite(path, img, **kw):
  """``cv2.imwrite`` of a PNG file: ``encode(img, **kw)`` written to
  ``path``."""
  with open(path, 'wb') as f:
    f.write(encode(img, **kw).tobytes())
