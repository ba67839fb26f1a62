"""Read and write HDF5 files of named arrays without h5py.

The port's stand-in for h5py where the JAX package uses it to write and
read ``weights.h5`` (``rec_attend_tpu/nn/params.py``): the card's machine
has no h5py.  The files are HDF5 1.8 "earliest" files: a version 0
superblock and one root group that is a symbol table (a version 1 B-tree
of any depth over symbol table nodes, the names in a local heap), holding
datasets with version 1 object headers (continuations followed, NIL and
unknown messages skipped), simple dataspaces, little-endian IEEE floats or
fixed-point integers and contiguous storage.  Anything else raises
``H5FormatError`` naming the file and the feature: chunked, compact or
filtered storage, attributes asked for, nested groups, new-style groups,
strings, big-endian data, later superblocks, object headers, dataspaces
or layouts, a user block.  There is no fallback to h5py.

    arrays = h5.read('results/box_model_synth-20260816104712/weights.h5')
    with h5.File(path) as f:          # lazy: names first, one dataset read
      if 'ctrl_cnn_w_0' in f:
        w = f['ctrl_cnn_w_0']
    h5.write(path, {'ctrl_cnn_w_0': w})

``write`` lays the file out as h5py 3.x does with ``libver='earliest'``
(the same messages a dataset, the same B-tree and heap forms), not byte for
byte: the B-tree is built full, from the sorted names.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEF = 0xffffffffffffffff
# The end of a local heap's free list (HDF5's H5HL_FREE_NULL).
HEAP_FREE_NULL = 1

# The group K values that HDF5 writes by default: a symbol table node holds
# up to 2 LEAF_K names, a B-tree node up to 2 INTERNAL_K children.
LEAF_K, INTERNAL_K = 4, 16

# Object header message types.
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL, LINK = 0, 1, 2, 3, 5, 6
LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 8, 10, 11, 12
CONTINUATION, SYMBOL_TABLE, ATTRIBUTE_INFO = 16, 17, 21

# IEEE floats by size: (bit precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias).
IEEE = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
DATATYPE_CLASSES = {0: 'fixed-point', 1: 'floating-point', 2: 'time',
                    3: 'string', 4: 'bit field', 5: 'opaque', 6: 'compound',
                    7: 'reference', 8: 'enumerated', 9: 'variable-length',
                    10: 'array'}


class H5FormatError(ValueError):
  """A file, or a part of it, that this codec does not read or write."""

  def __init__(self, path, feature):
    super().__init__(f'{path}: {feature} is not supported by the port\'s '
                     'HDF5 codec (rec_attend_tpu_torch/utils/h5.py)')
    self.path, self.feature = path, feature


def _uint(b, off, n):
  return int.from_bytes(b[off:off + n], 'little')


class File:
  """A file opened for reading: ``keys()``, ``name in f``, ``f[name]`` (a
  numpy array, read when asked for) and ``attrs(name)``."""

  def __init__(self, path):
    self.path = str(path)
    self._f = open(self.path, 'rb')
    try:
      self._entries = self._read_root()
    except Exception:
      self._f.close()
      raise

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  def close(self):
    self._f.close()

  def keys(self):
    return sorted(self._entries)

  def __contains__(self, name):
    return name in self._entries

  def __getitem__(self, name):
    if name not in self._entries:
      raise KeyError(f'{self.path}: no dataset {name!r}')
    return self._dataset(name, self._messages(self._entries[name]))

  def attrs(self, name):
    """The attributes of dataset ``name``: {} where it has none; any
    attribute raises."""
    for mtype, _, _ in self._messages(self._entries[name]):
      if mtype in (ATTRIBUTE, ATTRIBUTE_INFO):
        raise H5FormatError(self.path, f'the attributes of {name!r}')
    return {}

  # ---- low level -------------------------------------------------------

  def _err(self, feature):
    return H5FormatError(self.path, feature)

  def _read(self, addr, n):
    if addr == UNDEF:
      raise self._err('an undefined address where data is read')
    self._f.seek(self._base + addr)
    b = self._f.read(n)
    if len(b) != n:
      raise self._err(f'a truncated file ({n} bytes at {addr})')
    return b

  def _off(self, b, p):
    return _uint(b, p, self._so)

  def _len(self, b, p):
    return _uint(b, p, self._sl)

  # ---- superblock and root group ---------------------------------------

  def _read_root(self):
    b = self._f.read(24)
    if b[:8] != SIGNATURE:
      raise self._err('a file without the HDF5 signature at its start')
    if b[8] != 0:
      raise self._err(f'superblock version {b[8]}')
    self._so, self._sl = b[13], b[14]
    b = self._f.read(4 * self._so + 2 * self._so + 24)
    self._base = self._off(b, 0)
    root_header = self._off(b, 4 * self._so + self._so)
    msgs = self._messages(root_header)
    stab = [body for t, _, body in msgs if t == SYMBOL_TABLE]
    if not stab:
      if any(t in (LINK_INFO, LINK, GROUP_INFO) for t, _, _ in msgs):
        raise self._err('a new-style (link message) root group')
      raise self._err('a root group without a symbol table')
    btree, heap = self._off(stab[0], 0), self._off(stab[0], self._so)
    names = self._heap(heap)
    entries = {}
    for name_off, header in self._btree_entries(btree, 0):
      end = names.find(b'\0', name_off)
      entries[names[name_off:end].decode('utf-8')] = header
    return entries

  def _heap(self, addr):
    b = self._read(addr, 8 + 2 * self._sl + self._so)
    if b[:4] != b'HEAP' or b[4] != 0:
      raise self._err(f'a local heap of signature {b[:4]!r} version {b[4]}')
    return self._read(self._off(b, 8 + 2 * self._sl), self._len(b, 8))

  def _btree_entries(self, addr, depth):
    """The (name offset, object header address) of every symbol under the
    group B-tree node at ``addr``."""
    if depth > 64:
      raise self._err('a group B-tree deeper than 64 levels')
    b = self._read(addr, 8 + 2 * self._so)
    if b[:4] != b'TREE' or b[4] != 0:
      raise self._err(f'a B-tree node of signature {b[:4]!r} type {b[4]}')
    level, used = b[5], _uint(b, 6, 2)
    step = self._sl + self._so
    b = self._read(addr + 8 + 2 * self._so, used * step + self._sl)
    out = []
    for i in range(used):
      child = self._off(b, i * step + self._sl)
      out += (self._btree_entries(child, depth + 1) if level > 0
              else self._snod_entries(child))
    return out

  def _snod_entries(self, addr):
    b = self._read(addr, 8)
    if b[:4] != b'SNOD' or b[4] != 1:
      raise self._err(f'a symbol table node of signature {b[:4]!r} '
                      f'version {b[4]}')
    n = _uint(b, 6, 2)
    size = 2 * self._so + 24
    b = self._read(addr + 8, n * size)
    out = []
    for i in range(n):
      p = i * size
      if _uint(b, p + 2 * self._so, 4) == 1:
        raise self._err('a nested group')
      out.append((self._off(b, p), self._off(b, p + self._so)))
    return out

  # ---- object headers and datasets -------------------------------------

  def _messages(self, addr):
    """[(type, flags, body)] of the version 1 object header at ``addr``,
    across its continuation blocks, NIL messages dropped."""
    b = self._read(addr, 16)
    if b[:4] == b'OHDR':
      raise self._err('object header version 2')
    if b[0] != 1:
      raise self._err(f'object header version {b[0]}')
    total = _uint(b, 2, 2)
    chunks = [(addr + 16, _uint(b, 8, 4))]
    out, seen = [], 0
    while chunks and seen < total:
      start, size = chunks.pop(0)
      b = self._read(start, size)
      p = 0
      while p + 8 <= size and seen < total:
        mtype, msize, flags = _uint(b, p, 2), _uint(b, p + 2, 2), b[p + 4]
        body = b[p + 8:p + 8 + msize]
        p += 8 + msize
        seen += 1
        if mtype == CONTINUATION:
          chunks.append((self._off(body, 0), self._len(body, self._so)))
        elif mtype != NIL:
          out.append((mtype, flags, body))
    return out

  def _dataset(self, name, msgs):
    by_type = {}
    for mtype, flags, body in msgs:
      if mtype in (SYMBOL_TABLE, LINK_INFO, LINK, GROUP_INFO):
        raise self._err(f'a nested group ({name!r})')
      if mtype == FILTERS:
        raise self._err(f'a filtered (compressed) dataset ({name!r})')
      if mtype in (DATASPACE, DATATYPE, LAYOUT) and flags & 2:
        raise self._err(f'a shared message in {name!r}')
      by_type.setdefault(mtype, body)
    for mtype, what in ((DATASPACE, 'dataspace'), (DATATYPE, 'datatype'),
                        (LAYOUT, 'layout')):
      if mtype not in by_type:
        raise self._err(f'a dataset without a {what} message ({name!r})')
    shape = self._dataspace(name, by_type[DATASPACE])
    dtype = self._datatype(name, by_type[DATATYPE])
    addr, size = self._layout(name, by_type[LAYOUT])
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes == 0:         # HDF5 stores no data for an empty array
      return np.empty(shape, dtype)
    if addr == UNDEF:
      raise self._err(f'a dataset never written ({name!r})')
    if size < nbytes:
      raise self._err(f'a contiguous dataset of {size} bytes holding '
                      f'{nbytes} ({name!r})')
    data = self._read(addr, nbytes)
    return np.frombuffer(data, dtype).reshape(shape).copy()

  def _dataspace(self, name, b):
    """The dimensions (version 1: the maximum dimensions, which follow,
    are a contiguous dataset's own)."""
    if b[0] != 1:
      raise self._err(f'dataspace version {b[0]} ({name!r})')
    return tuple(self._len(b, 8 + i * self._sl) for i in range(b[1]))

  def _datatype(self, name, b):
    cls, bits, size = b[0] & 0x0f, _uint(b, 1, 3), _uint(b, 4, 4)
    if cls not in (0, 1):
      raise self._err(f'{DATATYPE_CLASSES.get(cls, f"class {cls}")} data '
                      f'({name!r})')
    if bits & 1 or (cls == 1 and bits & 0x40):
      raise self._err(f'big-endian data ({name!r})')
    props = b[8:]
    offset, precision = _uint(props, 0, 2), _uint(props, 2, 2)
    if cls == 0:
      if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
        raise self._err(f'a {precision}-bit integer at bit {offset} in '
                        f'{size} bytes ({name!r})')
      return np.dtype(f'<{"i" if bits & 8 else "u"}{size}')
    layout = (precision, props[4], props[5], props[6], props[7],
              _uint(props, 8, 4))
    if size not in IEEE or offset or layout != IEEE[size]:
      raise self._err(f'a non-IEEE float of {size} bytes {layout} '
                      f'({name!r})')
    return np.dtype(f'<f{size}')

  def _layout(self, name, b):
    """(address, size) of a version 3 contiguous layout."""
    if b[0] != 3:
      raise self._err(f'layout version {b[0]} ({name!r})')
    if b[1] != 1:
      what = {0: 'compact', 2: 'chunked'}.get(b[1], f'class {b[1]}')
      raise self._err(f'{what} storage ({name!r})')
    return self._off(b, 2), self._len(b, 2 + self._so)


def read(path):
  """{name: array} of every dataset in the file's root group."""
  with File(path) as f:
    return {k: f[k] for k in f.keys()}


# ---- writing ----------------------------------------------------------

def _pad8(n):
  return (n + 7) // 8 * 8


def _message(mtype, body, flags=0):
  body = body + b'\0' * (_pad8(len(body)) - len(body))
  return struct.pack('<HHB3x', mtype, len(body), flags) + body


def _object_header(messages):
  body = b''.join(messages)
  return struct.pack('<BBHII4x', 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(path, name, dtype):
  size = dtype.itemsize
  if dtype.kind == 'f' and size in IEEE:
    prec, exp_loc, exp_size, man_loc, man_size, bias = IEEE[size]
    # Class 1, version 1; mantissa normalisation "implied" (bits 4-5 = 2);
    # the sign bit's location.
    head = struct.pack('<B3BI', 0x11, 0x20, prec - 1, 0, size)
    return head + struct.pack('<HHBBBBI', 0, prec, exp_loc, exp_size,
                              man_loc, man_size, bias)
  if dtype.kind in 'iu' and size in (1, 2, 4, 8):
    head = struct.pack('<B3BI', 0x10, 0x08 if dtype.kind == 'i' else 0, 0,
                       0, size)
    return head + struct.pack('<HH', 0, 8 * size)
  raise H5FormatError(path, f'{dtype} data ({name!r})')


def write(path, arrays):
  """Write ``arrays`` ({name: array}) as datasets of the root group of a
  new HDF5 file at ``path``: float32/64 and (u)int8-64 arrays of any rank,
  stored little-endian and contiguous."""
  path = str(path)
  names = sorted(arrays, key=lambda s: s.encode('utf-8'))
  for name in names:
    if not name or '/' in name or '\0' in name or name == '.':
      raise H5FormatError(path, f'the dataset name {name!r}')
  datas = []
  for name in names:
    a = np.asarray(arrays[name])
    if a.dtype.kind not in 'fiu':
      raise H5FormatError(path, f'{a.dtype} data ({name!r})')
    # astype copies in C order and keeps rank 0 (ascontiguousarray would
    # make a scalar 1-d).
    datas.append(a.astype(a.dtype.newbyteorder('<'), order='C'))
  so = sl = 8

  # The local heap's data: '' at 0, then each name, NUL-padded to 8.
  heap = bytearray(b'\0' * 8)
  name_off = []
  for name in names:
    name_off.append(len(heap))
    raw = name.encode('utf-8') + b'\0'
    heap += raw + b'\0' * (_pad8(len(raw)) - len(raw))

  # Addresses: superblock, root object header, heap, SNODs, B-tree nodes,
  # dataset object headers, data.
  entry_size = 2 * so + 24
  sb_size = 8 + 8 + 4 + 4 * so + entry_size
  root_oh = _object_header([_message(SYMBOL_TABLE, b'\0' * 2 * so)])
  addr = sb_size
  root_addr = addr
  addr += len(root_oh)
  heap_addr = addr
  addr += 8 + 2 * sl + so
  heap_data_addr = addr
  addr += len(heap)

  per_snod = 2 * LEAF_K
  snods = [list(range(i, min(i + per_snod, len(names))))
           for i in range(0, len(names), per_snod)]
  snod_size = 8 + per_snod * entry_size
  snod_addr = [addr + i * snod_size for i in range(len(snods))]
  addr += len(snods) * snod_size

  # B-tree levels, bottom-up: each node's children and the index of the
  # last name under each child.
  per_node = 2 * INTERNAL_K
  node_size = 8 + 2 * so + (per_node + 1) * sl + per_node * so
  children = [(a, s[-1]) for a, s in zip(snod_addr, snods)]
  levels = []
  while True:
    groups = [children[i:i + per_node]
              for i in range(0, len(children), per_node)] or [[]]
    addrs = [addr + i * node_size for i in range(len(groups))]
    addr += len(groups) * node_size
    levels.append((addrs, groups))
    if len(groups) == 1:
      break
    children = [(a, g[-1][1]) for a, g in zip(addrs, groups)]
  btree_addr = levels[-1][0][0]

  oh_addr, data_addr, headers = [], [], []
  for name, a in zip(names, datas):
    space = (struct.pack('<BBB5x', 1, a.ndim, 1 if a.ndim else 0)
             + b''.join(struct.pack('<Q', d) for d in a.shape) * 2)
    msgs = [_message(DATASPACE, space),
            _message(DATATYPE, _datatype_message(path, name, a.dtype), 1),
            # Version 2: allocated late, written if set, the default fill.
            _message(FILL, struct.pack('<BBBBI', 2, 2, 2, 1, 0), 1),
            None]
    layout_len = 24
    oh_addr.append(addr)
    addr += 16 + sum(len(m) for m in msgs[:3]) + 8 + layout_len
    headers.append(msgs)
  for a in datas:
    data_addr.append(addr if a.nbytes else UNDEF)
    addr = _pad8(addr + a.nbytes)
  eof = addr

  out = bytearray(eof)

  def put(at, b):
    out[at:at + len(b)] = b

  # Superblock version 0: 8-byte offsets and lengths, the K values, the
  # root group's symbol table entry with its B-tree and heap cached.
  put(0, SIGNATURE + struct.pack('<8BHHI', 0, 0, 0, 0, 0, so, sl, 0,
                                 LEAF_K, INTERNAL_K, 0))
  put(24, struct.pack('<4Q', 0, UNDEF, eof, UNDEF))
  put(56, struct.pack('<QQII', 0, root_addr, 1, 0)
      + struct.pack('<QQ', btree_addr, heap_addr))
  put(root_addr, _object_header([_message(
      SYMBOL_TABLE, struct.pack('<QQ', btree_addr, heap_addr))]))
  put(heap_addr, b'HEAP' + struct.pack('<B3xQQQ', 0, len(heap),
                                       HEAP_FREE_NULL, heap_data_addr))
  put(heap_data_addr, bytes(heap))
  for at, members in zip(snod_addr, snods):
    put(at, b'SNOD' + struct.pack('<BxH', 1, len(members)) + b''.join(
        struct.pack('<QQII16x', name_off[i], oh_addr[i], 0, 0)
        for i in members))
  for level, (addrs, groups) in enumerate(levels):
    for j, (at, group) in enumerate(zip(addrs, groups)):
      left = addrs[j - 1] if j else UNDEF
      right = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
      body = struct.pack('<Q', 0) + b''.join(
          struct.pack('<QQ', child, name_off[last]) for child, last in group)
      put(at, b'TREE' + struct.pack('<BBHQQ', 0, level, len(group), left,
                                    right) + body)
  for msgs, at, data, a in zip(headers, oh_addr, data_addr, datas):
    msgs[3] = _message(LAYOUT, struct.pack('<BBQQ', 3, 1, data, a.nbytes))
    put(at, _object_header(msgs))
    if a.nbytes:
      put(data, a.tobytes())
  with open(path, 'wb') as f:
    f.write(out)
  return path
