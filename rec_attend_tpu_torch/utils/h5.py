"""Read and write HDF5 files of groups and arrays without h5py.

The port's stand-in for h5py where the JAX package uses it: the
``weights.h5`` files of ``rec_attend_tpu/nn/params.py`` and the datasets'
files of ``rec_attend_tpu/data/{assembler,dataset}.py`` (``<id>/input``,
``<id>/label_segmentation/NN``, the ``index_map`` of ids, the packed
predictions): the card's machine has no h5py.  The files are HDF5 1.8
"earliest" files: a version 0 superblock and groups that are symbol tables
(a version 1 B-tree of any depth over symbol table nodes, the names in a
local heap), nested to any depth, holding datasets with version 1 object
headers (continuations followed, NIL and unknown messages skipped), simple
dataspaces, little-endian IEEE floats, fixed-point integers or fixed-length
byte strings (numpy ``|S``), and contiguous storage.  Anything else raises
``H5FormatError`` naming the file and the feature: chunked, compact or
filtered storage, attributes asked for, new-style groups, variable-length
strings, big-endian data, later superblocks, object headers, dataspaces or
layouts, a user block.  There is no fallback to h5py.

    arrays = h5.read('results/box_model_synth-20260816104712/weights.h5')
    with h5.File(path) as f:          # lazy: names first, one dataset read
      if 'ctrl_cnn_w_0' in f:
        w = f['ctrl_cnn_w_0']
      blob = f['plant001/label_segmentation/00']     # a uint8 array
      group = f['plant001']                          # a Group: keys(), in
    h5.write(path, {'ctrl_cnn_w_0': w, 'plant001': {'orig_size': size}})
    h5.update(path, {'plant001': {'score_pred': s}})  # add or replace

``write`` lays a file out as h5py 3.x does with ``libver='earliest'`` (the
same messages a dataset, the same B-tree and heap forms), not byte for
byte: each B-tree is built full, from the sorted names.  It writes a
temporary file beside ``path`` and renames it, so that a reader sees the
old file or the new one; ``update`` rewrites a file with datasets added or
replaced that way, once for any number of them.
"""

from __future__ import annotations

import os
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
# A fixed-length string's padding (h5py writes numpy ``S`` data null-padded)
# and character sets.
STR_NULLPAD = 1
STR_PADDING = {0: 'null-terminated', 1: 'null-padded', 2: 'space-padded'}


class H5FormatError(ValueError):
  """A file, or a part of it, that this codec does not read or write."""

  def __init__(self, path, feature):
    super().__init__(f'{path}: {feature} is not supported by the port\'s '
                     'HDF5 codec (rec_attend_tpu_torch/utils/h5.py)')
    self.path, self.feature = path, feature


def _uint(b, off, n):
  return int.from_bytes(b[off:off + n], 'little')


class Group:
  """A group of an open ``File``: ``keys()`` (sorted), ``name in g`` and
  ``g[name]`` (a ``Group``, or a numpy array read when asked for) for a
  name or a '/'-separated path under it; ``name`` is its path in the
  file."""

  def __init__(self, file, name, entries):
    self.file, self.name, self._entries = file, name, entries

  def keys(self):
    return sorted(self._entries)

  def __len__(self):
    return len(self._entries)

  def _lookup(self, path):
    """The object header address of ``path`` under this group and the
    group that holds it, or None."""
    parts = [p for p in path.split('/') if p]
    group = self
    for i, part in enumerate(parts):
      if part not in group._entries:
        return None, None
      addr = group._entries[part]
      if i + 1 < len(parts):
        group = self.file._group_at(addr, f'{group.name.rstrip("/")}/{part}')
        if group is None:
          return None, None
    return (addr, group) if parts else (None, None)

  def __contains__(self, path):
    return self._lookup(path)[0] is not None

  def __getitem__(self, path):
    addr, parent = self._lookup(path)
    if addr is None:
      raise KeyError(f'{self.file.path}: no object {path!r} in '
                     f'{self.name!r}')
    full = f'{parent.name.rstrip("/")}/{path.split("/")[-1]}'
    group = self.file._group_at(addr, full)
    if group is not None:
      return group
    return self.file._dataset(full, self.file._messages(addr))

  def attrs(self, path):
    """The attributes of dataset ``path``: {} where it has none; any
    attribute raises."""
    addr, _ = self._lookup(path)
    if addr is None:
      raise KeyError(f'{self.file.path}: no object {path!r}')
    for mtype, _, _ in self.file._messages(addr):
      if mtype in (ATTRIBUTE, ATTRIBUTE_INFO):
        raise H5FormatError(self.file.path, f'the attributes of {path!r}')
    return {}


class File(Group):
  """A file opened for reading, its root group."""

  def __init__(self, path):
    self.path = str(path)
    self._f = open(self.path, 'rb')
    self._groups = {}
    try:
      root = self._read_superblock()
      group = self._group_at(root, '/')
      if group is None:
        raise self._err('a root group without a symbol table')
    except Exception:
      self._f.close()
      raise
    super().__init__(self, '/', group._entries)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  def close(self):
    self._f.close()

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

  # ---- superblock and groups -------------------------------------------

  def _read_superblock(self):
    b = self._f.read(24)
    if b[:8] != SIGNATURE:
      raise self._err('a file without the HDF5 signature at its start')
    if b[8] != 0:
      raise self._err(f'superblock version {b[8]}')
    self._so, self._sl = b[13], b[14]
    b = self._f.read(4 * self._so + 2 * self._so + 24)
    self._base = self._off(b, 0)
    return self._off(b, 4 * self._so + self._so)

  def _group_at(self, addr, name):
    """The ``Group`` whose object header is at ``addr``, None where the
    object is a dataset."""
    if addr in self._groups:
      return self._groups[addr]
    msgs = self._messages(addr)
    stab = [body for t, _, body in msgs if t == SYMBOL_TABLE]
    if not stab:
      if any(t in (LINK_INFO, LINK, GROUP_INFO) for t, _, _ in msgs):
        raise self._err(f'a new-style (link message) group ({name!r})')
      return None
    btree, heap = self._off(stab[0], 0), self._off(stab[0], self._so)
    names = self._heap(heap)
    entries = {}
    for name_off, header in self._btree_entries(btree, 0):
      end = names.find(b'\0', name_off)
      entries[names[name_off:end].decode('utf-8')] = header
    self._groups[addr] = Group(self, name, entries)
    return self._groups[addr]
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
    if cls == 3:
      if bits & 0x0f not in STR_PADDING or (bits >> 4) & 0x0f > 1:
        raise self._err(f'a string of padding {bits & 0x0f}, character '
                        f'set {(bits >> 4) & 0x0f} ({name!r})')
      return np.dtype(f'S{size}')
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


def _tree(group):
  return {k: _tree(v) if isinstance(v, Group) else v
          for k, v in ((k, group[k]) for k in group.keys())}


def read(path):
  """{name: array, or {name: ...} for a group} of every object in the
  file."""
  with File(path) as f:
    return _tree(f)


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
  if dtype.kind == 'S' and size:
    # Class 3, version 1: null-padded ASCII, as h5py writes numpy ``S``.
    return struct.pack('<B3BI', 0x13, STR_NULLPAD, 0, 0, size)
  raise H5FormatError(path, f'{dtype} data ({name!r})')


class _Writer:
  """Writes a tree to the file object ``f`` as it walks it, children
  before their group, each object at an 8-byte aligned address; the
  superblock, whose place is kept at the start, goes in last.  A value of
  the tree may be a callable that returns the array or the subtree: it is
  called when its turn comes, so that one object at a time is in memory."""

  ENTRY = 40                              # a symbol table entry
  SUPERBLOCK = 8 + 8 + 8 + 4 * 8 + ENTRY

  def __init__(self, path, f):
    self.path, self.f = path, f
    f.write(b'\0' * self.SUPERBLOCK)
    self.pos = self.SUPERBLOCK

  def alloc(self, b):
    addr = self.pos
    pad = _pad8(len(b)) - len(b)
    self.f.write(b)
    self.f.write(b'\0' * pad)
    self.pos += len(b) + pad
    return addr

  def dataset(self, name, v):
    """The object header address of the array ``v``."""
    a = np.asarray(v)
    if a.dtype.kind not in 'fiuS':
      raise H5FormatError(self.path, f'{a.dtype} data ({name!r})')
    # astype copies in C order and keeps rank 0 (ascontiguousarray would
    # make a scalar 1-d).
    a = a.astype(a.dtype if a.dtype.kind == 'S'
                 else a.dtype.newbyteorder('<'), order='C')
    space = (struct.pack('<BBB5x', 1, a.ndim, 1 if a.ndim else 0)
             + b''.join(struct.pack('<Q', d) for d in a.shape) * 2)
    data = self.alloc(a.tobytes()) if a.nbytes else UNDEF
    return self.alloc(_object_header([
        _message(DATASPACE, space),
        _message(DATATYPE, _datatype_message(self.path, name, a.dtype), 1),
        # Version 2: allocated late, written if set, the default fill.
        _message(FILL, struct.pack('<BBBBI', 2, 2, 2, 1, 0), 1),
        _message(LAYOUT, struct.pack('<BBQQ', 3, 1, data, a.nbytes))]))

  def group(self, tree, where):
    """(object header, B-tree, heap) addresses of the group of ``tree``
    ({name: array, {name: ...} or a callable giving one}), its children
    written first."""
    names = sorted(tree, key=lambda s: s.encode('utf-8'))
    entries = []
    for name in names:
      if not name or '/' in name or '\0' in name or name == '.':
        raise H5FormatError(self.path, f'the name {name!r} in {where!r}')
      sub = f'{where.rstrip("/")}/{name}'
      v = tree[name]
      if callable(v):
        v = v()
      if isinstance(v, dict):
        header, btree, heap = self.group(v, sub)
        entries.append((header, 1, struct.pack('<QQ', btree, heap)))
      else:
        entries.append((self.dataset(sub, v), 0, b'\0' * 16))
      del v
    # The local heap's data: '' at 0, then each name, NUL-padded to 8.
    heap = bytearray(b'\0' * 8)
    name_off = []
    for name in names:
      name_off.append(len(heap))
      raw = name.encode('utf-8') + b'\0'
      heap += raw + b'\0' * (_pad8(len(raw)) - len(raw))
    heap_data = self.alloc(bytes(heap))
    heap_addr = self.alloc(b'HEAP' + struct.pack(
        '<B3xQQQ', 0, len(heap), HEAP_FREE_NULL, heap_data))
    per_snod = 2 * LEAF_K
    children = []
    for i in range(0, len(names), per_snod):
      members = range(i, min(i + per_snod, len(names)))
      body = b''.join(struct.pack('<QQI4x', name_off[j], entries[j][0],
                                  entries[j][1]) + entries[j][2]
                      for j in members)
      body += b'\0' * (self.ENTRY * per_snod - len(body))
      addr = self.alloc(b'SNOD' + struct.pack('<BxH', 1, len(members))
                        + body)
      children.append((addr, members[-1]))
    # B-tree levels, bottom-up, each node allocated full (2 INTERNAL_K
    # children), its keys the offsets of the last name under each child.
    per_node = 2 * INTERNAL_K
    node_size = 8 + 2 * 8 + (per_node + 1) * 8 + per_node * 8
    level = 0
    while True:
      groups = [children[i:i + per_node]
                for i in range(0, len(children), per_node)] or [[]]
      addrs = [self.pos + i * node_size for i in range(len(groups))]
      for j, group in enumerate(groups):
        left = addrs[j - 1] if j else UNDEF
        right = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
        body = struct.pack('<Q', 0) + b''.join(
            struct.pack('<QQ', child, name_off[last])
            for child, last in group)
        node = b'TREE' + struct.pack('<BBHQQ', 0, level, len(group), left,
                                     right) + body
        self.alloc(node + b'\0' * (node_size - len(node)))
      if len(groups) == 1:
        break
      children = [(a, g[-1][1]) for a, g in zip(addrs, groups)]
      level += 1
    header = self.alloc(_object_header([_message(
        SYMBOL_TABLE, struct.pack('<QQ', addrs[0], heap_addr))]))
    return header, addrs[0], heap_addr

  def finish(self, tree):
    header, btree, heap = self.group(tree, '/')
    # Superblock version 0: 8-byte offsets and lengths, the K values, the
    # root group's symbol table entry with its B-tree and heap cached.
    self.f.seek(0)
    self.f.write(SIGNATURE + struct.pack(
        '<8BHHI', 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0)
        + struct.pack('<4Q', 0, UNDEF, self.pos, UNDEF)
        + struct.pack('<QQII', 0, header, 1, 0)
        + struct.pack('<QQ', btree, heap))


def write(path, tree):
  """Write ``tree`` ({name: array, {name: ...} for a group, or a callable
  that returns either when its turn comes}) as a new HDF5 file at
  ``path``: float32/64, (u)int8-64 and fixed-length byte string arrays of
  any rank, stored little-endian and contiguous, in groups nested to any
  depth.  The file is written beside ``path`` and renamed over it; returns
  ``path``."""
  path = str(path)
  tmp = f'{path}.{os.getpid()}.tmp'
  try:
    with open(tmp, 'wb') as f:
      _Writer(path, f).finish(tree)
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)
  return path


def _lazy(group, changes):
  """The tree of ``group`` with ``changes`` merged in: a group of
  ``changes`` merges into the group of its name, anything else adds or
  replaces; the group's own datasets are read when the writer comes to
  them."""
  tree = {}
  for name in group.keys():
    addr, _ = group._lookup(name)
    sub = group.file._group_at(addr, f'{group.name.rstrip("/")}/{name}')
    if sub is not None:
      sub_changes = changes.get(name)
      tree[name] = _lazy(sub, sub_changes if isinstance(sub_changes, dict)
                         else {})
    else:
      tree[name] = (lambda g=group, n=name: g[n])
  for name, v in changes.items():
    if not (isinstance(v, dict) and isinstance(tree.get(name), dict)):
      tree[name] = v
  return tree


def update(path, changes):
  """Rewrite the file at ``path`` with ``changes`` ({name: array or
  {name: ...}}) merged into its tree: a group merges into the group of its
  name, an array adds or replaces the object of its name.  One rewrite for
  any number of changes, each old dataset read as it is copied, the file
  replaced whole as ``write`` does; returns ``path``."""
  with File(path) as f:
    return write(path, _lazy(f, changes))
