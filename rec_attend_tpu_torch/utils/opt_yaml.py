"""The flat YAML of the option snapshots, without PyYAML.

The JAX ``Saver`` writes ``model_opt.yaml`` and ``data_opt.yaml`` with
``yaml.safe_dump(opt, default_flow_style=False)``
(``rec_attend_tpu/engine/saver.py:58-62``): one mapping, keys sorted, each
value a scalar or a list of scalars in block style (``- x`` lines, not
indented), ``null``, ``true``/``false``, PyYAML's float spelling
(``repr``, with ``.0`` put before an exponent that has no point: ``5.0e-05``)
and strings plain unless plain would read back as another type or break
the syntax, then single-quoted.  ``dumps`` writes those bytes; ``loads``
reads such a file as ``yaml.safe_load`` does, with YAML 1.1's implicit
types (PyYAML's resolver patterns: ``1e-05`` without a point is a string).
Nested mappings, multi-line and non-ASCII strings are refused.
"""

from __future__ import annotations

import math
import re

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1.
_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                   r'|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9_]+(?:[eE][-+][0-9]+)?'
                    r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*'
                    r'|[-+]?\.(?:inf|Inf|INF)'
                    r'|\.(?:nan|NaN|NAN))$')
_INT = re.compile(r'^(?:[-+]?0b[0-1_]+'
                  r'|[-+]?0[0-7_]+'
                  r'|[-+]?(?:0|[1-9][0-9_]*)'
                  r'|[-+]?0x[0-9a-fA-F_]+'
                  r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$')
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_MERGE = re.compile(r'^(?:<<)$')
_TIMESTAMP = re.compile(
    r'^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]'
    r'|[0-9][0-9][0-9][0-9] -[0-9][0-9]?-[0-9][0-9]?'
    r'(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?'
    r'(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$')
_WIDTH = 80   # PyYAML's default line width: longer plain text is folded


def _plain_is_str(text):
  """Whether ``text`` written plain reads back as a string."""
  return not any(p.match(text) for p in (_BOOL, _FLOAT, _INT, _NULL, _MERGE,
                                         _TIMESTAMP))


def _plain_allowed(text):
  """PyYAML's ``analyze_scalar`` for a one-line ASCII string in block
  context: no leading or trailing space, no indicator that plain text
  cannot carry."""
  if text[0] == ' ' or text[-1] == ' ':
    return False
  if text.startswith(('---', '...')):
    return False
  if text[0] in '#,[]{}&*!|>\'"%@`':
    return False
  for i, ch in enumerate(text):
    followed_by_space = i + 1 >= len(text) or text[i + 1] == ' '
    if ch in '?:-' and i == 0 and followed_by_space:
      return False
    if ch == ':' and followed_by_space:
      return False
    if ch == '#' and i > 0 and text[i - 1] == ' ':
      return False
  return True


def _scalar(value, column):
  """One scalar as ``yaml.safe_dump`` spells it, starting at ``column``."""
  if value is None:
    return 'null'
  if isinstance(value, bool):
    return 'true' if value else 'false'
  if isinstance(value, int):
    return str(value)
  if isinstance(value, float):
    if math.isnan(value):
      return '.nan'
    if math.isinf(value):
      return '.inf' if value > 0 else '-.inf'
    text = repr(value).lower()
    if '.' not in text and 'e' in text:
      text = text.replace('e', '.0e', 1)
    return text
  if isinstance(value, str):
    if not all(' ' <= ch <= '~' for ch in value):
      raise ValueError(f'{value!r}: only one-line ASCII strings are written')
    if ' ' in value and column + len(value) > _WIDTH:
      raise ValueError(f'{value!r}: PyYAML would fold this string')
    if value and _plain_is_str(value) and _plain_allowed(value):
      return value
    return "'" + value.replace("'", "''") + "'"
  raise TypeError(f'{value!r}: not a scalar of an option snapshot')


def dumps(opt):
  """The text ``yaml.safe_dump(opt, default_flow_style=False)`` writes for
  a flat dict of scalars and lists of scalars."""
  if not opt:
    return '{}\n'
  lines = []
  for key in sorted(opt):
    value = opt[key]
    if not isinstance(key, str) or not _plain_allowed(key) or not (
        _plain_is_str(key)):
      raise ValueError(f'{key!r}: keys are plain strings')
    if isinstance(value, (list, tuple)):
      if not value:
        lines.append(f'{key}: []')
        continue
      lines.append(f'{key}:')
      lines += [f'- {_scalar(v, 2)}' for v in value]
    elif isinstance(value, dict):
      raise ValueError(f'{key}: nested mappings are not written')
    else:
      lines.append(f'{key}: {_scalar(value, len(key) + 2)}')
  return '\n'.join(lines) + '\n'


def _int(text):
  # PyYAML's construct_yaml_int.
  text = text.replace('_', '')
  sign = -1 if text[0] == '-' else 1
  if text[0] in '+-':
    text = text[1:]
  if text == '0':
    return 0
  if text.startswith('0b'):
    return sign * int(text[2:], 2)
  if text.startswith('0x'):
    return sign * int(text[2:], 16)
  if text[0] == '0':
    return sign * int(text, 8)
  if ':' in text:
    value = 0
    for part in text.split(':'):
      value = value * 60 + int(part)
    return sign * value
  return sign * int(text)


def _float(text):
  # PyYAML's construct_yaml_float.
  text = text.replace('_', '').lower()
  sign = -1.0 if text[0] == '-' else 1.0
  if text[0] in '+-':
    text = text[1:]
  if text == '.inf':
    return sign * math.inf
  if text == '.nan':
    return math.nan
  if ':' in text:
    value = 0.0
    for part in text.split(':'):
      value = value * 60 + float(part)
    return sign * value
  return sign * float(text)


def _read_scalar(text):
  text = text.strip()
  if text.startswith("'"):
    if len(text) < 2 or not text.endswith("'"):
      raise ValueError(f'unterminated quoted string {text!r}')
    return text[1:-1].replace("''", "'")
  if text.startswith('"'):
    if len(text) < 2 or not text.endswith('"'):
      raise ValueError(f'unterminated quoted string {text!r}')
    return (text[1:-1].encode('ascii').decode('unicode_escape'))
  if _NULL.match(text):
    return None
  if _BOOL.match(text):
    return text.lower() in ('yes', 'true', 'on')
  if _INT.match(text):
    return _int(text)
  if _FLOAT.match(text):
    return _float(text)
  if _TIMESTAMP.match(text) or _MERGE.match(text):
    raise ValueError(f'{text!r}: dates and merge keys are not read')
  return text


def _strip_comment(line):
  # A '#' after a space starts a comment, outside quotes.
  quote = None
  for i, ch in enumerate(line):
    if quote:
      if ch == quote:
        quote = None
    elif ch in '\'"':
      quote = ch
    elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
      return line[:i]
  return line


def _flow_list(text):
  inner = text.strip()[1:-1].strip()
  return [_read_scalar(v) for v in inner.split(',')] if inner else []


def loads(text):
  """The dict ``yaml.safe_load`` reads from a flat option snapshot."""
  out = {}
  key = None
  for raw in text.splitlines():
    line = _strip_comment(raw).rstrip()
    if not line.strip() or line.strip() in ('---', '...'):
      continue
    stripped = line.lstrip()
    if stripped.startswith('- ') or stripped == '-':
      if key is None or (out[key] is not None and not isinstance(out[key],
                                                                 list)):
        raise ValueError(f'a list item outside a list: {raw!r}')
      if out[key] is None:
        out[key] = []
      out[key].append(_read_scalar(stripped[1:]))
      continue
    if line[0] == ' ':
      raise ValueError(f'nested or continued value: {raw!r}')
    if line.strip() == '{}' and not out:
      continue
    name, sep, value = line.partition(':')
    if not sep or (value and value[0] != ' '):
      raise ValueError(f'not a key: value line: {raw!r}')
    key = _read_scalar(name)
    value = value.strip()
    if value.startswith('['):
      out[key] = _flow_list(value)
    elif value.startswith('{'):
      raise ValueError(f'{key}: nested mappings are not read')
    else:
      out[key] = _read_scalar(value)
  return out


def write(path, opt):
  with open(path, 'w') as f:
    f.write(dumps(opt))


def read(path):
  with open(path) as f:
    return loads(f.read())
