"""A training run's dashboard as one static page.

Counterpart of ``rec_attend_tpu/utils/dashboard.py``, the same bytes from
the same logs folder: ``generate`` reads the folder's ``catalog`` (the
``utils/log_manager.py`` list of files), draws each registered CSV time
series as an inline SVG chart, embeds each registered PNG and writes one
self-contained ``index.html`` beside them.

    python -m rec_attend_tpu_torch.utils.dashboard logs/<model id>
"""

from __future__ import annotations

import base64
import html
import os


def _read_catalog(folder):
  entries = []
  path = os.path.join(folder, 'catalog')
  if not os.path.exists(path):
    return entries
  with open(path) as f:
    next(f, None)
    for line in f:
      parts = line.strip().split(',')
      if len(parts) >= 3:
        entries.append((parts[0], parts[1], ','.join(parts[2:])))
  return entries


def _read_csv_series(path):
  """Returns (labels, list of (step, [values]))."""
  with open(path) as f:
    lines = [l.strip() for l in f if l.strip()]
  if not lines:
    return [], []
  header = lines[0].split(',')
  labels = header[2:]
  rows = []
  for line in lines[1:]:
    parts = line.split(',')
    try:
      step = float(parts[0])
    except ValueError:
      continue
    vals = []
    for v in parts[2:2 + len(labels)]:
      try:
        vals.append(float(v))
      except ValueError:
        vals.append(None)
    rows.append((step, vals))
  return labels, rows


_COLOURS = ['#2980b9', '#c0392b', '#27ae60', '#8e44ad', '#f39c12']


def _svg_chart(labels, rows, width=640, height=220, pad=40):
  if not rows:
    return '<p>(no data)</p>'
  xs = [r[0] for r in rows]
  all_vals = [v for _, vals in rows for v in vals if v is not None]
  if not all_vals:
    return '<p>(no data)</p>'
  x0, x1 = min(xs), max(xs) or 1
  y0, y1 = min(all_vals), max(all_vals)
  if y1 == y0:
    y1 = y0 + 1
  if x1 == x0:
    x1 = x0 + 1

  def sx(x):
    return pad + (x - x0) / (x1 - x0) * (width - 2 * pad)

  def sy(y):
    return height - pad - (y - y0) / (y1 - y0) * (height - 2 * pad)

  parts = [f'<svg width="{width}" height="{height}" '
           f'style="background:#fff;border:1px solid #ddd">']
  # axes
  parts.append(f'<line x1="{pad}" y1="{height-pad}" x2="{width-pad}" '
               f'y2="{height-pad}" stroke="#999"/>')
  parts.append(f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height-pad}" '
               f'stroke="#999"/>')
  parts.append(f'<text x="{pad}" y="{height-8}" font-size="10">{x0:g}</text>')
  parts.append(f'<text x="{width-pad-20}" y="{height-8}" '
               f'font-size="10">{x1:g}</text>')
  parts.append(f'<text x="2" y="{height-pad}" font-size="10">{y0:.3g}</text>')
  parts.append(f'<text x="2" y="{pad+4}" font-size="10">{y1:.3g}</text>')
  for li, label in enumerate(labels):
    pts = [(sx(s), sy(vals[li])) for s, vals in rows
           if li < len(vals) and vals[li] is not None]
    if not pts:
      continue
    colour = _COLOURS[li % len(_COLOURS)]
    d = ' '.join(f'{px:.1f},{py:.1f}' for px, py in pts)
    parts.append(f'<polyline points="{d}" fill="none" stroke="{colour}" '
                 f'stroke-width="1.5"/>')
    parts.append(f'<text x="{pad + 6 + 120 * li}" y="{pad - 6}" '
                 f'font-size="11" fill="{colour}">'
                 f'{html.escape(label)}</text>')
  parts.append('</svg>')
  return ''.join(parts)


def generate(folder, output=None):
  """Render logs/<model_id>/catalog into a standalone index.html."""
  output = output or os.path.join(folder, 'index.html')
  entries = _read_catalog(folder)
  sections = [f'<h1>{html.escape(os.path.basename(folder))}</h1>']
  for fname, typ, name in entries:
    path = os.path.join(folder, fname)
    if not os.path.exists(path):
      continue
    sections.append(f'<h3>{html.escape(name)}</h3>')
    if typ == 'csv':
      labels, rows = _read_csv_series(path)
      sections.append(_svg_chart(labels, rows))
    elif typ == 'image':
      with open(path, 'rb') as f:
        b64 = base64.b64encode(f.read()).decode()
      sections.append(f'<img src="data:image/png;base64,{b64}" '
                      f'style="max-width:900px"/>')
    else:
      with open(path, errors='replace') as f:
        sections.append(f'<pre>{html.escape(f.read()[:5000])}</pre>')
  doc = ('<!doctype html><html><head><meta charset="utf-8">'
         '<title>training dashboard</title>'
         '<style>body{font-family:sans-serif;margin:24px}</style>'
         '</head><body>' + '\n'.join(sections) + '</body></html>')
  with open(output, 'w') as f:
    f.write(doc)
  return output


def main(argv=None):
  import argparse
  parser = argparse.ArgumentParser(description='Render training dashboard')
  parser.add_argument('folder', help='logs/<model_id> folder')
  parser.add_argument('--output', default=None)
  args = parser.parse_args(argv)
  out = generate(args.folder, args.output)
  print(out)


if __name__ == '__main__':
  main()
