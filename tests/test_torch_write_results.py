"""The port's RESULTS.md writer (rec_attend_tpu_torch/pipelines/
write_results.py) against the JAX package's script on the committed run
folders.

Both write into copies of the committed RESULTS.md: the flagship's CVPPP
head (the three-stage sections below it kept), the synth3 section and the
synthcs section (each replaced in place).  The texts are the same but for
three lines: the head names no accelerator, and the regeneration commands
name the port's modules.  A notes.md survives regeneration; the option
snapshots read without PyYAML print as PyYAML's do.
"""

import glob
import os
import re
import shutil
import sys

import pytest
import yaml

from rec_attend_tpu_torch.pipelines import write_results
from rec_attend_tpu_torch.utils import opt_yaml

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
from pipelines import write_results as jwrite_results  # noqa: E402

FLAGSHIP = ['--full_id', 'full_model_synth-20260816104712',
            '--box_id', 'box_model_synth-20260816104712']
SECTIONS = {
    'cvppp': FLAGSHIP,
    'synth3': ['--section', 'synth3', '--fg_id', 'fg_model_synth3-20260818a',
               '--box_id', 'box_model_synth3-20260818a',
               '--full_id', 'full_model_synth3-20260818a'],
    'synthcs': ['--section', 'synthcs',
                '--fg_id', 'fg_model_synthcs-20260818a',
                '--box_id', 'box_model_synthcs-20260818a',
                '--full_id', 'full_model_synthcs-20260818a'],
}
# The lines of JAX's text that the port writes otherwise: the head's
# accelerator and its regeneration line, a section's regeneration
# commands.  A notes.md is copied as it is, whatever it says.
HEAD_LINE = ('trained end-to-end on one TPU v5e chip with the CVPPP-preset '
             'configs', 'trained end-to-end with the CVPPP-preset configs')
REGEN = re.compile(
    r'^Regenerate: `python pipelines/resume_synth_paper\.py --box_id \S+ '
    r'--skip_box` then `python pipelines/write_results\.py --full_id \S+ '
    r'--box_id \S+`\.$')
SECTION_REGEN = re.compile(
    r'^(?:Export|Analyzer CSVs): `[^`]*`\.  Regenerate: `python '
    r'pipelines/run_pipeline\.py --dataset \w+ --scale paper'
    r'(?: --stages \w+)?`\.$')
COMMANDS = (
    ('python pipelines/run_pipeline.py',
     'python -m rec_attend_tpu_torch.pipelines.run_pipeline'),
    ('python pipelines/resume_synth_paper.py',
     'python -m rec_attend_tpu_torch.pipelines.resume_synth_paper'),
    ('python pipelines/write_results.py',
     'python -m rec_attend_tpu_torch.pipelines.write_results'),
)
# The lines translated in each part written from the committed folders
# (the synthcs run has a pixel_eval.json and no ap.json).
CHANGED = {'cvppp': 2, 'synth3': 1, 'synthcs': 2}


def run_jax(argv, monkeypatch):
  monkeypatch.setattr(sys, 'argv', ['write_results'] + argv)
  jwrite_results.main()


def part_bounds(text, section):
  """(start, end) of the part of RESULTS.md that one run writes: the
  head, or the section."""
  if section == 'cvppp':
    end = text.find(write_results.SECTION_MARKER)
    return 0, len(text) if end == -1 else end
  title = f'## {write_results.SECTION_FLAVORS[section][0]}'
  start = text.index(title)
  end = text.find(write_results.SECTION_MARKER, start + len(title))
  return start, len(text) if end == -1 else end


def written_part(text, section):
  start, end = part_bounds(text, section)
  return text[start:end]


def translate_line(line):
  if line == HEAD_LINE[0]:
    return HEAD_LINE[1]
  if REGEN.match(line) or SECTION_REGEN.match(line):
    for old, new in COMMANDS:
      line = line.replace(old, new)
  return line


def translated(jax_text, section):
  """JAX's text with the lines of the written part that the port writes
  otherwise translated, and the number of lines translated."""
  start, end = part_bounds(jax_text, section)
  lines = jax_text[start:end].split('\n')
  new = [translate_line(line) for line in lines]
  changed = sum(a != b for a, b in zip(lines, new))
  return jax_text[:start] + '\n'.join(new) + jax_text[end:], changed


@pytest.mark.parametrize('section', sorted(SECTIONS))
def test_the_port_writes_jax_text_on_the_committed_folders(
    section, tmp_path, monkeypatch, capsys):
  monkeypatch.chdir(REPO)
  argv = SECTIONS[section]
  outs = {}
  for side in ('jax', 'port'):
    out = str(tmp_path / f'{side}.md')
    shutil.copy(os.path.join(REPO, 'RESULTS.md'), out)
    if side == 'jax':
      run_jax(argv + ['--out', out], monkeypatch)
    else:
      assert write_results.main(argv + ['--out', out]) == out
    with open(out) as f:
      outs[side] = f.read()
  printed = capsys.readouterr().out.splitlines()
  assert printed[0].replace('jax.md', 'port.md') == printed[1]
  want, changed = translated(outs['jax'], section)
  assert outs['port'] == want
  assert changed == CHANGED[section]
  part = written_part(outs['port'], section)
  assert 'TPU' not in part and 'v5e' not in part
  # The rest of the file is the committed one's.
  with open(os.path.join(REPO, 'RESULTS.md')) as f:
    committed = f.read()
  if section == 'cvppp':
    assert outs['port'].endswith(committed[committed.index(
        write_results.SECTION_MARKER):])
  else:
    assert outs['port'].startswith(committed[:committed.index(
        f'## {write_results.SECTION_FLAVORS[section][0]}')])


def _linked_results(tmp_path, ids, notes_id):
  """A results folder of links to the committed runs, the folder of
  ``notes_id`` a real one whose notes.md is written here."""
  res = tmp_path / 'results'
  for mid in ids:
    src = os.path.join(REPO, 'results', mid)
    if mid != notes_id:
      os.makedirs(res, exist_ok=True)
      os.symlink(src, res / mid)
      continue
    os.makedirs(res / mid)
    for name in os.listdir(src):
      if name != 'notes.md':
        os.symlink(os.path.join(src, name), res / mid / name)
  return str(res)


@pytest.mark.parametrize('section', ['cvppp', 'synth3'])
def test_notes_survive_regeneration(section, tmp_path, monkeypatch):
  argv = SECTIONS[section]
  ids = [argv[i + 1] for i, a in enumerate(argv) if a.endswith('_id')]
  full_id = argv[argv.index('--full_id') + 1]
  res = _linked_results(tmp_path, ids, full_id)
  notes = os.path.join(res, full_id, 'notes.md')
  with open(notes, 'w') as f:
    f.write('NOTES-SENTINEL durable commentary\n')
  out = str(tmp_path / 'RESULTS.md')
  shutil.copy(os.path.join(REPO, 'RESULTS.md'), out)
  common = argv + ['--results', res, '--logs', os.path.join(REPO, 'logs'),
                   '--out', out]
  for _ in range(2):
    write_results.main(common)
    with open(out) as f:
      doc = f.read()
    assert doc.count('NOTES-SENTINEL') == 1
    assert 'NOTES-SENTINEL' in written_part(doc, section)
  # What JAX writes from the same folders, translated, is the same file.
  jax_out = str(tmp_path / 'jax.md')
  shutil.copy(os.path.join(REPO, 'RESULTS.md'), jax_out)
  for _ in range(2):
    run_jax(argv + ['--results', res, '--logs', os.path.join(REPO, 'logs'),
                    '--out', jax_out], monkeypatch)
  with open(jax_out) as f:
    assert translated(f.read(), section)[0] == doc


def test_sections_append_and_replace_in_place(tmp_path, monkeypatch):
  """Into an empty file: the synthcs section, then synth3 after it, then
  the head before both; rewriting synthcs keeps synth3 and the head."""
  monkeypatch.chdir(REPO)
  out = str(tmp_path / 'RESULTS.md')
  jax_out = str(tmp_path / 'jax.md')
  for section in ('synthcs', 'synth3', 'cvppp', 'synthcs'):
    write_results.main(SECTIONS[section] + ['--out', out])
    run_jax(SECTIONS[section] + ['--out', jax_out], monkeypatch)
  with open(out) as f:
    doc = f.read()
  with open(jax_out) as f:
    jax_doc = f.read()
  for section in ('cvppp', 'synth3', 'synthcs'):
    jax_doc = translated(jax_doc, section)[0]
  assert jax_doc == doc
  assert doc.startswith('# RESULTS')
  titles = [doc.index(f'## {write_results.SECTION_FLAVORS[s][0]}')
            for s in ('synthcs', 'synth3')]
  assert titles == sorted(titles)
  for s in ('synthcs', 'synth3'):
    assert doc.count(f'## {write_results.SECTION_FLAVORS[s][0]}') == 1


def test_a_section_needs_its_fg_and_box_runs(tmp_path, monkeypatch):
  argv = ['--section', 'synth3', '--full_id', 'full_model_synth3-20260818a',
          '--out', str(tmp_path / 'RESULTS.md')]
  with pytest.raises(ValueError, match='--fg_id/--box_id'):
    write_results.main(argv + ['--box_id', 'box_model_synth3-20260818a'])
  with pytest.raises(AssertionError, match='--fg_id/--box_id'):
    run_jax(argv + ['--fg_id', 'fg_model_synth3-20260818a'], monkeypatch)
  assert not (tmp_path / 'RESULTS.md').exists()


def test_loss_curve_and_checkpoint_steps_as_jax(tmp_path):
  csv = tmp_path / 'loss.csv'
  csv.write_text('step,time,train loss,valid loss\n2,t,-0.5,\n4,t,,0.25\n'
                 'x,t,1,1\n6,t,oops,1\n8,t,0.125,0.5\n')
  for field in (2, 3, 5):
    assert (write_results.read_loss_curve(str(csv), field)
            == jwrite_results.read_loss_curve(str(csv), field))
  assert write_results.read_loss_curve(str(tmp_path / 'none.csv')) == []
  assert write_results.latest_ckpt_step(str(tmp_path)) is None
  for name in ('ckpt-2.npz', 'ckpt-10.npz', 'ckpt-x.npz'):
    (tmp_path / name).write_bytes(b'')
  assert write_results.latest_ckpt_step(str(tmp_path)) == 10
  assert jwrite_results.latest_ckpt_step(str(tmp_path)) == 10
  assert write_results.SECTION_MARKER == jwrite_results.SECTION_MARKER
  for key, (title, blurb, regen) in jwrite_results.SECTION_FLAVORS.items():
    ours = write_results.SECTION_FLAVORS[key]
    assert ours[:2] == (title, blurb)
    assert ours[2] == regen.replace(*COMMANDS[0])


SNAPSHOTS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, 'results', '*', '*_opt.yaml')))


@pytest.mark.parametrize('path', SNAPSHOTS)
def test_opt_yaml_prints_as_pyyaml(path):
  """``- dataset: {data_opt}`` prints the dict's repr: the same keys in
  the same order, of the same types, as PyYAML's safe_load gives."""
  with open(os.path.join(REPO, path)) as f:
    want = yaml.safe_load(f)
  got = opt_yaml.read(os.path.join(REPO, path))
  assert repr(got) == repr(want)
  assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
