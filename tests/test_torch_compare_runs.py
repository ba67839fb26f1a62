"""The port's run comparison table (rec_attend_tpu_torch/pipelines/
compare_runs.py) against the JAX package's script: the same rows, the
same markdown on stdout and the same notes.md appends, on the committed
runs and on crafted folders (a sweep, a plain eval, a calibrated
headline, a missing run)."""

import json
import os
import sys

import pytest

from rec_attend_tpu_torch.pipelines import compare_runs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
from pipelines import compare_runs as jcompare_runs  # noqa: E402

COMMITTED = {
    'bf16': ['--ids', 'full_model_synth1024-20260816,'
             'full_model_synth1024bf16-r5', '--labels', 'f32,bf16',
             '--title', 'bf16 against f32'],
    'levers': ['--ids', 'full_model_s1024_ft0-r5,full_model_s1024_ft0f32-r5,'
               'full_model_s1024_ftA-r5,full_model_s1024_ftV-r5',
               '--labels', 'ft0,ft0f32,A,V', '--title', 'counting levers'],
    'flagship': ['--ids', 'full_model_synth-20260816104712,'
                 'full_model_synth_ft2-r4,full_model_synth3-20260818a,'
                 'full_model_synthcs-20260818a'],
}


def both(argv, notes_dir, capsys):
  """(port rows, port stdout, port notes, JAX rows, JAX stdout, JAX
  notes), each side appending to its own notes.md twice."""
  out = []
  for side, fn in (('port', compare_runs.main), ('jax', jcompare_runs.main)):
    notes = os.path.join(notes_dir, side, 'notes.md')
    rows = fn(argv + ['--notes', notes])
    fn(argv + ['--notes', notes])
    printed = capsys.readouterr().out
    with open(notes) as f:
      out += [rows, printed, f.read()]
  return out


@pytest.mark.parametrize('case', sorted(COMMITTED))
def test_committed_runs_as_jax(case, tmp_path, monkeypatch, capsys):
  monkeypatch.chdir(REPO)
  rows, printed, notes, jrows, jprinted, jnotes = both(
      COMMITTED[case], str(tmp_path), capsys)
  assert rows == jrows
  assert printed == jprinted
  assert notes == jnotes
  assert notes.count('### ') == 2 and printed.count('### ') == 2
  assert '(best-of-sweep)' in printed


def _write_csv(path, mean, std):
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, 'w') as f:
    f.write(f'example,score\n0,0.0\nMean,{mean}\nStd,{std}\n')


def _make_run(results, logs, mid, sweep=True, headline=True, loss=True):
  folder = os.path.join(results, mid, 'output_valid')
  if sweep:
    for t, (sbd, acc, dic) in ((30, (0.70, 0.60, 0.50)),
                               (40, (0.80, 0.65, 0.40))):
      _write_csv(os.path.join(folder, f'sbd_{t}.csv'), sbd, 0.1)
      _write_csv(os.path.join(folder, f'count_acc_{t}.csv'), acc, 0.1)
      _write_csv(os.path.join(folder, f'dic_abs_{t}.csv'), dic, 0.1)
  else:
    _write_csv(os.path.join(folder, 'sbd.csv'), 0.55, 0.1)
  if headline:
    with open(os.path.join(results, mid, 'count_calibration.json'),
              'w') as f:
      json.dump({'headline': {'mask_threshold': 0.4,
                              'score_threshold': 0.3,
                              'metrics': {'sbd': [0.78, 0.1],
                                          'count_acc': [0.64, 0.2]}}}, f)
  if loss:
    os.makedirs(os.path.join(logs, mid), exist_ok=True)
    with open(os.path.join(logs, mid, 'loss.csv'), 'w') as f:
      f.write('step,time,train loss,valid loss\n100,t,-1.0,\n200,t,-1.25,\n')


CRAFTED = {
    'full_and_plain': (dict(), dict(sweep=False, headline=False, loss=False),
                       ['--labels', 'A,B', '--title', 'lever smoke']),
    'no_headline': (dict(headline=False), dict(headline=False), []),
    'missing_run': (dict(), None, []),
}


@pytest.mark.parametrize('case', sorted(CRAFTED))
def test_crafted_runs_as_jax(case, tmp_path, capsys):
  results, logs = str(tmp_path / 'res'), str(tmp_path / 'logs')
  a, b, extra = CRAFTED[case]
  _make_run(results, logs, 'run_a', **a)
  if b is not None:
    _make_run(results, logs, 'run_b', **b)
  argv = ['--ids', 'run_a,run_b', '--results', results, '--logs', logs]
  rows, printed, notes, jrows, jprinted, jnotes = both(
      argv + extra, str(tmp_path / 'notes'), capsys)
  assert (rows, printed, notes) == (jrows, jprinted, jnotes)
  assert rows[0]['sweep_best_thr'] == 0.40
  assert '| sbd (best-of-sweep) | 0.8000 |' in printed
  assert ('(headline)' in printed) == (case != 'no_headline')
  if case == 'missing_run':
    assert rows[1] == {'id': 'run_b'}
    assert '| sbd (best-of-sweep) | 0.8000 | — |' in printed
