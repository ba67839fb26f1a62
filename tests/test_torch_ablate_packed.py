"""The port's packed-channel ablation (rec_attend_tpu_torch/pipelines/
ablate_packed.py) against the JAX package's script: with the experiment
replaced by a recorder, both build the same twin config, train config and
data config from a baseline's snapshots, restore the twin only with
``--resume`` over its own checkpoint, and print and write the same table
of the logged curves; on the committed synth3 baseline and its twin's
logs as well."""

import json
import os
import sys

import numpy as np
import pytest
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu_torch.pipelines import ablate_packed

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
from pipelines import ablate_packed as jablate  # noqa: E402

JAX_ONLY = {'use_pallas'}


def _make_baseline(results, logs, mid):
  folder = os.path.join(results, mid)
  os.makedirs(folder, exist_ok=True)
  data_cfg = JC.DataConfig(dataset='synthcs', height=64, width=64,
                           timespan=6, num_examples=8, max_objects=4,
                           num_semantic_classes=3)
  box_cfg = JC.tiny_box_config(timespan=6, add_d_out=True, add_y_out=True,
                               num_semantic_classes=3)
  with open(os.path.join(folder, 'data_opt.yaml'), 'w') as f:
    yaml.safe_dump(data_cfg.to_dict(), f)
  with open(os.path.join(folder, 'model_opt.yaml'), 'w') as f:
    yaml.safe_dump(box_cfg.to_dict(), f)
  for m, rows in ((mid, 7), (mid.replace('box_model_', 'box_model_nofg_'),
                             3)):
    os.makedirs(os.path.join(logs, m), exist_ok=True)
    with open(os.path.join(logs, m, 'loss.csv'), 'w') as f:
      f.write('step,time,train loss,valid loss\n')
      for i in range(rows):
        f.write(f'{2 * i},t,{-0.1 * i - 0.013},\n')
    with open(os.path.join(logs, m, 'iou_soft_box.csv'), 'w') as f:
      f.write('step,time,train,valid\n')
      for i in range(rows):
        f.write(f'{2 * i},t,{0.1 * i + 0.017},{"" if i % 2 else 0.3 + i}\n')


def run_side(module, argv, monkeypatch, capsys, device=None):
  calls = []

  class Experiment:
    def __init__(self, kind, model_cfg, train_cfg, data_cfg, **kw):
      calls.append((kind, *(
          {k: v for k, v in c.to_dict().items() if k not in JAX_ONLY}
          for c in (model_cfg, train_cfg, data_cfg))))
      assert kw == ({} if device is None else {'device': device})

    def run(self):
      calls.append('run')

    def close(self):
      pass

  monkeypatch.setattr(module, 'TrainingExperiment', Experiment)
  table = (module.main(argv) if device is None
           else module.main(argv, device=device))
  monkeypatch.undo()
  return calls, table, capsys.readouterr().out


def both(argv, results, monkeypatch, capsys):
  twin = os.path.join(results, 'box_model_nofg_synthx', 'ablation.json')
  got = run_side(ablate_packed, argv, monkeypatch, capsys, device='cpu')
  with open(twin) as f:
    got_json = f.read()
  want = run_side(jablate, argv, monkeypatch, capsys)
  with open(twin) as f:
    assert f.read() == got_json
  assert got == want
  return got


@pytest.mark.parametrize('extra', [[], ['--dataset_folder', 'data/other']])
def test_twin_config_table_and_resume_as_jax(extra, tmp_path, monkeypatch,
                                             capsys):
  results, logs = str(tmp_path / 'res'), str(tmp_path / 'logs')
  _make_baseline(results, logs, 'box_model_synthx')
  argv = ['--baseline_id', 'box_model_synthx', '--results', results,
          '--logs', logs, '--steps', '4', '--batch_size', '2'] + extra
  twin = os.path.join(results, 'box_model_nofg_synthx')

  calls, table, printed = both(argv, results, monkeypatch, capsys)
  kind, model, train, data = calls[0]
  assert kind == 'box' and calls[1] == 'run'
  assert not model['add_d_out'] and not model['add_y_out']
  assert model['num_semantic_classes'] == 3
  assert train['model_id'] == 'box_model_nofg_synthx'
  assert train['restore'] is None
  assert data['folder'] == (extra[1] if extra else None)
  assert json.loads(printed) == table
  assert table['with_packed']['steps'] == 12
  assert table['no_packed']['final_loss_tail5'] == round(
      np.mean([-0.013, -0.113, -0.213]), 4)

  # --resume without a checkpoint of the twin: from scratch.
  assert both(argv + ['--resume'], results, monkeypatch,
              capsys)[0][0][2]['restore'] is None
  # --resume over the twin's checkpoint: restored from the twin's folder.
  np.savez(os.path.join(twin, 'ckpt-2.npz'), step=2)
  assert both(argv + ['--resume'], results, monkeypatch,
              capsys)[0][0][2]['restore'] == twin
  assert both(argv, results, monkeypatch,
              capsys)[0][0][2]['restore'] is None


def test_baselines_the_scripts_refuse(tmp_path, monkeypatch, capsys):
  results, logs = str(tmp_path / 'res'), str(tmp_path / 'logs')
  _make_baseline(results, logs, 'box_model_synthx')
  os.rename(os.path.join(results, 'box_model_synthx'),
            os.path.join(results, 'boxsynthx'))
  argv = ['--baseline_id', 'boxsynthx', '--results', results, '--logs',
          logs]
  for module, error in ((ablate_packed, ValueError),
                        (jablate, AssertionError)):
    with pytest.raises(error, match='must start with'):
      run_side(module, argv, monkeypatch, capsys)
  # A baseline without the packed channels.
  folder = os.path.join(results, 'box_model_plain')
  os.makedirs(folder)
  os.rename(os.path.join(results, 'boxsynthx', 'data_opt.yaml'),
            os.path.join(folder, 'data_opt.yaml'))
  with open(os.path.join(folder, 'model_opt.yaml'), 'w') as f:
    yaml.safe_dump(JC.tiny_box_config().to_dict(), f)
  argv[1] = 'box_model_plain'
  for module, error in ((ablate_packed, ValueError),
                        (jablate, AssertionError)):
    with pytest.raises(error, match='packed-channel'):
      run_side(module, argv, monkeypatch, capsys)


def test_the_committed_synth3_baseline_as_jax(tmp_path, monkeypatch,
                                              capsys):
  """The committed synth3 box run and its twin's logs: the same twin
  config and the same table (the committed ablation.json's values) from
  both scripts, written into a scratch results folder."""
  results = str(tmp_path / 'res')
  base = 'box_model_synth3-20260818a'
  os.makedirs(os.path.join(results, base))
  for name in ('data_opt.yaml', 'model_opt.yaml'):
    os.symlink(os.path.join(REPO, 'results', base, name),
               os.path.join(results, base, name))
  argv = ['--baseline_id', base, '--results', results, '--logs',
          os.path.join(REPO, 'logs'), '--steps', '12000']
  calls, table, _ = run_side(ablate_packed, argv, monkeypatch, capsys,
                             device='cpu')
  assert (calls, table) == run_side(jablate, argv, monkeypatch, capsys)[:2]
  with open(os.path.join(REPO, 'results', 'box_model_nofg_synth3-20260818a',
                         'ablation.json')) as f:
    assert table == json.load(f)
