"""The port's resume_synth_paper (rec_attend_tpu_torch/pipelines/
resume_synth_paper.py) against the JAX package's script: with the
experiment, the weights exports and the eval command line replaced by
recorders, both build the same box, full, train and data configs, export
the same weights and evaluate with the same arguments, for every lever,
``--skip_box``, ``--finetune_from`` and a relaunch over a full model's
checkpoint."""

import os
import sys

import numpy as np
import pytest

from rec_attend_tpu_torch.pipelines import resume_synth_paper

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
from pipelines import resume_synth_paper as jresume  # noqa: E402

# The JAX configs' options that the port's lack (its compiler switches).
JAX_ONLY = {'use_pallas', 'remat_policy', 'scan_unroll', 'mlp_dropout'}
BOX = 'box_model_synthx'
LEVERS = {
    'preset': [],
    'loss_mix_ratio': ['--loss_mix_ratio', '0.5'],
    'dtype': ['--dtype', 'bfloat16'],
    'segm_weight_alpha': ['--segm_weight_alpha', '0.5'],
    'dynamic_var': ['--dynamic_var'],
    'filter_size': ['--filter_size', '64'],
    'knob': ['--steps_per_knob_decay', '1400', '--knob_segm_offset', '6000'],
    'all_levers': ['--loss_mix_ratio', '2.0', '--dtype', 'float32',
                   '--segm_weight_alpha', '1.0', '--dynamic_var',
                   '--steps_per_knob_decay', '900', '--knob_segm_offset',
                   '100'],
    'skip_box': ['--skip_box'],
    'finetune_from': ['--skip_box', '--finetune_from', 'full_model_synthy',
                      '--segm_weight_alpha', '0.5'],
    'full_id_examples': ['--full_id', 'full_model_fresh', '--data_examples',
                         '1024', '--box_steps', '14000', '--full_steps',
                         '30000', '--dataset_folder', 'data/s1024'],
}


def plain(cfg):
  return {k: v for k, v in cfg.to_dict().items() if k not in JAX_ONLY}


class Recorder:
  """Stands for TrainingExperiment, read_weights and eval's full_main."""

  def __init__(self, results):
    self.results = results
    self.calls = []
    recorder = self

    class Experiment:
      def __init__(self, kind, model_cfg, train_cfg, data_cfg, device=None):
        recorder.calls.append(('experiment', kind, plain(model_cfg),
                               plain(train_cfg), plain(data_cfg)))
        self.step = 0

      def run(self):
        recorder.calls.append(('run',))

      def close(self):
        pass

    self.Experiment = Experiment

  def box_main(self, argv, device=None):
    self.calls.append(('box_main', argv))
    return os.path.join(self.results, argv[1], 'weights.h5')

  def full_main(self, argv, device=None):
    self.calls.append(('full_main', argv))
    return os.path.join(self.results, argv[1], 'weights.h5')

  def eval_main(self, argv, device=None):
    self.calls.append(('eval', argv))


def run_side(module, argv, results, monkeypatch, jax):
  rec = Recorder(results)
  monkeypatch.setattr(module, 'TrainingExperiment', rec.Experiment)
  monkeypatch.setattr(module.read_weights, 'box_main', rec.box_main)
  monkeypatch.setattr(module.read_weights, 'full_main', rec.full_main)
  monkeypatch.setattr(module.eval_cli, 'full_main', rec.eval_main)
  if jax:
    monkeypatch.setattr(sys, 'argv', ['resume_synth_paper'] + argv)
    module.main()
  else:
    assert module.main(argv, device='cpu') == [
        c for c in rec.calls if c[0] == 'experiment'][-1][3]['model_id']
  monkeypatch.undo()
  return rec.calls


@pytest.mark.parametrize('weights_kept', [False, True])
@pytest.mark.parametrize('full_ckpt', [False, True])
@pytest.mark.parametrize('lever', sorted(LEVERS))
def test_configs_as_jax(lever, full_ckpt, weights_kept, tmp_path,
                        monkeypatch):
  results = str(tmp_path / 'res')
  argv = ['--box_id', BOX, '--results', results, '--logs',
          str(tmp_path / 'logs')] + LEVERS[lever]
  full_id = (argv[argv.index('--full_id') + 1] if '--full_id' in argv
             else 'full_model_synthx')
  if full_ckpt:
    os.makedirs(os.path.join(results, full_id))
    np.savez(os.path.join(results, full_id, 'ckpt-2.npz'), step=2)
  if weights_kept:
    os.makedirs(os.path.join(results, BOX), exist_ok=True)
    open(os.path.join(results, BOX, 'weights.h5'), 'wb').close()
  got = run_side(resume_synth_paper, argv, results, monkeypatch, jax=False)
  want = run_side(jresume, argv, results, monkeypatch, jax=True)
  assert got == want
  kinds = [c[1] for c in got if c[0] == 'experiment']
  assert kinds == (['full'] if '--skip_box' in argv else ['box', 'full'])
  full = [c for c in got if c[0] == 'experiment'][-1]
  assert full[3]['restore'] == (os.path.join(results, full_id)
                                if full_ckpt else None)
  # A relaunch over its own checkpoint does not reset a finetune again.
  assert full[2]['finetune'] == (lever == 'finetune_from' and not full_ckpt)
  assert [c[0] for c in got].count('box_main') == (0 if weights_kept else 1)
  assert got[-1][0] == 'eval' and '--threshold_list' in got[-1][1]


def test_help_names_no_accelerator(capsys):
  with pytest.raises(SystemExit):
    resume_synth_paper.parse_args(['--help'])
  text = capsys.readouterr().out
  assert '--filter_size' in text and 'v5e' not in text and 'TPU' not in text
