"""The port's synth pipeline (box -> full -> eval) at ``--scale tiny``, and
its full model evaluated by the JAX package; and ``chip_smoke.py``'s
``pipeline`` phase at the tiny scale on the CPU (its gates pass and their
controls fail).

The port's ``run_pipeline`` trains the box model and the full model from
the box's ``weights.h5`` (its last checkpoint exported), 60 steps each (enough that the full model
finds instances: some SBD above 0, some predicted count), on the CPU, and
its eval command line writes the valid split's CSVs.  The JAX package's
``EvalExperiment`` then restores the port's full checkpoint and its
``eval_split`` runs over the same valid split (the port's in-memory
split, which has the interface JAX's eval reads): per example the SBD is
within 1e-3 of the port's CSV (the CSVs hold 4 decimals; the forwards
agree to float32 rounding) and the count error (``dic``) is equal.  JAX's
``TrainingExperiment`` restores the folder as the port wrote it and takes
a step.
"""

import csv
import os
import sys

import jax
import numpy as np
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.engine.experiment import EvalExperiment as JEval
from rec_attend_tpu.engine.experiment import TrainingExperiment as JTrain
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.pipelines import run_pipeline

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402
from rec_attend_tpu_torch.ops.cuda import glimpse as gk  # noqa: E402


def _rows(path):
  with open(path) as f:
    return {r[0]: float(r[1]) for r in csv.reader(f)
            if r and r[0].startswith('synth')}


STEPS = 60


def test_tiny_pipeline_evaluates_as_jax(tmp_path):
  results, logs = str(tmp_path / 'results'), str(tmp_path / 'logs')
  full_id = run_pipeline.main(
      ['--dataset', 'synth', '--scale', 'tiny', '--num_steps', str(STEPS),
       '--results', results, '--logs', logs], device='cpu')
  folder = os.path.join(results, full_id)
  box_id = full_id.replace('full_model', 'box_model')
  box_ckpt = os.path.join(results, box_id, f'ckpt-{STEPS}.npz')
  assert saver.latest_checkpoint(os.path.join(results, box_id)) == box_ckpt
  # The box is handed over as JAX hands it over: its last checkpoint
  # exported to the box folder's weights.h5.
  box_weights = os.path.join(results, box_id, 'weights.h5')
  cfg = C.FullModelConfig.from_yaml(os.path.join(folder, 'model_opt.yaml'))
  assert cfg.pretrain_ctrl_net == box_weights and cfg.use_knob
  assert saver.latest_checkpoint(folder).endswith(f'ckpt-{STEPS}.npz')
  got_dir = os.path.join(folder, 'output_valid')
  got_sbd = _rows(os.path.join(got_dir, 'sbd.csv'))
  got_dic = _rows(os.path.join(got_dir, 'dic.csv'))
  assert len(got_sbd) == len(got_dic) == 8

  # The JAX package's eval of the port's checkpoint on the same split.
  with open(os.path.join(folder, 'model_opt.yaml')) as f:
    jcfg = JC.FullModelConfig.from_dict(yaml.safe_load(f))
  data_cfg = C.DataConfig.from_yaml(os.path.join(folder, 'data_opt.yaml'))
  # The folder as the port wrote it: JAX reads its pretrain_ctrl_net, the
  # box's weights.h5, before the checkpoint sets every parameter.
  jexp = JEval('full', jcfg.replace(use_knob=False),
               JC.TrainConfig(restore=folder, batch_size=4, results=results),
               JC.DataConfig.from_dict(data_cfg.to_dict()),
               splits=['valid'])
  assert jexp.step == STEPS
  valid = provider.get('synth', data_cfg, split='valid')
  jexp.get_dataset = lambda split: valid
  want_dir = str(tmp_path / 'jax')
  jeval.eval_split(jexp, 'valid', want_dir, [0.3], jeval.DEFAULT_ANALYZERS,
                   render_output=False, batch_size=4)
  want_sbd = _rows(os.path.join(want_dir, 'sbd.csv'))
  want_dic = _rows(os.path.join(want_dir, 'dic.csv'))
  assert sorted(got_sbd) == sorted(want_sbd)
  for k in want_sbd:
    assert abs(got_sbd[k] - want_sbd[k]) <= 1e-3, k
    assert got_dic[k] == want_dic[k], k
  assert np.isfinite(list(got_sbd.values())).all()
  # The comparison compares found instances: some SBD above 0, and some
  # predicted count (dic is the predicted count less the true one).
  assert max(got_sbd.values()) > 0
  true_count = valid.get_batch(np.arange(len(got_dic)))['s_gt'].sum()
  assert sum(got_dic.values()) + true_count > 0

  # JAX's training run restores the port's folder, its options as written,
  # and trains on.
  jtrain = JC.TrainConfig(restore=folder, num_steps=STEPS + 1, batch_size=4,
                          results=results, logs=str(tmp_path / 'jax_logs'),
                          steps_per_valid=0, steps_per_trainval=0,
                          steps_per_plot=0, save_ckpt=False)
  jrun = JTrain('full', jcfg, jtrain,
                JC.DataConfig.from_dict(data_cfg.to_dict()))
  assert jrun.step == STEPS
  jrun.run()
  assert jrun.step == STEPS + 1
  for leaf in jax.tree_util.tree_leaves(jrun.params):
    assert np.isfinite(np.asarray(leaf)).all()


def test_chip_smoke_pipeline_phase_on_cpu():
  out, failures = cs.pipeline_phase(torch, gk, torch.device('cpu'),
                                    scale='tiny', examples=8, cli_examples=2)
  assert failures == []
  for stage in ('box', 'full'):
    assert out[stage]['checkpoints'] == [4, 6]
    assert sorted(out[stage]['step_ms_at_log']) == list(range(1, 7))
    for name in ('kept_gate', 'state_gate', 'yaml_gate'):
      assert out[stage][name]['failures'] == []
      assert out[stage][name]['control_failures']
  for gated in (out['box']['gather_gate'], out['full']['pretrained_gate'],
                out['full']['eval_step']['gate'], out['eval']['rows_gate'],
                out['eval']['flagship_cli']['gate'],
                out['restored']['state_gate'], out['restored']['step_gate']):
    assert gated['failures'] == [] and gated['control_failures']
  # On the CPU the kernel glimpses are the plain ones.
  assert max(out['full']['eval_step']['kernel_rel_diff'].values()) == 0
  assert out['eval']['flagship_cli']['sbd_mean'] > 0
  assert not any(out['plain_launches']['launches'].values())
  assert out['restored']['step'] == 6
  assert sorted(out['restored']['losses_after']) == [7, 8]
