"""The port stands alone: it imports neither JAX nor the JAX package (nor
h5py, cv2, PIL, optax or triton, which the machine with the card may lack),
reads
YAML only inside its YAML reader, and never falls back to the CPU by
itself.  Every module of the package is covered, the training path's
(losses, matching, boxes, augmentation, train step, trainer, the box
model, the orientation maps) and the eval path's (postprocess, analyzers,
eval experiment, eval_split) included, the Cityscapes eval's (the label
table, the full pack, the model-free eval, the instance AP and the pixel
eval) too, the training run's (the experiment, the checkpoint writer and
its YAML, the batch iterators, the command lines, the pipeline), the
weights files' (the HDF5 codec, the named weights, read_weights), and a
train step of each model (fg with momentum, box, full started from the
box), an eval_split, the fg -> pack -> full chain, the Cityscapes-shaped
chain to its AP and pixel eval, and the train command line, the synth
pipeline and the synthcs pipeline (to its ap.json and pixel_eval.json),
and Cityscapes from its polygons to the AP of its submission's files, and
the run tools (write_results, compare_runs, the packed-channel ablation),
run with those modules blocked."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import device as device_mod
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models.full_model import FullModel
from rec_attend_tpu_torch.serving import InstanceSegmenter

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
PACKAGE = os.path.join(REPO, 'rec_attend_tpu_torch')
BLOCKED = ('jax', 'jaxlib', 'rec_attend_tpu', 'yaml', 'h5py', 'cv2', 'PIL',
           'optax', 'triton')


def _port_sources():
  paths = [os.path.join(REPO, 'chip_smoke.py'),
           os.path.join(REPO, 'profile_port.py'),
           os.path.join(REPO, 'step_noise.py')]
  for root, _, files in os.walk(PACKAGE):
    paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
  return sorted(paths)


def _port_modules():
  mods = []
  for path in _port_sources():
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, '.')
    mods.append(rel[:-len('.__init__')] if rel.endswith('.__init__') else rel)
  return mods


def test_port_imports_with_those_modules_missing(tmp_path):
  script = textwrap.dedent(f"""
      import importlib, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      for mod in {_port_modules()!r}:
        importlib.import_module(mod)
      import torch
      from rec_attend_tpu_torch import config
      from rec_attend_tpu_torch.models.full_model import FullModel
      cfg = config.cvppp_full_config()
      assert cfg.glimpse_map_dim == 49
      model = FullModel(config.tiny_full_config(), device='cpu')
      out = model(torch.rand(1, 64, 64, 3))
      assert out['y_out'].shape == (1, 4, 64, 64)
      from rec_attend_tpu_torch.data.synthetic import synthetic_instances
      from rec_attend_tpu_torch.engine.trainer import Trainer
      cfg = config.tiny_full_config(use_knob=True, remat=True,
                                    rnd_hflip=True, rnd_transpose=True)
      trainer = Trainer(cfg, device='cpu')
      data = synthetic_instances(2, 64, 64, cfg.timespan, seed=1)
      history = trainer.run(1, iter([data]))
      assert trainer.step == 1 and history[0]['loss'] == history[0]['loss']
      # The chain's training: fg with momentum, box on packed channels, a
      # full model started from the box's controller.
      fg = Trainer(config.tiny_fg_config(add_orientation=True,
                                         dcnn_depth=(8, 4, 9),
                                         optimizer='momentum'), device='cpu')
      assert fg.run(1, iter([data]))[0]['orientation_acc'] >= 0
      assert sorted(fg.opt_state) == ['count', 'trace']
      packed = dict(data, d_in=torch.rand(2, 64, 64, 8),
                    y_in=torch.rand(2, 64, 64, 1))
      box = Trainer(config.tiny_box_config(add_d_out=True, add_y_out=True,
                                           remat=True), device='cpu')
      assert box.run(1, iter([packed]))[0]['iou_soft_box'] >= 0
      full = Trainer(config.tiny_full_config(
          add_d_out=True, add_y_out=True, ctrl_add_inp=True,
          ctrl_add_canvas=True, use_knob=True), device='cpu')
      full.load_pretrained(box.model)
      history = full.run(1, iter([packed]))
      assert full.step == 1 and history[0]['loss'] == history[0]['loss']
      # The eval path: a params-only checkpoint in the JAX layout, an
      # in-memory dataset, the postprocess chain and the analyzers.
      import os
      import numpy as np
      from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS, eval_split
      from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
      from rec_attend_tpu_torch.engine import saver
      from rec_attend_tpu_torch.engine.experiment import EvalExperiment
      cfg = config.tiny_full_config()
      state = FullModel(cfg, device='cpu').state_dict()
      names = saver.jax_leaf_order(state)
      folder = {str(tmp_path)!r}
      np.savez(os.path.join(folder, 'ckpt-7.npz'), num_leaves=len(names),
               **{{f'leaf_{{i}}': state[n].numpy()
                  for i, n in enumerate(names)}})
      exp = EvalExperiment(folder, cfg=cfg, device='cpu')
      ds = SyntheticDataset(3, 64, 64, cfg.timespan, seed=2)
      out = os.path.join(folder, 'out')
      summary = eval_split(exp, ds, out, [0.3, 0.5],
                           DEFAULT_ANALYZERS + ['ins_iou', 'count'],
                           batch_size=2, score_threshold=0.4)
      assert sorted(summary) == [0.3, 0.5] and len(summary[0.3]) == 14
      assert os.path.exists(os.path.join(out, 'count_50.csv'))
      # JAX's default matcher (the plain version on the CPU) and the host
      # solver of 'native'.
      from rec_attend_tpu_torch.ops import hungarian, matching
      torch.manual_seed(0)
      w, s_gt = torch.rand(3, 6, 6), torch.ones(3, 6)
      assert torch.equal(matching.f_segm_match(w, s_gt),
                         matching.f_segm_match(w, s_gt, matcher='native'))
      assert hungarian.hungarian(w)[1].shape == (3, 6, 1)
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_training_run_with_those_modules_missing(tmp_path):
  """The training run as users launch it, with JAX, cv2, h5py, YAML and the
  rest blocked: the train command line writes its checkpoints and option
  snapshots and goes on from them, and the synth pipeline trains the box
  model, the full model from the box's weights.h5 (the port's HDF5 codec
  writes and reads it), and evaluates it; the committed flagship box's
  weights.h5 reads."""
  script = textwrap.dedent(f"""
      import os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import torch
      torch.set_num_threads(1)
      from rec_attend_tpu_torch.cli import train
      from rec_attend_tpu_torch.pipelines import run_pipeline
      root = {str(tmp_path)!r}
      argv = ['--dataset', 'synth', '--num_steps', '2', '--batch_size', '2',
              '--results', os.path.join(root, 'r'), '--logs',
              os.path.join(root, 'l'), '--model_id', 'box_cli',
              '--save_ckpt', '--steps_per_valid', '1', '--num_batch_valid',
              '1', '--ctrl_cnn_depth', '4,8', '--ctrl_cnn_pool', '4,4',
              '--ctrl_cnn_filter_size', '3,3', '--ctrl_rnn_hid_dim', '16',
              '--filter_height', '8', '--filter_width', '8',
              '--num_ctrl_rnn_iter', '2']
      exp = train.box_main(argv, device='cpu')
      assert exp.step == 2
      exp = train.box_main(argv + ['--restore', exp.folder, '--num_steps',
                                   '3'], device='cpu')
      assert exp.step == 3
      full_id = run_pipeline.main(
          ['--dataset', 'synth', '--scale', 'tiny', '--num_steps', '1',
           '--results', os.path.join(root, 'r'), '--logs',
           os.path.join(root, 'l')], device='cpu')
      assert os.path.exists(os.path.join(root, 'r', full_id, 'output_valid',
                                         'sbd.csv'))
      # The trained folder's model_opt.yaml read without PyYAML.
      from rec_attend_tpu_torch.engine.experiment import EvalExperiment
      from rec_attend_tpu_torch.serving import InstanceSegmenter
      folder = os.path.join(root, 'r', full_id)
      exp = EvalExperiment(folder, device='cpu')
      assert exp.cfg.timespan == 6
      assert exp.cfg.pretrain_ctrl_net == os.path.join(
          root, 'r', full_id.replace('full_model', 'box_model'), 'weights.h5')
      from rec_attend_tpu_torch.utils import h5
      assert len(h5.read(exp.cfg.pretrain_ctrl_net)) > 0
      assert len(h5.read(os.path.join(
          'results', 'box_model_synth-20260816104712', 'weights.h5'))) == 708
      seg = InstanceSegmenter.from_checkpoint(folder, device='cpu')
      assert seg.predict(torch.rand(1, 64, 64, 3).numpy())['masks'].shape == (
          1, 6, 64, 64)
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
  """Without a card, the training run, its command lines and the pipeline
  raise unless asked for the CPU."""
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli import train
  from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
  from rec_attend_tpu_torch.pipelines import run_pipeline
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  out = ['--results', str(tmp_path / 'r'), '--logs', str(tmp_path / 'l')]
  with pytest.raises(RuntimeError, match='CUDA'):
    TrainingExperiment('fg', C.tiny_fg_config(), C.TrainConfig(
        results=out[1], logs=out[3]), C.DataConfig())
  for main in (train.full_main, train.box_main, train.fg_main):
    with pytest.raises(RuntimeError, match='CUDA'):
      main(out)
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_cli.full_main(['--results', os.path.join(REPO, 'results'),
                        '--model_id', 'full_model_synth-20260816104712',
                        '--dataset', 'synth'])
  with pytest.raises(RuntimeError, match='CUDA'):
    run_pipeline.main(['--dataset', 'synth'] + out)
  # Nothing was written before the refusal.
  assert not os.path.exists(out[1]) and not os.path.exists(out[3])


def test_chain_runs_with_those_modules_missing(tmp_path):
  """fg -> pack -> full with packed channels -> eval_split, on tiny
  configs and an in-memory dataset, with JAX, cv2, h5py, YAML and the rest
  blocked: params-only checkpoints in the JAX layout, configs given."""
  script = textwrap.dedent(f"""
      import os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import numpy as np
      from rec_attend_tpu_torch import config
      from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS, eval_split
      from rec_attend_tpu_torch.cli.pack import pack_fg
      from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
      from rec_attend_tpu_torch.engine import saver
      from rec_attend_tpu_torch.engine.experiment import EvalExperiment
      from rec_attend_tpu_torch.models.fg_model import FGModel
      from rec_attend_tpu_torch.models.full_model import FullModel

      def save(model, folder):
        state = model.state_dict()
        names = saver.jax_leaf_order(state)
        os.makedirs(folder)
        np.savez(os.path.join(folder, 'ckpt-3.npz'), num_leaves=len(names),
                 **{{f'leaf_{{i}}': state[n].numpy()
                    for i, n in enumerate(names)}})

      root = {str(tmp_path)!r}
      fg_cfg = config.tiny_fg_config(add_orientation=True,
                                     dcnn_depth=(8, 4, 9))
      full_cfg = config.tiny_full_config(add_d_out=True, add_y_out=True)
      save(FGModel(fg_cfg, device='cpu'), os.path.join(root, 'fg'))
      save(FullModel(full_cfg, device='cpu'), os.path.join(root, 'full'))
      fg = EvalExperiment(os.path.join(root, 'fg'), cfg=fg_cfg, device='cpu',
                          spec='fg')
      ds = SyntheticDataset(3, 64, 64, full_cfg.timespan, seed=2)
      packed = pack_fg(fg, ds, 2)
      batch = packed.get_batch([0, 2], timespan=full_cfg.timespan)
      assert batch['d_out'].shape == (2, 64, 64, 8)
      assert batch['y_out'].shape == (2, 64, 64, 1)
      full = EvalExperiment(os.path.join(root, 'full'), cfg=full_cfg,
                            device='cpu')
      out = os.path.join(root, 'out')
      summary = eval_split(full, packed, out, [0.4], DEFAULT_ANALYZERS,
                           batch_size=2, score_threshold=0.15)
      assert len(summary[0.4]) == len(DEFAULT_ANALYZERS)
      assert os.path.exists(os.path.join(out, 'sbd.csv'))
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_h5_datasets_run_with_those_modules_missing(tmp_path):
  """The layout fixtures of chip_smoke.py, cli.setup_dataset, the JAX-written
  synthetic H5 read, and the KITTI pipeline (fg -> pack into the H5 -> box
  -> full -> eval) with the tiny models, with JAX, cv2, h5py, PIL, YAML
  and the rest blocked."""
  script = textwrap.dedent(f"""
      import os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      sys.path.insert(0, 'tests')
      import chip_smoke as cs
      from _small_h5_models import small_models
      from rec_attend_tpu_torch.cli import setup_dataset
      from rec_attend_tpu_torch.data import provider
      from rec_attend_tpu_torch.data.synthetic import SyntheticH5
      from rec_attend_tpu_torch.pipelines import run_pipeline

      assert cs.jax_h5_digest(SyntheticH5(cs.JAX_SYNTH_H5)) == (
          cs.JAX_SYNTH_DIGEST)
      root = {str(tmp_path)!r}
      data = os.path.join(root, 'data')
      cs.kitti_fixture(data, {{'train': 4, 'valid': 2}}, 40, 124, 1)
      setup_dataset.main(['--dataset', 'kitti', '--folder', data,
                          '--height', '64', '--width', '64'])
      with small_models('kitti'):
        got = run_pipeline.main(
            ['--dataset', 'kitti', '--scale', 'tiny', '--num_steps', '2',
             '--dataset_folder', data, '--results',
             os.path.join(root, 'results'), '--logs',
             os.path.join(root, 'logs')], device='cpu')
        cfg = run_pipeline.CHAINS['kitti'][1]('tiny', dataset_folder=data)[0]
      assert got['stages'] == ['fg', 'pack', 'box', 'full', 'eval']
      assert provider.has_pack(cfg, 'valid')
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_cityscapes_pipeline_runs_with_those_modules_missing(tmp_path):
  """Cityscapes as users launch it: chip_smoke.py's layout fixture,
  data.cityscapes_prep, cli.setup_dataset and the pipeline (fg -> pack ->
  box -> full -> full_pack -> cityscapes_eval of valid and test) with the
  tiny models, then the official AP on the valid submission's files, with
  JAX, cv2, h5py, PIL, YAML and the rest blocked."""
  script = textwrap.dedent(f"""
      import os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      sys.path.insert(0, 'tests')
      import chip_smoke as cs
      from _small_h5_models import small_models
      from rec_attend_tpu_torch.cli import setup_dataset
      from rec_attend_tpu_torch.data import cityscapes_prep
      from rec_attend_tpu_torch.eval_cityscapes import instance_eval
      from rec_attend_tpu_torch.pipelines import run_pipeline

      root = {str(tmp_path)!r}
      data = os.path.join(root, 'data')
      cs.cityscapes_fixture(data, {{'train': 4, 'valid': 2, 'test': 2}},
                            128, 256, 3)
      assert cityscapes_prep.main(['--dataset', data]) == 8
      setup_dataset.main(['--dataset', 'cityscapes', '--folder', data,
                          '--splits', 'train,valid,test', '--height', '64',
                          '--width', '64'])
      results = os.path.join(root, 'results')
      with small_models('cityscapes'):
        got = run_pipeline.main(
            ['--dataset', 'cityscapes', '--scale', 'tiny', '--num_steps',
             '2', '--dataset_folder', data, '--results', results, '--logs',
             os.path.join(root, 'logs')], device='cpu')
      assert got['stages'] == list(run_pipeline.CITYSCAPES_STAGES)
      ap = instance_eval.main([
          '--predictions', os.path.join(results, got['full'],
                                        'output_valid', 'cityscapes'),
          '--dataset', data, '--split', 'val'])
      assert 'allAp' in ap
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_h5_pipeline_entry_points_default_to_cuda(monkeypatch, tmp_path):
  """Without a card, the H5 datasets' pipeline raises unless asked for the
  CPU, before it trains anything."""
  from rec_attend_tpu_torch.cli import setup_dataset
  from rec_attend_tpu_torch.pipelines import run_pipeline
  sys.path.insert(0, REPO)
  import chip_smoke as cs
  data = str(tmp_path / 'data')
  cs.cvppp_fixture(data, 5, 40, 30, 1)
  setup_dataset.main(['--dataset', 'cvppp', '--folder', data, '--height',
                      '64', '--width', '64'])
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    run_pipeline.main(['--dataset', 'cvppp', '--scale', 'tiny',
                       '--dataset_folder', data, '--results',
                       str(tmp_path / 'results'), '--logs',
                       str(tmp_path / 'logs')])
  assert not os.path.exists(str(tmp_path / 'results'))


def test_cityscapes_chain_runs_with_those_modules_missing(tmp_path):
  """The Cityscapes-shaped chain on tiny configs with 3 semantic channels:
  fg -> pack -> full -> pack_full -> the Cityscapes eval -> instance AP and
  pixel eval, with JAX, cv2, h5py, YAML and the rest blocked."""
  script = textwrap.dedent(f"""
      import os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import math
      import numpy as np
      from rec_attend_tpu_torch import config
      from rec_attend_tpu_torch.cli.cityscapes_eval import cityscapes_eval
      from rec_attend_tpu_torch.cli.pack import pack_fg, pack_full
      from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
      from rec_attend_tpu_torch.engine import saver
      from rec_attend_tpu_torch.engine.experiment import EvalExperiment
      from rec_attend_tpu_torch.eval_cityscapes import instance_eval
      from rec_attend_tpu_torch.eval_cityscapes import pixel_eval
      from rec_attend_tpu_torch.models.fg_model import FGModel
      from rec_attend_tpu_torch.models.full_model import FullModel

      def save(model, folder):
        state = model.state_dict()
        names = saver.jax_leaf_order(state)
        os.makedirs(folder)
        np.savez(os.path.join(folder, 'ckpt-3.npz'), num_leaves=len(names),
                 **{{f'leaf_{{i}}': state[n].numpy()
                    for i, n in enumerate(names)}})

      root = {str(tmp_path)!r}
      fg_cfg = config.tiny_fg_config(add_orientation=True,
                                     num_semantic_classes=3,
                                     dcnn_depth=(8, 4, 11))
      full_cfg = config.tiny_full_config(add_d_out=True, add_y_out=True,
                                         num_semantic_classes=3)
      assert full_cfg.acnn_inp_depth == 15
      save(FGModel(fg_cfg, device='cpu'), os.path.join(root, 'fg'))
      save(FullModel(full_cfg, device='cpu'), os.path.join(root, 'full'))
      fg = EvalExperiment(os.path.join(root, 'fg'), cfg=fg_cfg, device='cpu',
                          spec='fg')
      ds = SyntheticDataset(3, 64, 64, full_cfg.timespan, seed=2,
                            num_semantic_classes=2)
      packed = pack_fg(fg, ds, 2)
      assert packed.y_out.shape == (3, 64, 64, 3)
      full = EvalExperiment(os.path.join(root, 'full'), cfg=full_cfg,
                            device='cpu')
      packed = pack_full(full, packed, 2)
      batch = packed.get_batch([0, 2], timespan=full_cfg.timespan)
      assert batch['y_out_ins'].shape == (2, full_cfg.timespan, 64, 64)
      assert batch['s_out'].shape == (2, full_cfg.timespan)
      summary, rows = cityscapes_eval(
          packed, os.path.join(root, 'cs'), [0.2, 0.6], ['sbd'],
          remove_tiny=10, batch_size=2, device='cpu')
      assert sorted(summary) == [0.2, 0.6] and len(rows[0.2]) == 3
      assert os.path.exists(os.path.join(root, 'cs', 'sbd_20.csv'))
      ap = instance_eval.evaluate_instance_predictions(
          rows[0.2], ds.get_instance_id_images(ds.img_ids))
      assert sorted(ap) == ['allAp', 'allAp50%', 'classes']
      ev = pixel_eval.PixelEvaluator()
      for fg_bytes, ids in zip(packed.y_out,
                               ds.get_instance_id_images(ds.img_ids)):
        label, inst = pixel_eval.groundtruth_labels(ids)
        ev.add_pair(pixel_eval.prediction_labels(fg_bytes), label,
                    instance_img=inst)
      assert math.isfinite(ev.finalize()['meanIoU'])
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_cityscapes_entry_points_default_to_cuda(monkeypatch):
  """Without a card, the Cityscapes eval and the synthcs models raise
  unless asked for the CPU."""
  from rec_attend_tpu_torch.cli.cityscapes_eval import cityscapes_eval
  from rec_attend_tpu_torch.cli.pack import PackedDataset
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  ds = SyntheticDataset(1, 32, 32, 2, seed=1, num_semantic_classes=2)
  packed = PackedDataset(ds, np.zeros((1, 32, 32, 8), np.uint8),
                         np.zeros((1, 32, 32, 3), np.uint8),
                         np.zeros((1, 2, 32, 32), np.uint8),
                         np.zeros((1, 2), np.float32))
  with pytest.raises(RuntimeError, match='CUDA'):
    cityscapes_eval(packed, '/nonexistent')
  for spec, folder, cfg in (
      ('fg', 'fg_model_synthcs-20260818a', C.synthcs_fg_config()),
      ('full', 'full_model_synthcs-20260818a', C.synthcs_full_config())):
    with pytest.raises(RuntimeError, match='CUDA'):
      EvalExperiment(os.path.join(REPO, 'results', folder), cfg=cfg,
                     spec=spec)


def test_fg_entry_points_default_to_cuda(monkeypatch):
  """Without a card, the fg model and its eval experiment raise unless
  asked for the CPU."""
  from rec_attend_tpu_torch.models.fg_model import FGModel
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    FGModel(C.tiny_fg_config())
  FGModel(C.tiny_fg_config(), device='cpu')
  fg_folder = os.path.join(REPO, 'results', 'fg_model_synth3-20260818a')
  with pytest.raises(RuntimeError, match='CUDA'):
    EvalExperiment(fg_folder, cfg=C.kitti_fg_config(), spec='fg')


def test_the_matchers_modules_are_covered():
  """JAX's default matcher (``ops/hungarian.py``, its kernel's binding
  ``ops/cuda/hungarian.py``) and the host solver (``ops/native.py``) are
  among the modules imported with JAX blocked and the sources read below."""
  mods = _port_modules()
  for mod in ('ops.hungarian', 'ops.cuda.hungarian', 'ops.native',
              'ops.matching'):
    assert f'rec_attend_tpu_torch.{mod}' in mods, mod


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_nothing_blocked(path):
  """No import of a blocked module anywhere in the source; yaml only inside
  FullModelConfig.from_yaml."""
  with open(path) as f:
    tree = ast.parse(f.read())
  parents = {}
  for node in ast.walk(tree):
    for child in ast.iter_child_nodes(node):
      parents[child] = node
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or '']
    else:
      continue
    for name in names:
      top = name.split('.')[0]
      if top == 'yaml':
        fn = parents.get(node)
        assert isinstance(fn, ast.FunctionDef) and fn.name == 'from_yaml', (
            f'{path}:{node.lineno} imports yaml outside from_yaml')
      else:
        assert top not in BLOCKED, f'{path}:{node.lineno} imports {name}'


def test_entry_points_default_to_cuda(monkeypatch):
  """Without a card, the entry points raise unless asked for the CPU."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  cfg = C.tiny_full_config()
  with pytest.raises(RuntimeError, match='CUDA'):
    device_mod.resolve_device()
  with pytest.raises(RuntimeError, match='CUDA'):
    FullModel(cfg)
  with pytest.raises(RuntimeError, match='CUDA'):
    Trainer(cfg)
  for other in (C.tiny_box_config(), C.tiny_fg_config()):
    with pytest.raises(RuntimeError, match='CUDA'):
      Trainer(other)
    Trainer(other, device='cpu')
  params = FullModel(cfg, device='cpu').state_dict()
  with pytest.raises(RuntimeError, match='CUDA'):
    InstanceSegmenter(params, cfg)
  seg = InstanceSegmenter(params, cfg, device='cpu')
  out = seg.predict(np.zeros((1, 64, 64, 3), np.float32))
  assert out['masks'].shape == (1, 4, 64, 64)
  flagship = os.path.join(REPO, 'results', 'full_model_synth-20260816104712')
  with pytest.raises(RuntimeError, match='CUDA'):
    EvalExperiment(flagship, cfg=C.cvppp_full_config())


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
  """Without a card the script exits non-zero and prints no result, also
  when it stands alone in a directory."""
  env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
  for cwd, script in ((REPO, os.path.join(REPO, 'chip_smoke.py')),
                      (str(tmp_path), str(tmp_path / 'chip_smoke.py'))):
    if cwd != REPO:
      with open(os.path.join(REPO, 'chip_smoke.py')) as src:
        (tmp_path / 'chip_smoke.py').write_text(src.read())
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert proc.stdout == ''


def test_synth3_pipeline_runs_with_those_modules_missing(tmp_path):
  """The synth3 chain as users launch it, with JAX, cv2, h5py, YAML and
  the rest blocked: fg and its pack files in one invocation, box, full and
  the eval stage (the fg metrics, the full model's CSVs) in another."""
  script = textwrap.dedent(f"""
      import json, os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import torch
      torch.set_num_threads(1)
      from rec_attend_tpu_torch.data import provider
      from rec_attend_tpu_torch.pipelines import run_pipeline
      root = {str(tmp_path)!r}
      argv = ['--dataset', 'synth3', '--scale', 'tiny', '--num_steps', '2',
              '--results', os.path.join(root, 'r'), '--logs',
              os.path.join(root, 'l'), '--dataset_folder',
              os.path.join(root, 'd'), '--model_id', 'blocked']
      run_pipeline.main(argv + ['--stages', 'fg,pack'], device='cpu')
      data = dict(folder=os.path.join(root, 'd'), height=64, width=64,
                  timespan=6, num_examples=32, max_objects=4)
      assert isinstance(provider.get('synth', data, split='valid'),
                        provider.PackedDataset)
      out = run_pipeline.main(argv + ['--stages', 'box,full,eval'],
                              device='cpu')
      assert out['stages'] == ['box', 'full', 'eval']
      r = os.path.join(root, 'r')
      with open(os.path.join(r, out['fg'], 'fg_metrics_valid.json')) as f:
        assert json.load(f)['n'] == 8
      assert os.path.exists(os.path.join(r, out['full'], 'output_valid',
                                         'sbd_70.csv'))
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_synth3_entry_points_default_to_cuda(monkeypatch, tmp_path):
  """Without a card, the pack command line, the fg metrics and the synth3
  pipeline raise unless asked for the CPU, and write nothing first."""
  from rec_attend_tpu_torch.cli import pack
  from rec_attend_tpu_torch.pipelines import eval_fg_metrics
  from rec_attend_tpu_torch.pipelines import run_pipeline
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  fg = ['--model_id', 'fg_model_synth3-20260818a', '--results',
        os.path.join(REPO, 'results'), '--dataset_folder',
        str(tmp_path / 'd')]
  with pytest.raises(RuntimeError, match='CUDA'):
    pack.fg_main(fg + ['--dataset', 'synth', '--split', 'valid'])
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_fg_metrics.main(fg)
  out = ['--results', str(tmp_path / 'r'), '--logs', str(tmp_path / 'l'),
         '--dataset_folder', str(tmp_path / 'd')]
  with pytest.raises(RuntimeError, match='CUDA'):
    run_pipeline.main(['--dataset', 'synth3', '--scale', 'tiny'] + out)
  assert not os.listdir(tmp_path)


def test_synthcs_pipeline_with_those_modules_missing(tmp_path):
  """The synthcs chain as users launch it, with JAX, cv2, h5py, YAML and
  the rest blocked: fg, pack, box, full, eval, the full model's pack with
  its AP and the pixel eval write their files."""
  script = textwrap.dedent(f"""
      import json, os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import torch
      torch.set_num_threads(1)
      from rec_attend_tpu_torch.pipelines import run_pipeline
      root = {str(tmp_path)!r}
      out = run_pipeline.main(
          ['--dataset', 'synthcs', '--scale', 'tiny', '--num_steps', '2',
           '--results', os.path.join(root, 'r'), '--logs',
           os.path.join(root, 'l'), '--dataset_folder',
           os.path.join(root, 'd'), '--model_id', 'blocked'], device='cpu')
      assert out['stages'] == list(run_pipeline.SYNTHCS_STAGES), out
      folder = os.path.join(root, 'r', out['full'], 'output_valid')
      for name in ('ap.json', 'pixel_eval.json', 'sbd_40.csv'):
        assert os.path.exists(os.path.join(folder, name)), name
      with open(os.path.join(folder, 'ap.json')) as f:
        assert sorted(json.load(f)) == ['aps', 'averages']
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_only_the_plots_import_matplotlib():
  """matplotlib, which the machine with the card may lack, is imported by
  utils/plot_utils.py alone, which the train command line imports only to
  plot."""
  importers = []
  for path in _port_sources():
    with open(path) as f:
      tree = ast.parse(f.read())
    for node in ast.walk(tree):
      names = ([a.name for a in node.names] if isinstance(node, ast.Import)
               else [node.module or ''] if isinstance(node, ast.ImportFrom)
               else [])
      if any(n.split('.')[0] == 'matplotlib' for n in names):
        importers.append(os.path.relpath(path, REPO))
  assert sorted(set(importers)) == [
      os.path.join('rec_attend_tpu_torch', 'utils', 'plot_utils.py')]


def test_calibration_and_fg_eval_default_to_cuda(monkeypatch, tmp_path):
  """Without a card, count_diag, calibrate_count and the fg eval raise
  unless asked for the CPU, and write nothing first (on a copy of the
  flagship's folder: both write into the model's folder)."""
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.pipelines import calibrate_count
  from rec_attend_tpu_torch.pipelines import count_diag
  flagship = 'full_model_synth-20260816104712'
  folder = tmp_path / 'r' / flagship
  folder.mkdir(parents=True)
  for name in ('ckpt-30000.npz', 'model_opt.yaml'):
    os.symlink(os.path.join(REPO, 'results', flagship, name), folder / name)
  before = sorted(os.listdir(folder))
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  argv = ['--model_id', flagship, '--results', str(tmp_path / 'r'),
          '--dataset_folder', str(tmp_path / 'd')]
  for main in (count_diag.main, calibrate_count.main):
    with pytest.raises(RuntimeError, match='CUDA'):
      main(argv)
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_cli.fg_main(['--model_id', 'fg_model_synth3-20260818a', '--results',
                      os.path.join(REPO, 'results'), '--dataset', 'synth',
                      '--output', str(tmp_path / 'fg')])
  assert sorted(os.listdir(folder)) == before
  assert sorted(os.listdir(tmp_path)) == ['r']


def test_run_tools_with_those_modules_missing(tmp_path):
  """The run tools with JAX, cv2, h5py, YAML and the rest blocked:
  write_results over the committed folders (the head and a section),
  compare_runs with --notes, and the packed-channel ablation training its
  twin of a tiny box run for one step."""
  script = textwrap.dedent(f"""
      import json, os, sys
      BLOCKED = {BLOCKED!r}

      class Block:
        def find_spec(self, name, path=None, target=None):
          if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ModuleNotFoundError(f'blocked: {{name}}')
          return None

      sys.meta_path.insert(0, Block())
      import torch
      torch.set_num_threads(1)
      from rec_attend_tpu_torch import config
      from rec_attend_tpu_torch.pipelines import ablate_packed
      from rec_attend_tpu_torch.pipelines import compare_runs
      from rec_attend_tpu_torch.pipelines import resume_synth_paper
      from rec_attend_tpu_torch.pipelines import write_results
      root = {str(tmp_path)!r}
      out = os.path.join(root, 'RESULTS.md')
      write_results.main(['--full_id', 'full_model_synth-20260816104712',
                          '--box_id', 'box_model_synth-20260816104712',
                          '--out', out])
      write_results.main(['--section', 'synth3',
                          '--fg_id', 'fg_model_synth3-20260818a',
                          '--box_id', 'box_model_synth3-20260818a',
                          '--full_id', 'full_model_synth3-20260818a',
                          '--out', out])
      doc = open(out).read()
      assert doc.startswith('# RESULTS') and 'KITTI shape' in doc
      assert 'TPU' not in doc
      notes = os.path.join(root, 'n', 'notes.md')
      rows = compare_runs.main(['--ids', 'full_model_synth1024-20260816,'
                                'full_model_synth1024bf16-r5',
                                '--notes', notes])
      assert len(rows) == 2 and '### Run comparison' in open(notes).read()
      assert resume_synth_paper.parse_args(['--box_id', 'b']).box_steps == (
          12000)
      base = os.path.join(root, 'r', 'box_model_tiny')
      os.makedirs(base)
      config.DataConfig(dataset='synth', height=64, width=64, timespan=6,
                        num_examples=8, max_objects=4).save_yaml(
                            os.path.join(base, 'data_opt.yaml'))
      config.tiny_box_config(timespan=6, add_d_out=True,
                             add_y_out=True).save_yaml(
                                 os.path.join(base, 'model_opt.yaml'))
      table = ablate_packed.main(
          ['--baseline_id', 'box_model_tiny', '--results',
           os.path.join(root, 'r'), '--logs', os.path.join(root, 'l'),
           '--steps', '1', '--batch_size', '2', '--dataset_folder',
           os.path.join(root, 'data')], device='cpu')
      assert table['no_packed']['steps'] == 1, table
      assert table['with_packed']['steps'] is None
      assert os.path.exists(os.path.join(root, 'r', 'box_model_nofg_tiny',
                                         'ablation.json'))
      leaked = [m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
      assert not leaked, leaked
      print('ok')
      """)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


def test_run_tools_default_to_cuda(monkeypatch, tmp_path):
  """Without a card, the tools that train raise unless asked for the CPU,
  before they write anything."""
  from rec_attend_tpu_torch.pipelines import ablate_packed
  from rec_attend_tpu_torch.pipelines import resume_synth_paper
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  results, logs = str(tmp_path / 'r'), str(tmp_path / 'l')
  base = os.path.join(results, 'box_model_tiny')
  os.makedirs(base)
  C.DataConfig(dataset='synth', height=64, width=64).save_yaml(
      os.path.join(base, 'data_opt.yaml'))
  C.tiny_box_config(add_d_out=True, add_y_out=True).save_yaml(
      os.path.join(base, 'model_opt.yaml'))
  with pytest.raises(RuntimeError, match='CUDA'):
    ablate_packed.main(['--baseline_id', 'box_model_tiny', '--results',
                        results, '--logs', logs])
  with pytest.raises(RuntimeError, match='CUDA'):
    resume_synth_paper.main(['--box_id', 'box_model_tiny', '--results',
                             results, '--logs', logs])
  assert os.listdir(results) == ['box_model_tiny']
  assert sorted(os.listdir(base)) == ['data_opt.yaml', 'model_opt.yaml']
  assert not os.path.exists(logs)
