"""The port's plots, dashboard and profiling against the JAX package's.

1. ``plot_experiment_samples`` of each model (full, box, fg) with the same
   parameters and batch as JAX's: the catalog lines it registers, and the
   arrays handed to each ``plot_*`` function (captured here in place of
   matplotlib), within the forward's tolerance.  The full model's are its
   eval forward's 'x_patch', 'glimpse_map', 'attn_top_left' and
   'attn_bot_right', which the port returns in eval only.
2. The train command line plots on its cadence (real matplotlib PNGs in
   the logs folder and the catalog) and, without matplotlib, trains on
   with a warning and no image registered; ``dashboard.generate`` of that folder, and of a folder with
   every kind of catalog entry, writes JAX's ``index.html`` bytes.
3. ``StepCounter`` and ``StepTimer`` as JAX's; ``profiling.trace`` writes a
   Chrome trace of the block on the CPU.
"""

import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu.engine.saver import load_pytree
from rec_attend_tpu.utils import dashboard as jdashboard
from rec_attend_tpu.utils import log_manager as jlog_manager
from rec_attend_tpu.utils import plot_utils as jplot_utils
from rec_attend_tpu.utils import profiling as jprofiling
from rec_attend_tpu.utils import step_counter as jstep_counter
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.cli import train as train_cli
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.models import full_model
from rec_attend_tpu_torch.utils import dashboard
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import plot_utils
from rec_attend_tpu_torch.utils import profiling
from rec_attend_tpu_torch.utils import step_counter

torch.set_num_threads(1)

SIZE = 32
T = 3
GLIMPSE = dict(inp_height=SIZE, inp_width=SIZE, filter_height=8,
               filter_width=8, timespan=T)
SPECS = {
    'full': (C.tiny_full_config(use_knob=True, **GLIMPSE),
             JC.tiny_full_config(use_knob=True, **GLIMPSE)),
    'box': (C.tiny_box_config(**GLIMPSE), JC.tiny_box_config(**GLIMPSE)),
    'fg': (C.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9),
                            inp_height=SIZE, inp_width=SIZE),
           JC.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9),
                             inp_height=SIZE, inp_width=SIZE)),
}
PLOTS = ('plot_input', 'plot_output', 'plot_total_instances',
         'plot_thumbnails', 'plot_double_attention')
# The eval forwards of the two packages in float32 (the full model's masks
# pass through T steps of feedback).
ATOL = 1e-4


def _capture(monkeypatch, module, calls):
  for name in PLOTS:
    def record(fname, *arrays, _name=name, **kw):
      calls.append((_name, os.path.basename(fname), arrays, kw))
    monkeypatch.setattr(module, name, record)


def _port_experiment(root, spec, **train):
  cfg, _ = SPECS[spec]
  train_cfg = C.TrainConfig(
      num_steps=0, batch_size=2, results=str(root / 'results'),
      logs=str(root / 'logs'), model_id=f'{spec}_plot', num_samples_plot=3,
      **train)
  data_cfg = C.DataConfig(dataset='synth', height=SIZE, width=SIZE,
                          timespan=T, num_examples=8,
                          folder=str(root / 'data'))
  return TrainingExperiment(spec, cfg, train_cfg, data_cfg, device='cpu')


def _jax_params(port, spec):
  """The port model's parameters in the JAX package's tree."""
  state = port.trainer.model.state_dict()
  names = saver.jax_leaf_order(state)
  path = os.path.join(port.folder, 'params.npz')
  np.savez(path, num_leaves=len(names),
           **{f'leaf_{i}': state[n].numpy() for i, n in enumerate(names)})
  jspec = jexp_lib.get_model_spec(spec)
  like = jax.eval_shape(lambda k: jspec.init_fn(k, SPECS[spec][1]),
                        jax.random.PRNGKey(0))
  return load_pytree(path, like)


@pytest.mark.parametrize('spec', ['full', 'box', 'fg'])
def test_plot_samples_match_jax(tmp_path, monkeypatch, spec):
  port = _port_experiment(tmp_path / 'port', spec)
  ds = port.train_ds
  raw = ds.get_batch(np.arange(4), timespan=T)
  jspec = jexp_lib.get_model_spec(spec)
  port.train_iter = iter([{dst: raw[src] for src, dst in
                           port.spec.batch_map.items() if src in raw}])
  jax_folder = str(tmp_path / 'jax_logs')
  jexp = types.SimpleNamespace(
      logs_folder=jax_folder, key=jax.random.PRNGKey(0),
      train_iter=iter([{dst: raw[src] for src, dst in
                        jspec.batch_map.items() if src in raw}]),
      train_cfg=JC.TrainConfig(num_samples_plot=3), spec=jspec,
      params=_jax_params(port, spec), model_cfg=SPECS[spec][1],
      log_manager=jlog_manager.LogManager(jax_folder))
  got, want = [], []
  _capture(monkeypatch, plot_utils, got)
  _capture(monkeypatch, jplot_utils, want)
  plot_utils.plot_experiment_samples(port, spec)
  jplot_utils.plot_experiment_samples(jexp, spec)
  assert [c[:2] for c in got] == [c[:2] for c in want]
  assert len(got) == {'full': 5, 'box': 3, 'fg': 2}[spec]
  for (name, fname, g_arrays, g_kw), (_, _, w_arrays, w_kw) in zip(got,
                                                                    want):
    assert g_kw == w_kw
    g_flat = jax.tree_util.tree_leaves(g_arrays)
    w_flat = jax.tree_util.tree_leaves(w_arrays)
    assert len(g_flat) == len(w_flat), name
    for g, w in zip(g_flat, w_flat):
      g, w = np.asarray(g), np.asarray(w)
      assert g.shape == w.shape and len(g) == 3, (name, g.shape, w.shape)
      np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                 err_msg=f'{name} {fname}')
  catalog = [line for line in open(os.path.join(port.logs_folder, 'catalog'))
             if ',image,' in line]
  assert catalog == [line for line in open(os.path.join(jax_folder,
                                                         'catalog'))
                     if ',image,' in line]
  assert len(catalog) == len(got)
  if spec == 'full':
    # Only the plot hook asks for what the plots read: an eval pass of a
    # run builds none of it.
    batch = ts.decode_batch({
        k: torch.as_tensor(np.asarray(raw[src]))
        for src, k in port.spec.batch_map.items()
        if k in port.trainer.family.batch_keys and src in raw})
    with torch.no_grad():
      outputs, _ = full_model.full_model_train_forward(
          port.trainer.model, batch['x'], batch['y_gt'], batch['s_gt'], None,
          0, train=False)
    assert 'y_out' in outputs and not {
        'x_patch', 'glimpse_map', 'attn_top_left', 'attn_bot_right'} & set(
            outputs)


def _cli_argv(root, *extra):
  return ['--dataset', 'synth', '--num_steps', '2', '--batch_size', '2',
          '--results', str(root / 'r'), '--logs', str(root / 'l'),
          '--model_id', 'fg_cli', '--steps_per_plot', '2',
          '--num_samples_plot', '2', '--cnn_depth', '4,8', '--cnn_pool',
          '2,2', '--dcnn_depth', '4,1', '--dcnn_pool', '2,2', *extra]


def test_train_command_line_plots_and_the_dashboard_matches_jax(tmp_path):
  exp = train_cli.fg_main(_cli_argv(tmp_path), device='cpu')
  assert exp.step == 2
  logs = exp.logs_folder
  catalog = open(os.path.join(logs, 'catalog')).read().splitlines()
  assert [line for line in catalog if ',image,' in line] == [
      'input.png,image,input', 'output.png,image,output']
  for name in ('input.png', 'output.png'):
    with open(os.path.join(logs, name), 'rb') as f:
      assert f.read(8) == b'\x89PNG\r\n\x1a\n'
  # The dashboard of that folder, with an entry of every other kind: a
  # CSV of empty cells, a text file, a missing file.
  with open(os.path.join(logs, 'notes.txt'), 'w') as f:
    f.write('<b>a & b</b>\n' * 3)
  with open(os.path.join(logs, 'empty.csv'), 'w') as f:
    f.write('step,time,a,b\n0,1,,\n2,3,x,\n')
  with open(os.path.join(logs, 'catalog'), 'a') as f:
    f.write('notes.txt,plain,notes, with a comma\nempty.csv,csv,empty\n'
            'gone.png,image,gone\n')
  jax_copy = str(tmp_path / 'jax_logs' / 'fg_cli')
  shutil.copytree(logs, jax_copy)
  got = dashboard.generate(logs)
  want = jdashboard.generate(jax_copy)
  assert got == os.path.join(logs, 'index.html')
  with open(got, 'rb') as f, open(want, 'rb') as g:
    assert f.read() == g.read()
  with open(got) as f:
    page = f.read()
  assert page.count('<svg') >= 2 and page.count('data:image/png') == 2


def test_without_matplotlib_a_plot_warns_and_training_goes_on(
    tmp_path, monkeypatch):
  """As on a machine without matplotlib: the hook logs the failure,
  registers no image, and the run takes its steps."""
  def missing():
    raise ModuleNotFoundError("No module named 'matplotlib'")
  monkeypatch.setattr(plot_utils, '_pyplot', missing)
  warned = []
  monkeypatch.setattr(logger.get(), 'warning',
                      lambda msg, *a, **kw: warned.append(msg))
  exp = train_cli.fg_main(_cli_argv(tmp_path), device='cpu')
  assert exp.step == 2
  assert warned == ["plotting failed: No module named 'matplotlib'"]
  with open(os.path.join(exp.logs_folder, 'catalog')) as f:
    assert ',image,' not in f.read()


def test_step_counter_and_timer_match_jax(monkeypatch):
  for mod in (step_counter, jstep_counter):
    c = mod.StepCounter(3)
    assert c.get() == 3 and c.increment() == 4 and c.increment(5) == 9
    c.reset()
    assert c.get() == 0
  summaries = []
  for mod in (profiling, jprofiling):
    times = iter([1.0, 1.25, 2.0, 2.5, 3.0, 3.125])
    monkeypatch.setattr(mod.time, 'perf_counter', lambda: next(times))
    timer = mod.StepTimer()
    assert timer.summary() == {}
    for _ in range(3):
      timer.start()
      timer.stop()
    timer.stop()
    summaries.append(timer.summary())
  assert summaries[0] == summaries[1] and summaries[0]['n'] == 3
  assert summaries[0]['mean_ms'] == pytest.approx(1000 * 0.875 / 3)


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
  a = torch.rand(16, 16)
  with profiling.trace(str(tmp_path / 'trace')):
    (a @ a).sum()
  path = tmp_path / 'trace' / profiling.TRACE_NAME
  with open(path) as f:
    events = json.load(f)['traceEvents']
  assert any(e.get('name') == 'aten::mm' for e in events)
