"""Small models for the CVPPP and KITTI pipelines on the CPU.

``run_pipeline --dataset cvppp|kitti`` trains the paper presets at both
scales (224x224 and 128x448, T=21 and 20), too large for the CPU tests.
Inside ``small_models(...)`` the configs functions of those chains in
``run_pipeline.CHAINS`` give the synth pipelines' tiny models instead, on
splits assembled at 64x64 (``cli.setup_dataset --height 64 --width 64``)
with T=6; the steps and the folders stay those of the command line.
Imports neither JAX nor cv2, h5py or PIL.
"""

import contextlib

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.pipelines import run_pipeline

HEIGHT = WIDTH = 64
TIMESPAN = 6


def small(configs):
  """``configs`` (a chain's configs function) with the tiny models."""
  def small_configs(scale, results='results', logs='logs',
                    dataset_folder=None, num_steps=None, data_examples=None,
                    fg_steps=None, box_steps=None, full_steps=None):
    data_cfg, fg_cfg, _, _, _, steps, _ = configs(
        scale, results, logs, dataset_folder, num_steps, data_examples,
        fg_steps, box_steps, full_steps)
    data_cfg = data_cfg.replace(height=HEIGHT, width=WIDTH,
                                timespan=TIMESPAN)
    if fg_cfg is None:
      box_cfg = C.tiny_box_config(timespan=TIMESPAN)
      full_base = C.tiny_full_config(timespan=TIMESPAN, use_knob=True)
      batch = {'box': 4, 'full': 4}
    else:
      _, fg_cfg, box_cfg, full_base, _, _, batch = (
          run_pipeline.synth3_stages('tiny'))
    first = 'box' if fg_cfg is None else 'fg'
    train_cfg = C.TrainConfig(
        num_steps=steps[first], batch_size=batch[first], save_ckpt=True,
        results=results, logs=logs,
        **run_pipeline._tiny_cadence(steps[first]))
    return data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps, batch
  return small_configs


@contextlib.contextmanager
def small_models(*datasets):
  """Inside the block, ``run_pipeline`` trains the tiny models on the
  chains of ``datasets`` (default: cvppp and kitti)."""
  chains = run_pipeline.CHAINS
  saved = {d: chains[d] for d in datasets or ('cvppp', 'kitti')}
  for d, entry in saved.items():
    chains[d] = (entry[0], small(entry[1])) + tuple(entry[2:])
  try:
    yield
  finally:
    chains.update(saved)
