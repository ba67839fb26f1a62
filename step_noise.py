#!/usr/bin/env python3
"""The float32 noise floor of chip_smoke.py's train-step gates, over several
batches.

    python3 step_noise.py [--batches 5] [--step 30000] [--batch 32]
    python3 step_noise.py --chain [--batches 5]
    python3 step_noise.py --box-repeats 8

Restores the flagship CVPPP checkpoint with its Adam state on one CUDA card
and, for each of several seeded synthetic batches and draws, runs
``chip_smoke.step_gates`` at the given global step: the plain-glimpse step,
the plain step whose einsums sum in other orders (the noise floor), the
kernel step and the step whose glimpse backward drops the filter gradients.
Prints one JSON line per batch with, for each pair, the loss difference,
the gradient errors (worst leaf, all leaves at once, median leaf), the
update error, how many examples' matchings differ and the forwards'
differences, then the card's name and power limit.  chip_smoke.py gates one
of these batches (seed 1000, draws seed 1); this script shows how the
statistics spread over others.

With ``--chain``, the same for the gates of chip_smoke.py's chain_train
phase, at b8 over synthetic 128x448 images: the synth3 fg checkpoint's step
card against CPU (b2) with its floor (the batch in the other order) and
controls (``chip_smoke.fg_step_gates``), the box checkpoint's step on the
fg model's packed maps, kernel against plain and card against CPU
(``box_step_gates``), and the KITTI full model's step at step 0 from the
box's controller, kernel against plain (``step_gates``).  Batch i is
examples 8i to 8i+7 of one seeded split; i = 0 is the batch that
chip_smoke.py gates.

With ``--box-repeats N``, chip_smoke.py's chain_train box card-against-CPU
gate N times over, each time on the pack of a fg model that took the
phase's five steps anew from ckpt-3000: N times with cuDNN's default
algorithms in those steps and twice with its deterministic ones.  Each
repeat prints the pack's digest, the gate (card against CPU, both float32)
and each side against the same step on the CPU in float64 (the exact
answer's stand-in), and whether the card's step repeats bit for bit.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import sys

import chip_smoke


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--batches', type=int, default=5)
  ap.add_argument('--step', type=int, default=30000)
  ap.add_argument('--batch', type=int, default=chip_smoke.TRAIN_BATCH)
  ap.add_argument('--chain', action='store_true',
                  help='the chain_train gates instead of the flagship step')
  ap.add_argument('--box-repeats', type=int, default=0,
                  help="chain_train's box card-against-CPU gate over this "
                       'many fg trainings')
  args = ap.parse_args()

  import torch
  if not torch.cuda.is_available():
    sys.exit('step_noise: CUDA is not available; this script runs on a card')
  if args.chain:
    chain_noise(torch, args.batches)
    return
  if args.box_repeats:
    box_repeats(torch, args.box_repeats)
    return
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = cvppp_full_config()
  trainer = Trainer(cfg, device='cuda')
  trainer.restore(chip_smoke.CHECKPOINT_DIR)
  lr = learn_rate(cfg, trainer.opt_state['count'])
  limits = (chip_smoke.STEP_LIMITS if args.step == 0
            else chip_smoke.OWN_CANVAS_LIMITS)
  keys = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
          'grad_rel_l2_median', 'update_rel_l2_max', 'matches_differ',
          'forward', 'failed')
  for i in range(args.batches):
    data = synthetic_instances(args.batch, cfg.inp_height, cfg.inp_width,
                               cfg.timespan, seed=1000 + i)
    batch = {k: v.to('cuda') for k, v in data.items()}
    draws = draw_train_randoms(cfg, args.batch,
                               torch.Generator('cuda').manual_seed(1 + i))
    gates, failures = chip_smoke.step_gates(
        torch, ts, matching, gk, trainer.model, trainer.opt_state, batch,
        draws, args.step, lr, limits)
    print(json.dumps({
        'batch_seed': 1000 + i, 'draws_seed': 1 + i, 'step': args.step,
        'batch': args.batch, 'limits': limits, 'failures': failures,
        'gates': {name: {k: v[k] for k in keys}
                  for name, v in gates.items()}}), flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


KEYS = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
        'grad_rel_l2_median', 'update_rel_l2_max', 'zero_grad_share_max',
        'zero_update_in_lr_max', 'matches_differ', 'forward', 'failed')


def chain_noise(torch, n):
  """The chain_train gates' statistics over n batches (module docstring)."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.config import kitti_box_config
  from rec_attend_tpu_torch.config import kitti_fg_config
  from rec_attend_tpu_torch.config import kitti_full_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.box_model import draw_box_randoms
  from rec_attend_tpu_torch.models.fg_model import draw_fg_randoms
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  fg_cfg, box_cfg, full_cfg = (kitti_fg_config(), kitti_box_config(),
                               kitti_full_config())
  b = chip_smoke.CHAIN_TRAIN_BATCH
  ds = SyntheticDataset(n * b, full_cfg.inp_height, full_cfg.inp_width,
                        full_cfg.timespan, seed=5,
                        max_objects=chip_smoke.CHAIN_MAX_OBJECTS)
  fg = Trainer(fg_cfg, device=dev)
  fg.restore(chip_smoke.CHAIN_FG_DIR)
  fg_exp = EvalExperiment(chip_smoke.CHAIN_FG_DIR, cfg=fg_cfg, device=dev,
                          spec='fg')
  with chip_smoke.deterministic_cudnn(torch):
    packed = chip_smoke.chain_batches(
        torch, pack_fg(fg_exp, ds, b).get_batch, chip_smoke.PACKED_KEYS, b, n)
  fg_data = chip_smoke.chain_batches(torch, ds.get_batch, chip_smoke.FG_KEYS,
                                     b, n)
  box = Trainer(box_cfg, device=dev)
  box.restore(chip_smoke.CHAIN_BOX_DIR)
  full = Trainer(full_cfg, device=dev)
  full.load_pretrained(box.model)
  for i in range(n):
    gen = lambda seed: torch.Generator(dev).manual_seed(seed + 10 * i)
    fg_batch = {k: v.to(dev) for k, v in next(fg_data).items()}
    batch = {k: v.to(dev) for k, v in next(packed).items()}
    stages = {
        'fg': chip_smoke.fg_step_gates(
            torch, ts, matching, fg.model, fg.opt_state, fg_batch,
            draw_fg_randoms(fg_cfg, gen(1)), fg.step,
            learn_rate(fg_cfg, fg.opt_state['count']),
            chip_smoke.FG_STEP_LIMITS),
        'box': chip_smoke.box_step_gates(
            torch, ts, matching, gk, box.model, box.opt_state, batch,
            draw_box_randoms(box_cfg, b, gen(2)), box.step,
            learn_rate(box_cfg, box.opt_state['count']),
            chip_smoke.BOX_STEP_LIMITS),
        'full': chip_smoke.step_gates(
            torch, ts, matching, gk, full.model, full.opt_state, batch,
            draw_train_randoms(full_cfg, b, gen(3)), 0,
            learn_rate(full_cfg, 0), chip_smoke.FULL_STEP_LIMITS)}
    print(json.dumps({
        'batch_index': i, 'examples': [i * b, (i + 1) * b - 1],
        'draws_seeds': [1 + 10 * i, 2 + 10 * i, 3 + 10 * i],
        'stages': {stage: {'failures': failures,
                           'gates': {name: {k: v[k] for k in KEYS if k in v}
                                     for name, v in gates.items()}}
                   for stage, (gates, failures) in stages.items()}}),
          flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


@contextlib.contextmanager
def float64_everywhere(torch):
  """Inside the block ``Tensor.float()`` gives float64 and new floating
  tensors are float64, so a model written for float32 runs in float64."""
  cast = torch.Tensor.float
  torch.Tensor.float = lambda self, *a, **kw: self.double()
  torch.set_default_dtype(torch.float64)
  try:
    yield
  finally:
    torch.Tensor.float = cast
    torch.set_default_dtype(torch.float32)


def float64_step(torch, ts, matching, model, opt_state, batch, draws, step,
                 pinned):
  """``chip_smoke.one_step`` on the CPU in float64 with the Hungarian
  answer ``pinned``, its floating results cast back to float32."""
  model = copy.deepcopy(model).to('cpu').double()
  model.device = torch.device('cpu')
  opt_state = {k: (v if k == 'count' else {n: t.cpu().double()
                                           for n, t in v.items()})
               for k, v in opt_state.items()}
  draws = {k: (v if k == 'aug' else v.cpu().double())
           for k, v in draws.items()}
  with float64_everywhere(torch):
    out = chip_smoke.one_step(torch, ts, matching, model, opt_state,
                              {k: v.cpu() for k, v in batch.items()}, draws,
                              step, 'kernel', pinned)

  def f32(t):
    return t.float() if torch.is_tensor(t) and t.is_floating_point() else t
  return tuple({k: f32(v) for k, v in x.items()} if isinstance(x, dict)
               else f32(x) for x in out)


def box_repeats(torch, n):
  """chain_train's box card-against-CPU gate over n + 2 fg trainings
  (module docstring)."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.config import kitti_box_config
  from rec_attend_tpu_torch.config import kitti_fg_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.box_model import draw_box_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  fg_cfg, box_cfg = kitti_fg_config(), kitti_box_config()
  b, nb = chip_smoke.CHAIN_TRAIN_BATCH, chip_smoke.CHAIN_TRAIN_CPU_BATCH
  examples = chip_smoke.CHAIN_TRAIN_EXAMPLES
  ds = SyntheticDataset(examples, box_cfg.inp_height, box_cfg.inp_width,
                        box_cfg.timespan, seed=5,
                        max_objects=chip_smoke.CHAIN_MAX_OBJECTS)
  box = Trainer(box_cfg, device=dev)
  box.restore(chip_smoke.CHAIN_BOX_DIR)
  lr = learn_rate(box_cfg, box.opt_state['count'])
  draws = draw_box_randoms(box_cfg, b, torch.Generator(dev).manual_seed(2))
  small_draws = {'aug': draws['aug'], 'segm_noise': draws['segm_noise'][:, :nb]}
  keys = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
          'grad_rel_l2_median', 'update_rel_l2_max', 'matches_differ',
          'failed')
  for i, mode in enumerate(['default'] * n + ['deterministic'] * 2):
    fg = Trainer(fg_cfg, device=dev)
    fg.restore(chip_smoke.CHAIN_FG_DIR)
    data = chip_smoke.chain_batches(torch, ds.get_batch, chip_smoke.FG_KEYS,
                                    b, examples // b)
    with (chip_smoke.deterministic_cudnn(torch) if mode == 'deterministic'
          else contextlib.nullcontext()):
      chip_smoke.run_steps(torch, gk, fg, data,
                           chip_smoke.CHAIN_TRAIN_STEPS[0])
    fg_exp = EvalExperiment(chip_smoke.CHAIN_FG_DIR, cfg=fg_cfg, device=dev,
                            spec='fg')
    fg_exp.model.load_state_dict(fg.model.state_dict())
    with chip_smoke.deterministic_cudnn(torch):
      packed = pack_fg(fg_exp, ds, b)
    digest = hashlib.sha256(packed.d_out.tobytes()
                            + packed.y_out.tobytes()).hexdigest()[:16]
    batch = {k: v.to(dev) for k, v in next(chip_smoke.chain_batches(
        torch, packed.get_batch, chip_smoke.PACKED_KEYS, b, 1)).items()}
    gates, failures, host = chip_smoke.cpu_gate(
        torch, ts, matching, box.model, box.opt_state, batch, small_draws,
        box.step, lr, chip_smoke.BOX_STEP_LIMITS)
    small = {k: v[:nb] for k, v in batch.items()}

    def card():
      with chip_smoke.deterministic_cudnn(torch):
        return chip_smoke.one_step(torch, ts, matching, box.model,
                                   box.opt_state, small,
                                   chip_smoke.to_device(small_draws, dev),
                                   box.step, 'kernel', host[4]['solved'])
    got, again = card(), card()
    exact = float64_step(torch, ts, matching, box.model, box.opt_state,
                         small, small_draws, box.step, host[4]['solved'])
    exact = tuple(({k: (v.to(dev) if torch.is_tensor(v) else v)
                    for k, v in x.items()} if isinstance(x, dict)
                   else x.to(dev)) for x in exact)

    def diff(a, ref):
      stats = chip_smoke.step_diff(torch, box.model, a, ref, lr)
      stats['failed'] = chip_smoke.step_gate_failures(
          stats, chip_smoke.BOX_STEP_LIMITS)
      return {k: stats[k] for k in keys}
    print(json.dumps({
        'repeat': i, 'fg_steps_cudnn': mode, 'pack_sha256': digest,
        'gate_failures': failures,
        'card_vs_cpu': {k: v[k] for name, v in gates.items() for k in keys
                        if name == f'card_vs_cpu_b{nb}'},
        'card_vs_float64': diff(got, exact),
        'cpu_vs_float64': diff(host, exact),
        'card_repeats_bitwise': all(torch.equal(got[1][k], again[1][k])
                                    for k in got[1])}), flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


if __name__ == '__main__':
  main()
