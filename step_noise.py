#!/usr/bin/env python3
"""The float32 noise floor of chip_smoke.py's train-step gates, over several
batches.

    python3 step_noise.py [--batches 5] [--step 30000] [--batch 32]
    python3 step_noise.py --chain [--batches 5]
    python3 step_noise.py --synthcs [--batches 5]
    python3 step_noise.py --box-repeats 8
    python3 step_noise.py --bf16 [--batches 5]
    python3 step_noise.py --bf16-exact [--batches 2]
    python3 step_noise.py --pretrained [--batches 5]

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

With ``--synthcs``, the same for the step gates of chip_smoke.py's
synthcs_pipeline phase at 256x512: the synthcs fg model at step 0 (the
pipeline's seed-0 initial parameters), card against CPU (b2) with its floor
(the batch in the other order) and its control (the per-channel BCE,
``chip_smoke.synthcs_fg_gates``); the committed synthcs box checkpoint's
step on the packed maps of that fg model, kernel against plain (b4) and
card against CPU (b2) with the sigmoid score head control
(``synthcs_box_gates``), and the box's card and CPU steps each against
the same step in float64 on the CPU; and the synthcs full model's step at
step 0 from the controller of a box at its initial parameters (the
phase's box took four steps from them), kernel against plain (b4,
``step_gates``).  Batch i
holds the first examples of a 16-example split of seed 3 + 100 i: i = 0 is
the phase's train split, whose first examples it gates.

With ``--box-repeats N``, chip_smoke.py's chain_train box card-against-CPU
gate N times over, each time on the pack of a fg model that took the
phase's five steps anew from ckpt-3000: N times with cuDNN's default
algorithms in those steps and twice with its deterministic ones.  Each
repeat prints the pack's digest, the gate (card against CPU, both float32)
and each side against the same step on the CPU in float64 (the exact
answer's stand-in), and whether the card's step repeats bit for bit.
With ``--bf16``, the gates of chip_smoke.py's bf16 phase over several
b32 batches: the committed bfloat16 run's checkpoint restored with its
Adam state, one step at step 0 (the ground truth fills the canvas) held
kernel against plain beside the reordered-plain floor, and card against
the float32 model's step in float64 on the CPU (b2) beside its floor, the
CPU's bfloat16 step and the card's with cuDNN off against the same step
(``chip_smoke.bf16_step_gates``), each with the dropped-filter-gradient
control, and the card's statistics over the larger floor's.  Batch 0 is
the one that chip_smoke.py gates.

With ``--bf16-exact``, the bf16 phase's card-against-CPU step (b2, the
first two examples of each of the first ``--batches`` b32 batches, step 0,
the CPU's matchings pinned) taken five ways: bfloat16 on the CPU,
bfloat16 on the card (cuDNN deterministic, as gated), bfloat16 on the card
with cuDNN off and with cuBLAS's reduced-precision bfloat16 sums off, and
float32 on the card and on the CPU.  Each is held to the float64 step on
the CPU (the float32 model run in float64: the exact answer's stand-in)
and to the bfloat16 CPU step, with each step's five largest gradient
norms.

With ``--pretrained``, the gate of chip_smoke.py's weights_h5 phase over
several b32 batches: the flagship's committed start (its model_opt.yaml
as committed: the controller from the box's weights.h5, every other net
at its seed-0 value, ``chip_smoke.committed_config``), one step at step 0
held kernel against plain beside the reordered-plain floor, with the
dropped-filter-gradient control (``chip_smoke.step_gates`` at
``STEP_LIMITS``).  Batch 0 is the one that chip_smoke.py gates.

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
  ap.add_argument('--synthcs', action='store_true',
                  help='the synthcs_pipeline gates instead of the flagship '
                       'step')
  ap.add_argument('--box-repeats', type=int, default=0,
                  help="chain_train's box card-against-CPU gate over this "
                       'many fg trainings')
  ap.add_argument('--bf16', action='store_true',
                  help="the bf16 phase's train gates instead of the "
                       'flagship step')
  ap.add_argument('--pretrained', action='store_true',
                  help="the weights_h5 phase's committed-start gate "
                       'instead of the flagship step')
  ap.add_argument('--bf16-exact', action='store_true',
                  help="the bf16 phase's card-against-CPU step against a "
                       'float64 step')
  args = ap.parse_args()

  import torch
  if not torch.cuda.is_available():
    sys.exit('step_noise: CUDA is not available; this script runs on a card')
  if args.chain:
    chain_noise(torch, args.batches)
    return
  if args.synthcs:
    synthcs_noise(torch, args.batches)
    return
  if args.box_repeats:
    box_repeats(torch, args.box_repeats)
    return
  if args.bf16:
    bf16_noise(torch, args.batches)
    return
  if args.bf16_exact:
    bf16_exact(torch, args.batches)
    return
  if args.pretrained:
    pretrained_noise(torch, args.batches)
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


def pretrained_noise(torch, n):
  """The weights_h5 phase's step gate over ``n`` b32 batches, from the
  flagship's committed start."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = chip_smoke.committed_config(chip_smoke.CHECKPOINT_DIR)
  trainer = Trainer(cfg, device='cuda')
  trainer.load_pretrained()
  b = chip_smoke.WEIGHTS_H5_BATCH
  for i in range(n):
    data = synthetic_instances(b, cfg.inp_height, cfg.inp_width,
                               cfg.timespan, seed=1000 + i)
    batch = {k: v.to('cuda') for k, v in data.items()}
    draws = draw_train_randoms(cfg, b,
                               torch.Generator('cuda').manual_seed(1 + i))
    gates, failures = chip_smoke.step_gates(
        torch, ts, matching, gk, trainer.model, trainer.opt_state, batch,
        draws, 0, learn_rate(cfg, 0), chip_smoke.STEP_LIMITS)
    print(json.dumps({
        'batch_seed': 1000 + i, 'draws_seed': 1 + i, 'step': 0, 'batch': b,
        'limits': chip_smoke.STEP_LIMITS, 'failures': failures,
        'gates': {name: {k: v[k] for k in KEYS}
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


def synthcs_noise(torch, n, dev='cuda'):
  """The synthcs_pipeline step gates' statistics over n batches (module
  docstring); ``dev`` the CPU in the tests."""
  import tempfile

  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.config import synthcs_box_config
  from rec_attend_tpu_torch.config import synthcs_fg_config
  from rec_attend_tpu_torch.config import synthcs_full_config
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
  dev = torch.device(dev)
  fg_cfg, box_cfg, full_cfg = (synthcs_fg_config(), synthcs_box_config(),
                               synthcs_full_config())
  b_fg, b = 8, chip_smoke.SYNTHCS_TRAIN_BATCH
  fg = Trainer(fg_cfg, device=dev, seed=0)
  with tempfile.TemporaryDirectory() as folder:
    chip_smoke.params_checkpoint(fg.model, folder)
    fg_exp = EvalExperiment(folder, cfg=fg_cfg, device=dev, spec='fg')
  box = Trainer(box_cfg, device=dev)
  box.restore(chip_smoke.SYNTHCS_BOX_DIR)
  # The phase's full model starts from a box that took four steps from its
  # initial parameters: here from those parameters.
  full = Trainer(full_cfg, device=dev)
  full.load_pretrained(Trainer(box_cfg, device=dev, seed=0).model)
  nb = chip_smoke.CHAIN_TRAIN_CPU_BATCH
  for i in range(n):
    gen = lambda seed: torch.Generator(dev).manual_seed(seed + 10 * i)
    ds = SyntheticDataset(
        chip_smoke.SYNTHCS_EXAMPLES, full_cfg.inp_height, full_cfg.inp_width,
        full_cfg.timespan, seed=3 + 100 * i,
        max_objects=chip_smoke.CS_MAX_OBJECTS,
        num_semantic_classes=chip_smoke.CS_CLASSES)
    fg_batch = {k: v.to(dev) for k, v in next(chip_smoke.chain_batches(
        torch, ds.get_batch, chip_smoke.FG_KEYS, b_fg, 1)).items()}
    with chip_smoke.deterministic_cudnn(torch):
      packed = pack_fg(fg_exp, ds, b)
    batch = {k: v.to(dev) for k, v in next(chip_smoke.chain_batches(
        torch, packed.get_batch, chip_smoke.PACKED_KEYS, b, 1)).items()}
    box_draws = draw_box_randoms(box_cfg, b, gen(2))
    box_lr = learn_rate(box_cfg, box.opt_state['count'])
    *box_gates, host = chip_smoke.synthcs_box_gates(
        torch, ts, matching, gk, box.model, box.opt_state, batch, box_draws,
        box.step, box_lr, chip_smoke.SYNTHCS_BOX_STEP_LIMITS)
    # The box's card and CPU steps (b2) each against the same step in
    # float64 on the CPU, the CPU's matchings pinned.
    small_draws = {'aug': box_draws['aug'],
                   'segm_noise': box_draws['segm_noise'][:, :nb]}
    small = {k: v[:nb] for k, v in batch.items()}
    with chip_smoke.deterministic_cudnn(torch):
      got = chip_smoke.one_step(torch, ts, matching, box.model,
                                box.opt_state, small,
                                chip_smoke.to_device(small_draws, dev),
                                box.step, 'kernel', host[4]['solved'])
    exact = chip_smoke.step_to(torch, chip_smoke.float64_step(
        torch, ts, matching, box.model, box.opt_state, small, small_draws,
        box.step, host[4]['solved']), dev)
    box_gates[0]['card_vs_float64'] = chip_smoke.step_diff(
        torch, box.model, got, exact, box_lr)
    box_gates[0]['cpu_vs_float64'] = chip_smoke.step_diff(
        torch, box.model, chip_smoke.step_to(torch, host, dev), exact, box_lr)
    stages = {
        'fg': chip_smoke.synthcs_fg_gates(
            torch, ts, matching, fg.model, fg.opt_state, fg_batch,
            draw_fg_randoms(fg_cfg, gen(1)), 0, learn_rate(fg_cfg, 0),
            chip_smoke.SYNTHCS_FG_STEP_LIMITS),
        'box': box_gates,
        'full': chip_smoke.step_gates(
            torch, ts, matching, gk, full.model, full.opt_state, batch,
            draw_train_randoms(full_cfg, b, gen(3)), 0,
            learn_rate(full_cfg, 0), chip_smoke.SYNTHCS_FULL_STEP_LIMITS)}
    print(json.dumps({
        'batch_index': i, 'split_seed': 3 + 100 * i,
        'draws_seeds': [1 + 10 * i, 2 + 10 * i, 3 + 10 * i],
        'stages': {stage: {'failures': failures,
                           'gates': {name: {k: v[k] for k in KEYS if k in v}
                                     for name, v in gates.items()}}
                   for stage, (gates, failures) in stages.items()}}),
          flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


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
    exact = chip_smoke.float64_step(torch, ts, matching, box.model,
                                    box.opt_state, small, small_draws,
                                    box.step, host[4]['solved'])
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


def bf16_noise(torch, n):
  """chip_smoke.py's bf16 train gates over n b32 batches (module
  docstring)."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  cfg = chip_smoke.bf16_config()
  trainer = Trainer(cfg, device=dev)
  trainer.restore(chip_smoke.BF16_DIR)
  lr = learn_rate(cfg, trainer.opt_state['count'])
  b, nb = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_CPU_BATCH
  keys = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
          'grad_rel_l2_median', 'zero_grad_share_max', 'update_rel_l2_max',
          'zero_update_in_lr_max', 'matches_differ', 'failed')
  for i in range(n):
    batch = {k: v.to(dev) for k, v in synthetic_instances(
        b, cfg.inp_height, cfg.inp_width, cfg.timespan,
        seed=1000 + i).items()}
    draws = draw_train_randoms(cfg, b,
                               torch.Generator(dev).manual_seed(1 + 10 * i))
    small = draw_train_randoms(cfg, nb,
                               torch.Generator(dev).manual_seed(2 + 10 * i))
    gates, failures = chip_smoke.bf16_step_gates(
        torch, ts, matching, gk, trainer, batch, draws, small, lr)
    print(json.dumps({
        'batch': i, 'failures': failures,
        'card_over_floor': card_over_floor(gates, nb),
        'gates': {name: {k: v[k] for k in keys if k in v}
                  for name, v in gates.items()}}), flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


def card_over_floor(gates, nb):
  """Each statistic of the card's bf16 step against float64 over the
  larger of its floor's two readings (the CPU's bf16 step and the card's
  with cuDNN off against the same step)."""
  def value(v):
    return v[1] if isinstance(v, (list, tuple)) else v
  card = gates[f'card_vs_float64_b{nb}']
  floors = [gates[f'{name}_vs_float64_b{nb}']
            for name in ('cpu', 'card_cudnn_off')]
  return {k: value(card[k]) / max(max(value(f[k]) for f in floors), 1e-30)
          for k in chip_smoke.BF16_FLOOR_GATES}


def bf16_exact(torch, n):
  """The bf16 phase's card-against-CPU step five ways against float64
  (module docstring)."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  cfg = chip_smoke.bf16_config()
  trainer = Trainer(cfg, device=dev)
  trainer.restore(chip_smoke.BF16_DIR)
  f32 = Trainer(cfg.replace(dtype='float32'), device=dev)
  f32.model.load_state_dict(trainer.model.state_dict())
  opt = trainer.opt_state
  lr = learn_rate(cfg, opt['count'])
  nb = chip_smoke.TRAIN_CPU_BATCH
  keys = ('loss', 'loss_ref', 'loss_rel_diff', 'grad_rel_l2_max',
          'grad_rel_l2_all', 'grad_rel_l2_median', 'update_rel_l2_max',
          'matches_differ', 'forward')
  matmul = torch.backends.cuda.matmul

  def on(d, x):
    return tuple(({k: (v.to(d) if torch.is_tensor(v) else v)
                   for k, v in y.items()} if isinstance(y, dict)
                  else y.to(d)) for y in x)
  for i in range(n):
    batch = {k: v[:nb].to(dev) for k, v in synthetic_instances(
        chip_smoke.TRAIN_BATCH, cfg.inp_height, cfg.inp_width,
        cfg.timespan, seed=1000 + i).items()}
    draws = draw_train_randoms(cfg, nb,
                               torch.Generator(dev).manual_seed(2 + 10 * i))
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_draws = chip_smoke.to_device(draws, 'cpu')

    def cpu_step(model):
      m = copy.deepcopy(model).to('cpu')
      m.device = torch.device('cpu')
      return on(dev, chip_smoke.one_step(
          torch, ts, matching, m, chip_smoke.opt_state_to(opt, 'cpu'),
          cpu_batch, cpu_draws, 0, 'kernel', pinned))

    def card_step(model, cudnn=True, reduced=True):
      saved = (torch.backends.cudnn.enabled,
               matmul.allow_bf16_reduced_precision_reduction)
      torch.backends.cudnn.enabled = cudnn
      matmul.allow_bf16_reduced_precision_reduction = reduced
      try:
        with chip_smoke.deterministic_cudnn(torch):
          return chip_smoke.one_step(torch, ts, matching, model, opt, batch,
                                     draws, 0, 'kernel', pinned)
      finally:
        (torch.backends.cudnn.enabled,
         matmul.allow_bf16_reduced_precision_reduction) = saved
    pinned = None
    host = cpu_step(trainer.model)
    pinned = host[4]['solved']
    exact = on(dev, chip_smoke.float64_step(torch, ts, matching, f32.model,
                                            opt, batch, draws, 0, pinned))
    steps = {
        'cpu_bf16': host,
        'card_bf16': card_step(trainer.model),
        'card_bf16_cudnn_off': card_step(trainer.model, cudnn=False),
        'card_bf16_no_reduced_bf16_sums': card_step(trainer.model,
                                                    reduced=False),
        'card_f32': card_step(f32.model),
        'cpu_f32': cpu_step(f32.model)}
    out = {}
    for name, got in steps.items():
      norms = {k: float(g.norm()) for k, g in got[1].items()}
      out[name] = {
          'vs_float64': {k: v for k, v in chip_smoke.step_diff(
              torch, trainer.model, got, exact, lr).items() if k in keys},
          'grad_norms_top5': sorted(norms.items(), key=lambda kv: -kv[1])[:5]}
      if name != 'cpu_bf16':
        out[name]['vs_cpu_bf16'] = {k: v for k, v in chip_smoke.step_diff(
            torch, trainer.model, got, host, lr).items() if k in keys}
    out['float64_grad_norms_top5'] = sorted(
        ((k, float(g.norm())) for k, g in exact[1].items()),
        key=lambda kv: -kv[1])[:5]
    print(json.dumps({'batch': i, 'batch_seed': 1000 + i,
                      'draws_seed': 2 + 10 * i, 'examples': nb,
                      'steps': out}), flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


if __name__ == '__main__':
  main()
