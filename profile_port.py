#!/usr/bin/env python3
"""Where a serving forward or a train step of the PyTorch port spends its
time.

    python3 profile_port.py [--batch 128] [--trace trace.json]
    python3 profile_port.py --train [--batch 32]

Runs the flagship CVPPP checkpoint (a checkout without it fails) on one
CUDA card.  Serving (the default): one warm-up forward, then one forward
under torch.profiler.  ``--train``: the Trainer restores the checkpoint with
its Adam state, takes two warm-up steps on seeded synthetic batches, then
one step under torch.profiler.  Prints one JSON line: the forward's or the
step's wall time unprofiled (CUDA events on an idle stream, median of
three), the profiled call's own wall time (CUDA events around it), the
device time summed over all kernels of the profiled call, the device's busy
share of that call (device time over its own wall time), and the device
time per kernel name, largest first.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke


def train_step_fn(cfg, batch):
  """(one train step of the flagship on the card, checkpoint path)."""
  import os
  import torch
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  trainer = Trainer(cfg, device='cuda')
  ckpt = trainer.restore(chip_smoke.CHECKPOINT_DIR)
  data = synthetic_instances(batch, cfg.inp_height, cfg.inp_width,
                             cfg.timespan, seed=0)

  def batches():
    while True:
      yield data

  it = batches()
  return (lambda: trainer.run(1, it)), os.path.relpath(ckpt, chip_smoke.REPO)


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--batch', type=int, default=None,
                  help='batch size (128 serving, 32 training)')
  ap.add_argument('--train', action='store_true',
                  help='profile a train step instead of a forward')
  ap.add_argument('--trace', help='write a Chrome trace to this path')
  ap.add_argument('--top', type=int, default=25)
  args = ap.parse_args()

  import torch
  if not torch.cuda.is_available():
    sys.exit('profile_port: CUDA is not available; this script runs on a card')
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.data.synthetic import synthetic_images
  from rec_attend_tpu_torch.models.full_model import full_model_forward

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = cvppp_full_config()
  if args.train:
    args.batch = args.batch or chip_smoke.TRAIN_BATCH
    run, weights = train_step_fn(cfg, args.batch)
  else:
    args.batch = args.batch or 128
    seg, weights = chip_smoke.flagship_segmenter(cfg)
    x = synthetic_images(args.batch, cfg.inp_height, cfg.inp_width,
                         seed=args.batch).to('cuda')

    def run():
      with torch.inference_mode():
        return full_model_forward(seg.model, x)

  wall = chip_smoke.ms(torch, run, iters=3, warmup=2 if args.train else 1,
                       sleep=False)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
  profiled_ms = start.elapsed_time(end)
  if args.trace:
    prof.export_chrome_trace(args.trace)
  kernels = {}
  for evt in prof.key_averages():
    if evt.device_type != DeviceType.CUDA:   # kernels and copies only
      continue
    us = getattr(evt, 'self_device_time_total',
                 getattr(evt, 'self_cuda_time_total', 0))
    kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
  device_ms = sum(kernels.values())
  top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
  print(json.dumps({
      'mode': 'train' if args.train else 'serve', 'batch': args.batch,
      'weights': weights, 'forward_ms' if not args.train else 'step_ms': wall,
      'profiled_ms': profiled_ms, 'device_ms': device_ms,
      'device_busy_share': device_ms / profiled_ms,
      'instances_per_s': args.batch * cfg.timespan / (wall / 1e3),
      'nvidia_smi': chip_smoke.nvidia_smi_name_power(),
      'top_kernels_ms': [[name, ms] for name, ms in top]}), flush=True)


if __name__ == '__main__':
  main()
