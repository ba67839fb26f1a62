"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None):
  """``device`` as a torch.device, ``cuda`` when None.

  Raises when CUDA is asked for (explicitly or by default) and there is no
  card: the port never falls back to the CPU on its own."""
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('CUDA is not available; pass device="cpu" to run on '
                       'the CPU')
  return device


def synchronize(device):
  """Wait for the card's queued work where ``device`` is a card; a no-op on
  the CPU.  Host timings of device work end here."""
  if device.type == 'cuda':
    torch.cuda.synchronize(device)
