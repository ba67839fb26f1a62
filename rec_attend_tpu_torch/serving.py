"""Serving API: checkpoint -> batched instance predictions on the card.

Counterpart of ``rec_attend_tpu/serving.py:32-111``:

    seg = InstanceSegmenter.from_checkpoint('results/full_model_...')
    result = seg.predict(images)            # [B, H, W, 3] float in [0,1]
    result['masks']   # [B, T, H, W] binary instance masks
    result['scores']  # [B, T] stop-confidence per slot
    result['counts']  # [B] predicted instance counts

The forward runs under ``torch.inference_mode()`` on the segmenter's device
(``cuda`` unless the caller asks for the CPU), followed by the eval chain
confidence -> one-label -> upsample -> threshold -> remove-tiny on the same
device.  Images of any size are resized to the model's input size, and the
masks are brought back to the images' size (``full_size``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models.full_model import FullModel
from rec_attend_tpu_torch.models.full_model import full_model_forward
from rec_attend_tpu_torch.utils import postprocess as pp


class InstanceSegmenter:
  """Batched recurrent-attention instance segmentation service."""

  def __init__(self, params, cfg: FullModelConfig, device=None,
               threshold=0.5, remove_tiny=16, conf_threshold=0.5):
    """params: state dict of ``FullModel(cfg)`` (tensors or arrays)."""
    self.cfg = cfg
    self.model = FullModel(cfg, device=device)
    self.model.load_state_dict({k: torch.as_tensor(v)
                                for k, v in params.items()})
    self.model.eval()
    self.device = self.model.device
    self.threshold = threshold
    self.remove_tiny = remove_tiny
    # Stored and never read, as in the reference: the scores are hardened
    # at 0.5 (rec_attend_tpu/serving.py:99).
    self.conf_threshold = conf_threshold

  @classmethod
  def from_checkpoint(cls, folder, cfg=None, device=None, **kw):
    """Load the latest checkpoint of a JAX training results folder.

    ``cfg`` defaults to the folder's ``model_opt.yaml``."""
    if cfg is None:
      cfg = FullModelConfig.from_yaml(os.path.join(folder, 'model_opt.yaml'))
    params = convert.params_from_checkpoint(saver.latest_checkpoint(folder),
                                            cfg)
    return cls(params, cfg, device=device, **kw)

  def _prepare(self, images):
    """[B,H,W,3] images of any size (or one [H,W,3]), float in [0,1] or
    uint8-style -> (model-size batch on the device, (H, W))."""
    size = (self.cfg.inp_height, self.cfg.inp_width)
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
      images = images[None]
    if images.max() > 1.5:      # uint8-style range
      images = images / 255.0
    orig = images.shape[1:3]
    x = torch.from_numpy(images).to(self.device)
    x = pp.resize(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return x.contiguous(), orig

  def predict(self, images, full_size=True):
    """Segment instances.  Returns a dict of numpy arrays: 'masks'
    [B,T,H,W] uint8, 'soft_masks' float, 'scores' [B,T], 'counts' [B]; H, W
    the images' size with ``full_size``, else the model's."""
    with torch.inference_mode():
      x, orig = self._prepare(images)
      out = full_model_forward(self.model, x)
      y_out, s_out = out['y_out'], out['s_out']
      y, conf = pp.apply_confidence(y_out, s_out)
      y = pp.apply_one_label(y)
      if full_size and orig != y.shape[-2:]:
        y = pp.upsample(y, [orig] * y.shape[0])
      masks = pp.apply_threshold(y, self.threshold)
      if self.remove_tiny:
        masks, conf = pp.remove_tiny(masks, conf, threshold=self.remove_tiny)
      counts = conf.sum(dim=1).to(torch.int32)
      return {'masks': masks.to(torch.uint8).cpu().numpy(),
              'soft_masks': y.cpu().numpy(),
              'scores': s_out.cpu().numpy(),
              'counts': counts.cpu().numpy()}
