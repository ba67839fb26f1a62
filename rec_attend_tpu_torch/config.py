"""Configuration of the full, box and fg models, as far as their forwards,
losses and train steps read it.

Counterpart of ``rec_attend_tpu/config.py``.  Field names and defaults are
those of the JAX ``FullModelConfig``, ``BoxModelConfig`` and
``FGModelConfig``, so a ``model_opt.yaml`` written by the JAX trainer loads
here unchanged; keys the port does not read (the full model's pretrain
paths, the Pallas and scan switches) are ignored on load.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _tuple(x):
  if x is None:
    return None
  if isinstance(x, (list, tuple)):
    return tuple(x)
  if isinstance(x, str):  # "3,3,3" comma lists, as in the reference CLI
    return tuple(int(v) for v in x.split(','))
  return (x,)


# Dataset geometry and augmentation defaults (JAX config.py DATASET_DIMS,
# DATASET_TRANSFORMS), for the datasets of the presets below.
DATASET_DIMS = {
    'cvppp': dict(inp_height=224, inp_width=224, timespan=21),
    'kitti': dict(inp_height=128, inp_width=448, timespan=20),
    'cityscapes': dict(inp_height=256, inp_width=512, timespan=20),
}
DATASET_TRANSFORMS = {
    'cvppp': dict(rnd_hflip=True, rnd_vflip=True, rnd_transpose=True,
                  rnd_colour=False),
    'kitti': dict(rnd_hflip=False, rnd_vflip=False, rnd_transpose=False,
                  rnd_colour=False),
    'cityscapes': dict(rnd_hflip=False, rnd_vflip=False, rnd_transpose=False,
                       rnd_colour=False),
}


class _ConfigBase:
  """Load, save and replace, shared by the configs."""

  @classmethod
  def from_dict(cls, d):
    """Build from a flat option dict; keys this config lacks are ignored."""
    kwargs = {}
    for fld in dataclasses.fields(cls):
      if fld.name in d:
        v = d[fld.name]
        kwargs[fld.name] = _tuple(v) if 'Tuple' in str(fld.type) else v
    return cls(**kwargs)

  @classmethod
  def from_yaml(cls, path):
    import yaml   # only this reader needs it
    with open(path) as f:
      return cls.from_dict(yaml.safe_load(f))

  def to_dict(self):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(self).items()}

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FullModelConfig(_ConfigBase):
  """Options of the recurrent-attention model that the port reads."""
  # Geometry
  timespan: int = 21
  inp_height: int = 224
  inp_width: int = 224
  inp_depth: int = 3
  padding: int = 16
  filter_height: int = 48
  filter_width: int = 48

  # Controller CNN
  ctrl_cnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 3, 3)
  ctrl_cnn_depth: Tuple[int, ...] = (8, 8, 16, 16, 32, 32, 64, 64)
  ctrl_cnn_pool: Tuple[int, ...] = (1, 2, 1, 2, 1, 2, 2, 2)
  ctrl_rnn_hid_dim: int = 256
  num_ctrl_mlp_layers: int = 1
  ctrl_mlp_dim: int = 256

  # Attention CNN / DCNN
  attn_cnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
  attn_cnn_depth: Tuple[int, ...] = (8, 8, 16, 16, 32, 32)
  attn_cnn_pool: Tuple[int, ...] = (1, 2, 1, 2, 1, 2)
  attn_dcnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 3)
  attn_dcnn_depth: Tuple[int, ...] = (32, 32, 16, 16, 8, 8, 1)
  attn_dcnn_pool: Tuple[int, ...] = (2, 1, 2, 1, 2, 1, 1)
  attn_cnn_skip: Optional[Tuple[int, ...]] = None  # None => all = add_skip_conn

  # Glimpse RNN
  num_ctrl_rnn_iter: int = 5
  num_glimpse_mlp_layers: int = 2

  # Regularisation / training
  attn_box_padding_ratio: float = 0.2
  weight_decay: float = 5e-5
  use_bn: bool = True
  segm_loss_fn: str = 'iou'
  box_loss_fn: str = 'iou'
  loss_mix_ratio: float = 1.0
  segm_weight_alpha: float = 0.0
  base_learn_rate: float = 0.001
  learn_rate_decay: float = 0.96
  steps_per_learn_rate_decay: int = 5000
  clip_gradient: float = 1.0

  # Scheduled-sampling knob
  use_knob: bool = False
  knob_base: float = 1.0
  knob_decay: float = 0.9
  steps_per_knob_decay: int = 300
  knob_box_offset: int = 300
  knob_segm_offset: int = 500
  knob_use_timescale: bool = False
  gt_box_ctr_noise: float = 0.05
  gt_box_pad_noise: float = 0.1
  gt_segm_noise: float = 0.3

  # Structure flags
  squash_ctrl_params: bool = False
  fixed_order: bool = False
  fixed_gamma: bool = False
  fixed_var: bool = False
  dynamic_var: bool = False
  use_iou_box: bool = False
  stop_canvas_grad: bool = True
  add_skip_conn: bool = True
  disable_overwrite: bool = True

  # Extra input channels (packed fg/orientation predictions)
  add_d_out: bool = False
  add_y_out: bool = False
  num_semantic_classes: int = 1
  ctrl_add_inp: Optional[bool] = None     # None => reference default rules
  ctrl_add_canvas: Optional[bool] = None
  ctrl_add_d_out: Optional[bool] = None
  ctrl_add_y_out: Optional[bool] = None
  attn_add_inp: Optional[bool] = None
  attn_add_canvas: Optional[bool] = None
  attn_add_d_out: Optional[bool] = None
  attn_add_y_out: Optional[bool] = None

  # Freezing (True = the subnet's parameters are not updated)
  freeze_ctrl_cnn: bool = False
  freeze_ctrl_rnn: bool = False
  freeze_ctrl_mlp: bool = False
  freeze_attn_net: bool = False

  # Augmentation
  rnd_hflip: bool = False
  rnd_vflip: bool = False
  rnd_transpose: bool = False
  rnd_colour: bool = False

  dtype: str = 'float32'          # compute dtype of the conv/matmul stacks
  remat: bool = False             # recompute each timestep in the backward
  accumulate_greedy_match: bool = False

  # ---- derived helpers -------------------------------------------------

  def resolved_input_flags(self):
    """Resolve ctrl/attn input-channel flags (JAX config.py:212)."""
    add_d, add_y = self.add_d_out, self.add_y_out

    def pick(v, default):
      return v if v is not None else default

    ctrl_add_d = pick(self.ctrl_add_d_out, add_d)
    return dict(
        ctrl_add_inp=pick(self.ctrl_add_inp, not ctrl_add_d),
        ctrl_add_canvas=pick(self.ctrl_add_canvas, not ctrl_add_d),
        ctrl_add_d_out=ctrl_add_d,
        ctrl_add_y_out=pick(self.ctrl_add_y_out, add_y),
        attn_add_inp=pick(self.attn_add_inp, True),
        attn_add_canvas=pick(self.attn_add_canvas, True),
        attn_add_d_out=pick(self.attn_add_d_out, add_d),
        attn_add_y_out=pick(self.attn_add_y_out, add_y))

  def _inp_depth(self, prefix):
    f = self.resolved_input_flags()
    return ((self.inp_depth if f[prefix + '_add_inp'] else 0)
            + (1 if f[prefix + '_add_canvas'] else 0)
            + (8 if f[prefix + '_add_d_out'] else 0)
            + (self.num_semantic_classes if f[prefix + '_add_y_out'] else 0))

  @property
  def ccnn_inp_depth(self):
    return self._inp_depth('ctrl')

  @property
  def acnn_inp_depth(self):
    return self._inp_depth('attn')

  @property
  def ccnn_subsample(self):
    p = 1
    for v in self.ctrl_cnn_pool:
      p *= v
    return p

  @property
  def acnn_subsample(self):
    p = 1
    for v in self.attn_cnn_pool:
      p *= v
    return p

  @property
  def crnn_h(self):
    return self.inp_height // self.ccnn_subsample

  @property
  def crnn_w(self):
    return self.inp_width // self.ccnn_subsample

  @property
  def glimpse_map_dim(self):
    return self.crnn_h * self.crnn_w

  @property
  def glimpse_feat_dim(self):
    return self.ctrl_cnn_depth[-1]

  @property
  def acnn_h(self):
    return self.filter_height // self.acnn_subsample

  @property
  def acnn_w(self):
    return self.filter_width // self.acnn_subsample

  @property
  def core_depth(self):
    return self.attn_cnn_depth[-1]

  @property
  def core_dim(self):
    return self.acnn_h * self.acnn_w * self.core_depth

  def resolved_attn_cnn_skip(self):
    if self.attn_cnn_skip is not None:
      return tuple(bool(v) for v in self.attn_cnn_skip)
    return tuple([self.add_skip_conn] * len(self.attn_cnn_filter_size))


# Fields of FullModelConfig, i.e. the options the port reads.
FORWARD_FIELDS = tuple(f.name for f in dataclasses.fields(FullModelConfig))


@dataclass(frozen=True)
class BoxModelConfig(_ConfigBase):
  """Options of the box model, the controller pathway trained alone
  (JAX config.py:313-398), restricted to the fields the port reads.
  ``pretrain_cnn`` and ``pretrain_net`` name ``weights.h5`` files, which
  the port does not read: ``BoxModel`` refuses a config that sets them."""
  timespan: int = 21
  inp_height: int = 224
  inp_width: int = 224
  inp_depth: int = 3
  padding: int = 16
  filter_height: int = 48
  filter_width: int = 48

  ctrl_cnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 3, 3)
  ctrl_cnn_depth: Tuple[int, ...] = (8, 8, 16, 16, 32, 32, 64, 64)
  ctrl_cnn_pool: Tuple[int, ...] = (1, 2, 1, 2, 1, 2, 2, 2)
  ctrl_rnn_hid_dim: int = 256
  num_ctrl_mlp_layers: int = 1
  ctrl_mlp_dim: int = 256
  num_ctrl_rnn_iter: int = 5
  num_glimpse_mlp_layers: int = 2

  attn_box_padding_ratio: float = 0.2
  weight_decay: float = 5e-5
  use_bn: bool = True
  box_loss_fn: str = 'iou'
  base_learn_rate: float = 0.001
  learn_rate_decay: float = 0.9
  steps_per_learn_rate_decay: int = 5000
  clip_gradient: float = 1.0

  squash_ctrl_params: bool = False
  fixed_order: bool = False
  fixed_var: bool = True
  dynamic_var: bool = False
  use_iou_box: bool = False
  gt_segm_noise: float = 0.3

  add_d_out: bool = False
  add_y_out: bool = False
  num_semantic_classes: int = 1

  pretrain_cnn: Optional[str] = None
  pretrain_net: Optional[str] = None

  rnd_hflip: bool = False
  rnd_vflip: bool = False
  rnd_transpose: bool = False
  rnd_colour: bool = False

  dtype: str = 'float32'
  remat: bool = False
  accumulate_greedy_match: bool = False

  @property
  def ccnn_inp_depth(self):
    """Image, canvas, then the packed orientation and foreground maps."""
    return (self.inp_depth + 1 + (8 if self.add_d_out else 0)
            + (self.num_semantic_classes if self.add_y_out else 0))

  @property
  def ccnn_subsample(self):
    p = 1
    for v in self.ctrl_cnn_pool:
      p *= v
    return p

  @property
  def crnn_h(self):
    return self.inp_height // self.ccnn_subsample

  @property
  def crnn_w(self):
    return self.inp_width // self.ccnn_subsample

  @property
  def glimpse_map_dim(self):
    return self.crnn_h * self.crnn_w

  @property
  def glimpse_feat_dim(self):
    return self.ctrl_cnn_depth[-1]


@dataclass(frozen=True)
class FGModelConfig(_ConfigBase):
  """Options of the fully-convolutional foreground and orientation model
  (JAX config.py:401-441).  It has no ``clip_gradient``: its optimizer
  clips nothing."""
  inp_height: int = 224
  inp_width: int = 224
  inp_depth: int = 3
  padding: int = 16
  cnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3)
  cnn_depth: Tuple[int, ...] = (4, 8, 8, 12, 16)
  cnn_pool: Tuple[int, ...] = (2, 2, 2, 2, 2)
  dcnn_filter_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
  dcnn_depth: Tuple[int, ...] = (8, 6, 4, 4, 2, 1)
  dcnn_pool: Tuple[int, ...] = (2, 2, 2, 2, 2, 1)
  use_bn: bool = True
  weight_decay: float = 5e-5
  base_learn_rate: float = 0.001
  learn_rate_decay: float = 0.96
  steps_per_learn_rate_decay: int = 5000
  add_skip_conn: bool = True
  cnn_skip_mask: Optional[Tuple[int, ...]] = None
  dcnn_skip_mask: Optional[Tuple[int, ...]] = None
  segm_loss_fn: str = 'iou'
  add_orientation: bool = False
  num_orientation_classes: int = 8
  num_semantic_classes: int = 1
  optimizer: str = 'adam'
  rnd_hflip: bool = False
  rnd_vflip: bool = False
  rnd_transpose: bool = False
  rnd_colour: bool = False
  dtype: str = 'float32'

  def resolved_cnn_skip_mask(self):
    if self.cnn_skip_mask is not None:
      return tuple(bool(v) for v in self.cnn_skip_mask)
    return tuple([self.add_skip_conn] * len(self.cnn_filter_size))

  def resolved_dcnn_skip_mask(self):
    if self.dcnn_skip_mask is not None:
      return tuple(bool(v) for v in self.dcnn_skip_mask)
    return self.resolved_cnn_skip_mask()[::-1]


def cvppp_full_config() -> FullModelConfig:
  """The flagship CVPPP preset (JAX config.py:531-558, ref run_cvppp.sh),
  restricted to the fields the port reads."""
  d = DATASET_DIMS['cvppp']
  return FullModelConfig(
      timespan=d['timespan'], inp_height=d['inp_height'],
      inp_width=d['inp_width'],
      use_knob=True, knob_decay=0.5, steps_per_knob_decay=700,
      knob_box_offset=-50000, knob_segm_offset=3000, knob_use_timescale=True,
      box_loss_fn='iou', segm_loss_fn='iou',
      ctrl_cnn_filter_size=(3,) * 8,
      ctrl_cnn_depth=(8, 8, 16, 16, 32, 32, 64, 64),
      ctrl_cnn_pool=(1, 2, 1, 2, 1, 2, 2, 2),
      num_ctrl_mlp_layers=1,
      attn_cnn_filter_size=(3,) * 6,
      attn_cnn_depth=(8, 8, 16, 16, 32, 32),
      attn_cnn_pool=(1, 2, 1, 2, 1, 2),
      attn_dcnn_filter_size=(3,) * 7,
      attn_dcnn_depth=(32, 32, 16, 16, 8, 8, 1),
      attn_dcnn_pool=(2, 1, 2, 1, 2, 1, 1),
      filter_height=48, filter_width=48,
      fixed_gamma=True, stop_canvas_grad=True,
      base_learn_rate=0.001, learn_rate_decay=0.8,
      steps_per_learn_rate_decay=5000,
      ctrl_add_inp=True, ctrl_add_canvas=True,
      attn_add_inp=True, attn_add_canvas=True,
      remat=True, **DATASET_TRANSFORMS['cvppp'])


def kitti_full_config() -> FullModelConfig:
  """The KITTI preset (JAX config.py:597-629, ref run_kitti.sh:69-111):
  128x448 input, T=20, the packed orientation and foreground channels into
  both nets."""
  d = DATASET_DIMS['kitti']
  return FullModelConfig(
      timespan=d['timespan'], inp_height=d['inp_height'],
      inp_width=d['inp_width'],
      use_knob=True, knob_decay=0.5, steps_per_knob_decay=1500,
      knob_box_offset=100, knob_segm_offset=8000, knob_use_timescale=True,
      box_loss_fn='iou', segm_loss_fn='iou',
      ctrl_cnn_filter_size=(3,) * 8,
      ctrl_cnn_depth=(16, 16, 32, 32, 64, 64, 64, 64),
      ctrl_cnn_pool=(2, 2, 1, 2, 1, 2, 1, 2),
      num_ctrl_mlp_layers=1,
      attn_cnn_filter_size=(3,) * 6,
      attn_cnn_depth=(16, 32, 32, 64, 64, 96),
      attn_cnn_pool=(1, 2, 1, 2, 1, 2),
      attn_dcnn_filter_size=(3,) * 7,
      attn_dcnn_depth=(64, 64, 32, 32, 16, 16, 1),
      attn_dcnn_pool=(2, 1, 2, 1, 2, 1, 1),
      attn_cnn_skip=(1, 0, 1, 0, 1, 0, 1, 0),
      filter_height=48, filter_width=48,
      dynamic_var=True, add_skip_conn=True, stop_canvas_grad=True,
      add_d_out=True, add_y_out=True,
      ctrl_add_inp=True, ctrl_add_canvas=True,
      ctrl_add_d_out=True, ctrl_add_y_out=True,
      attn_add_inp=True, attn_add_canvas=True,
      attn_add_d_out=True, attn_add_y_out=True,
      base_learn_rate=0.001, learn_rate_decay=0.85,
      steps_per_learn_rate_decay=5000,
      remat=True, **DATASET_TRANSFORMS['kitti'])


def kitti_fg_config() -> FGModelConfig:
  """The KITTI fg preset (JAX config.py:561-578, ref run_kitti.sh:13-28):
  18 conv and 11 transposed-conv layers at 128x448, a foreground and an
  8-bin orientation head."""
  d = DATASET_DIMS['kitti']
  return FGModelConfig(
      inp_height=d['inp_height'], inp_width=d['inp_width'],
      cnn_filter_size=(3,) * 18,
      cnn_depth=(32, 64, 64, 96, 96, 128, 128, 128, 128, 128, 128, 128, 128,
                 256, 256, 256, 256, 512),
      cnn_pool=(1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 2),
      cnn_skip_mask=(1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1),
      dcnn_filter_size=(3,) * 11,
      dcnn_depth=(256, 256, 128, 128, 96, 96, 64, 64, 32, 32, 9),
      dcnn_pool=(2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1),
      dcnn_skip_mask=(1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 0),
      add_skip_conn=True,
      add_orientation=True, num_orientation_classes=8,
      optimizer='momentum', segm_loss_fn='bce', **DATASET_TRANSFORMS['kitti'])


def kitti_box_config() -> BoxModelConfig:
  """The KITTI box preset (JAX config.py:581-594, ref run_kitti.sh:44-60):
  the controller of the full model at 128x448, T=20, on the image, the
  canvas and the packed orientation and foreground channels (13 in all)."""
  d = DATASET_DIMS['kitti']
  return BoxModelConfig(
      timespan=d['timespan'], inp_height=d['inp_height'],
      inp_width=d['inp_width'],
      ctrl_cnn_filter_size=(3,) * 8,
      ctrl_cnn_depth=(16, 16, 32, 32, 64, 64, 64, 64),
      ctrl_cnn_pool=(1, 2, 1, 2, 1, 2, 2, 2),
      num_ctrl_mlp_layers=1, dynamic_var=True,
      add_d_out=True, add_y_out=True,
      base_learn_rate=0.001, learn_rate_decay=0.9,
      steps_per_learn_rate_decay=5000, remat=True,
      **DATASET_TRANSFORMS['kitti'])


def cityscapes_full_config() -> FullModelConfig:
  """The Cityscapes preset (JAX config.py:631-637, ref
  run_cityscapes.sh:61-109): the KITTI preset at 256x512, T=20, with 9
  semantic channels (background and the 8 instance classes)."""
  d = DATASET_DIMS['cityscapes']
  return kitti_full_config().replace(
      timespan=d['timespan'], inp_height=d['inp_height'],
      inp_width=d['inp_width'], num_semantic_classes=9)


def cityscapes_fg_config() -> FGModelConfig:
  """The Cityscapes fg preset (JAX config.py:640-663, ref
  run_cityscapes.sh:9-33): 20 conv and 13 transposed-conv layers at
  256x512, 9 semantic and 8 orientation classes."""
  d = DATASET_DIMS['cityscapes']
  return FGModelConfig(
      inp_height=d['inp_height'], inp_width=d['inp_width'],
      cnn_filter_size=(3,) * 20,
      cnn_depth=(64, 96, 96, 128, 128, 192, 192, 256, 256, 256, 256, 256,
                 256, 256, 256, 512, 512, 512, 512, 512),
      cnn_pool=(1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 2),
      cnn_skip_mask=(1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1,
                     0, 0),
      dcnn_filter_size=(3,) * 13,
      dcnn_depth=(512, 512, 256, 256, 192, 192, 128, 128, 96, 96, 64, 64,
                  17),
      dcnn_pool=(2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1),
      dcnn_skip_mask=(1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0),
      add_skip_conn=True, segm_loss_fn='bce',
      add_orientation=True, num_orientation_classes=8,
      num_semantic_classes=9,
      optimizer='momentum', base_learn_rate=0.01, learn_rate_decay=0.8,
      steps_per_learn_rate_decay=10000, **DATASET_TRANSFORMS['cityscapes'])


def cityscapes_box_config() -> BoxModelConfig:
  """The Cityscapes box preset (JAX config.py:666-679, ref
  run_cityscapes.sh:40-56)."""
  d = DATASET_DIMS['cityscapes']
  return BoxModelConfig(
      timespan=d['timespan'], inp_height=d['inp_height'],
      inp_width=d['inp_width'],
      ctrl_cnn_filter_size=(3,) * 8,
      ctrl_cnn_depth=(16, 16, 32, 32, 64, 64, 64, 64),
      ctrl_cnn_pool=(2, 2, 1, 2, 1, 2, 1, 2),
      num_ctrl_mlp_layers=1, dynamic_var=True,
      add_d_out=True, add_y_out=True, num_semantic_classes=9,
      base_learn_rate=0.001, learn_rate_decay=0.85,
      steps_per_learn_rate_decay=5000, remat=True,
      **DATASET_TRANSFORMS['cityscapes'])


# The synthcs chain (pipelines/run_pipeline.py:393-403): the Cityscapes
# presets on synthetic data with 2 instance classes, so 3 semantic channels
# (background first) and an fg head of 3 + 8 channels.
SYNTHCS_SEMANTIC_CLASSES = 3


def synthcs_full_config() -> FullModelConfig:
  """``results/full_model_synthcs-20260818a``: 3 + 1 + 8 + 3 = 15 input
  channels into both CNNs."""
  return cityscapes_full_config().replace(
      num_semantic_classes=SYNTHCS_SEMANTIC_CLASSES)


def synthcs_fg_config() -> FGModelConfig:
  """``results/fg_model_synthcs-20260818a``."""
  cfg = cityscapes_fg_config()
  return cfg.replace(
      num_semantic_classes=SYNTHCS_SEMANTIC_CLASSES,
      dcnn_depth=cfg.dcnn_depth[:-1] + (SYNTHCS_SEMANTIC_CLASSES + 8,))


def synthcs_box_config() -> BoxModelConfig:
  """``results/box_model_synthcs-20260818a``."""
  return cityscapes_box_config().replace(
      num_semantic_classes=SYNTHCS_SEMANTIC_CLASSES)


def tiny_full_config(**overrides) -> FullModelConfig:
  """Small config for tests: 64x64 images, short timespan
  (JAX config.py:682-697)."""
  base = dict(
      timespan=4, inp_height=64, inp_width=64, padding=4,
      filter_height=16, filter_width=16,
      ctrl_cnn_filter_size=(3, 3, 3), ctrl_cnn_depth=(4, 8, 8),
      ctrl_cnn_pool=(2, 2, 2), ctrl_rnn_hid_dim=32, num_ctrl_mlp_layers=1,
      ctrl_mlp_dim=32,
      attn_cnn_filter_size=(3, 3), attn_cnn_depth=(4, 8),
      attn_cnn_pool=(2, 2),
      attn_dcnn_filter_size=(3, 3, 3), attn_dcnn_depth=(8, 4, 1),
      attn_dcnn_pool=(2, 2, 1),
      num_ctrl_rnn_iter=2, num_glimpse_mlp_layers=1,
      fixed_gamma=True, squash_ctrl_params=True)
  base.update(overrides)
  return FullModelConfig(**base)


def tiny_box_config(**overrides) -> BoxModelConfig:
  """Small box config for tests: 64x64 images, T=4 (JAX
  config.py:700-709)."""
  base = dict(
      timespan=4, inp_height=64, inp_width=64, padding=4,
      filter_height=16, filter_width=16,
      ctrl_cnn_filter_size=(3, 3, 3), ctrl_cnn_depth=(4, 8, 8),
      ctrl_cnn_pool=(2, 2, 2), ctrl_rnn_hid_dim=32, num_ctrl_mlp_layers=1,
      ctrl_mlp_dim=32, num_ctrl_rnn_iter=2, num_glimpse_mlp_layers=1,
      squash_ctrl_params=True)
  base.update(overrides)
  return BoxModelConfig(**base)


def tiny_fg_config(**overrides) -> FGModelConfig:
  """Small fg config for tests: 64x64 images (JAX config.py:712-718)."""
  base = dict(
      inp_height=64, inp_width=64, padding=4,
      cnn_filter_size=(3, 3, 3), cnn_depth=(4, 8, 8), cnn_pool=(2, 2, 2),
      dcnn_filter_size=(3, 3, 3), dcnn_depth=(8, 4, 1), dcnn_pool=(2, 2, 2))
  base.update(overrides)
  return FGModelConfig(**base)
