"""The Cityscapes label table: the official 34-label definition.

The port's own copy of ``rec_attend_tpu/data/cityscapes_labels.py`` (the
vendored toolkit's ``helpers/labels.py``).  Columns follow the official
csLabels tuple; ``trainId`` follows the reference's convention for its 8
instance classes (instance-capable classes get trainId 1..8, everything
else 0), as in the JAX package.
"""

from __future__ import annotations

from collections import namedtuple

Label = namedtuple('Label', ['name', 'id', 'trainId', 'category',
                             'categoryId', 'hasInstances', 'ignoreInEval',
                             'color'])

# name, id, trainId, category, catId, hasInstances, ignoreInEval, color
labels = [
    Label('unlabeled', 0, 0, 'void', 0, False, True, (0, 0, 0)),
    Label('ego vehicle', 1, 0, 'void', 0, False, True, (0, 0, 0)),
    Label('rectification border', 2, 0, 'void', 0, False, True, (0, 0, 0)),
    Label('out of roi', 3, 0, 'void', 0, False, True, (0, 0, 0)),
    Label('static', 4, 0, 'void', 0, False, True, (0, 0, 0)),
    Label('dynamic', 5, 0, 'void', 0, False, True, (111, 74, 0)),
    Label('ground', 6, 0, 'void', 0, False, True, (81, 0, 81)),
    Label('road', 7, 0, 'flat', 1, False, False, (128, 64, 128)),
    Label('sidewalk', 8, 0, 'flat', 1, False, False, (244, 35, 232)),
    Label('parking', 9, 0, 'flat', 1, False, True, (250, 170, 160)),
    Label('rail track', 10, 0, 'flat', 1, False, True, (230, 150, 140)),
    Label('building', 11, 0, 'construction', 2, False, False, (70, 70, 70)),
    Label('wall', 12, 0, 'construction', 2, False, False, (102, 102, 156)),
    Label('fence', 13, 0, 'construction', 2, False, False, (190, 153, 153)),
    Label('guard rail', 14, 0, 'construction', 2, False, True,
          (180, 165, 180)),
    Label('bridge', 15, 0, 'construction', 2, False, True, (150, 100, 100)),
    Label('tunnel', 16, 0, 'construction', 2, False, True, (150, 120, 90)),
    Label('pole', 17, 0, 'object', 3, False, False, (153, 153, 153)),
    Label('polegroup', 18, 0, 'object', 3, False, True, (153, 153, 153)),
    Label('traffic light', 19, 0, 'object', 3, False, False, (250, 170, 30)),
    Label('traffic sign', 20, 0, 'object', 3, False, False, (220, 220, 0)),
    Label('vegetation', 21, 0, 'nature', 4, False, False, (107, 142, 35)),
    Label('terrain', 22, 0, 'nature', 4, False, False, (152, 251, 152)),
    Label('sky', 23, 0, 'sky', 5, False, False, (70, 130, 180)),
    Label('person', 24, 1, 'human', 6, True, False, (220, 20, 60)),
    Label('rider', 25, 2, 'human', 6, True, False, (255, 0, 0)),
    Label('car', 26, 3, 'vehicle', 7, True, False, (0, 0, 142)),
    Label('truck', 27, 4, 'vehicle', 7, True, False, (0, 0, 70)),
    Label('bus', 28, 5, 'vehicle', 7, True, False, (0, 60, 100)),
    Label('caravan', 29, 0, 'vehicle', 7, True, True, (0, 0, 90)),
    Label('trailer', 30, 0, 'vehicle', 7, True, True, (0, 0, 110)),
    Label('train', 31, 6, 'vehicle', 7, True, False, (0, 80, 100)),
    Label('motorcycle', 32, 7, 'vehicle', 7, True, False, (0, 0, 230)),
    Label('bicycle', 33, 8, 'vehicle', 7, True, False, (119, 11, 32)),
]

name2label = {l.name: l for l in labels}
id2label = {l.id: l for l in labels}

# The 8 instance classes, index = trainId - 1 (reference convention).
INSTANCE_CLASS_NAMES = ['person', 'rider', 'car', 'truck', 'bus', 'train',
                        'motorcycle', 'bicycle']
# Official evaluation label ids for the 8 classes.
INSTANCE_CLASS_IDS = [24, 25, 26, 27, 28, 31, 32, 33]
