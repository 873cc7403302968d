"""The class palette of the shared 8-class label space, counterpart of
`stablemtl_tpu/data/semantic/encoding.py` as far as
`VKitti2Encoder.class_color_embeddings` needs it: the train id -> color
table that visualizes semantic maps and decodes a predicted color image to
class ids (nearest palette color)."""

from __future__ import annotations

import numpy as np

from . import labels as L
from . import mappings as M

VKCS_N_CLASSES = 8


class Encoder:
    def __init__(self, n_classes: int, id_map: dict, colors: dict):
        """n_classes train classes; id_map dataset id -> train id; colors
        dataset id -> RGB."""
        self.n_classes = n_classes
        self.map = dict(id_map)
        assert len(set(self.map.values())) == n_classes
        self.class_color_embeddings = np.zeros((n_classes, 3), np.float32)
        for ds_id, train_id in self.map.items():
            self.class_color_embeddings[train_id] = np.asarray(
                colors[ds_id], np.float32)


class VKitti2Encoder(Encoder):
    """The 8-class space (the only one the mappings define), colored by
    the shared VKITTI2<->Cityscapes palette."""

    def __init__(self, n_classes: int = VKCS_N_CLASSES):
        colors = {row[1]: row[3] for row in L.VKITTI2_LABELS}
        super().__init__(n_classes, M.VKITTI2[f"cls{n_classes:02d}"],
                         colors)
