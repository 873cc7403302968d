"""Semantic label encoding for the shared 8-class VKITTI2<->Cityscapes space.

Behavioral parity with reference src/dataset/semantic/encoding.py:
- dataset id (or RGB) -> train-id maps with ignore_index 250
- train-id -> palette color ("class color embedding") used both for
  visualization and as the latent-space regression target
- color -> class-id decoding by nearest palette color (pipeline:354-366)

Implementation is vectorized via lookup tables rather than per-class loops.

Copy of `stablemtl_tpu/data/semantic/encoding.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import labels as L
from . import mappings as M

IGNORE_INDEX = 250
VKCS_N_CLASSES = 8


class Encoder:
    ignore_index = IGNORE_INDEX

    def __init__(self, n_classes: int, id_map: dict, colors: list, decode_colors=None):
        """
        Args:
            n_classes: number of train classes.
            id_map: dataset-id -> train-id.
            colors: per-dataset-id palette aligned with id_map keys' label table
                (indexed by dataset id).
            decode_colors: optional per-dataset-id RGB colors used when the GT
                is stored as an RGB map (VKITTI2).
        """
        self.n_classes = n_classes
        self.map = dict(id_map)
        assert len(set(self.map.values())) == n_classes

        # train-id -> visualization/embedding color
        self.class_color_visualizes = np.zeros((n_classes, 3), dtype=np.float32)
        for ds_id, train_id in self.map.items():
            self.class_color_visualizes[train_id] = np.asarray(colors[ds_id], np.float32)
        self.class_color_embeddings = self.class_color_visualizes

        self.decode = decode_colors

        # dense dataset-id -> train-id lookup table (ids assumed small, >=0)
        max_id = max(self.map.keys())
        self._lut = np.full(max_id + 2, IGNORE_INDEX, dtype=np.int64)
        for ds_id, train_id in self.map.items():
            self._lut[ds_id] = train_id

    # ---- encoding ------------------------------------------------------

    def encode_segmap(self, x: np.ndarray) -> np.ndarray:
        """Dataset GT (dense ids, or HxWx3 RGB) -> train-id map."""
        if x.ndim == 3 and x.shape[-1] == 3:
            return self._rgb2lbl(x)
        return self._ind2lbl(x)

    def _ind2lbl(self, dense: np.ndarray) -> np.ndarray:
        clipped = np.clip(dense, 0, len(self._lut) - 1)
        out = self._lut[clipped]
        out[dense != clipped] = IGNORE_INDEX
        return out

    def _rgb2lbl(self, rgb: np.ndarray) -> np.ndarray:
        assert self.decode is not None, "RGB decoding requires decode colors"
        flat = rgb.reshape(-1, 3).astype(np.int64)
        out = np.full(flat.shape[0], IGNORE_INDEX, dtype=np.int64)
        for ds_id, train_id in self.map.items():
            color = np.asarray(self.decode[ds_id], np.int64)
            out[(flat == color).all(axis=1)] = train_id
        return out.reshape(rgb.shape[:-1])

    # ---- decoding / visualization --------------------------------------

    def segmap2color(self, dense: np.ndarray) -> np.ndarray:
        """train-id map -> float RGB image using the class palette."""
        rgb = np.zeros(dense.shape + (3,), dtype=np.float64)
        valid = dense != IGNORE_INDEX
        rgb[valid] = self.class_color_embeddings[dense[valid]]
        return rgb

    def color2class_id(self, img: np.ndarray) -> np.ndarray:
        """Decode a predicted color image in [-1,1] (HxWx3) to class ids.

        Nearest palette color in Euclidean distance
        (reference pipeline:354-366 uses cdist+argmin).
        """
        palette = self.class_color_embeddings / 255.0 * 2.0 - 1.0  # [K,3]
        flat = img.reshape(-1, 3)
        d2 = ((flat[:, None, :] - palette[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1).reshape(img.shape[:-1])


class CityscapesEncoder(Encoder):
    def __init__(self, n_classes: int = VKCS_N_CLASSES):
        if n_classes == VKCS_N_CLASSES:
            colors = [row[4] for row in L.CITYSCAPES_LABELS]
        else:
            colors = [row[3] for row in L.CITYSCAPES_LABELS]
        # colors indexed by cityscapes id: build id -> color list
        id2color = {row[1]: c for row, c in zip(L.CITYSCAPES_LABELS, colors)}
        super().__init__(n_classes, M.CITYSCAPES[f"cls{n_classes:02d}"], id2color)


class VKitti2Encoder(Encoder):
    def __init__(self, n_classes: int = VKCS_N_CLASSES):
        if n_classes == VKCS_N_CLASSES:
            colors = {row[1]: row[3] for row in L.VKITTI2_LABELS}
        else:
            colors = {row[1]: row[2] for row in L.VKITTI2_LABELS}
        decode = {row[1]: row[2] for row in L.VKITTI2_LABELS}
        super().__init__(
            n_classes, M.VKITTI2[f"cls{n_classes:02d}"], colors, decode_colors=decode
        )
