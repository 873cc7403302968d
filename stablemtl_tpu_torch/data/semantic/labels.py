"""Public dataset label tables (Cityscapes / Virtual KITTI 2).

These are dataset constants (names, ids, official palette colors), identical
by necessity to the tables used by the reference
(reference src/dataset/semantic/labels.py) and to the upstream dataset
releases. The shared 8-class VKITTI<->Cityscapes color space (`VKCS_COLORS`)
is the palette the model regresses in latent space.

Copy of `stablemtl_tpu/data/semantic/labels.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

# (name, cityscapes_id, train_id, cityscapes_color, vk-cs shared color or None)
CITYSCAPES_LABELS = [
    ("unlabeled", 0, 255, (0, 0, 0), None),
    ("ego vehicle", 1, 255, (0, 0, 0), None),
    ("rectification border", 2, 255, (0, 0, 0), None),
    ("out of roi", 3, 255, (0, 0, 0), None),
    ("static", 4, 255, (0, 0, 0), None),
    ("dynamic", 5, 255, (111, 74, 0), None),
    ("ground", 6, 255, (81, 0, 81), None),
    ("road", 7, 0, (128, 64, 128), (128, 64, 128)),
    ("sidewalk", 8, 1, (244, 35, 232), None),
    ("parking", 9, 255, (250, 170, 160), None),
    ("rail track", 10, 255, (230, 150, 140), None),
    ("building", 11, 2, (70, 70, 70), (70, 70, 70)),
    ("wall", 12, 3, (102, 102, 156), None),
    ("fence", 13, 4, (190, 153, 153), None),
    ("guard rail", 14, 255, (180, 165, 180), None),
    ("bridge", 15, 255, (150, 100, 100), None),
    ("tunnel", 16, 255, (150, 120, 90), None),
    ("pole", 17, 5, (153, 153, 153), (153, 153, 153)),
    ("polegroup", 18, 255, (153, 153, 153), None),
    ("traffic light", 19, 6, (250, 170, 30), (250, 170, 30)),
    ("traffic sign", 20, 7, (220, 220, 0), (220, 220, 0)),
    ("vegetation", 21, 8, (107, 142, 35), (107, 142, 35)),
    ("terrain", 22, 9, (152, 251, 152), None),
    ("sky", 23, 10, (70, 130, 180), (70, 130, 180)),
    ("person", 24, 11, (220, 20, 60), None),
    ("rider", 25, 12, (255, 0, 0), None),
    ("car", 26, 13, (0, 0, 142), (0, 0, 142)),
    ("truck", 27, 14, (0, 0, 70), None),
    ("bus", 28, 15, (0, 60, 100), (0, 0, 142)),
    ("caravan", 29, 255, (0, 0, 90), None),
    ("trailer", 30, 255, (0, 0, 110), None),
    ("train", 31, 16, (0, 80, 100), None),
    ("motorcycle", 32, 17, (0, 0, 230), None),
    ("bicycle", 33, 18, (119, 11, 32), None),
    ("license plate", -1, -1, (0, 0, 142), None),
]

# (name, vkitti_id, vkitti_color, vk-cs shared color or None)
VKITTI2_LABELS = [
    ("Terrain", 0, (210, 0, 200), None),
    ("Sky", 1, (90, 200, 255), (70, 130, 180)),
    ("Tree", 2, (0, 199, 0), (107, 142, 35)),
    ("Vegetation", 3, (90, 240, 0), (107, 142, 35)),
    ("Building", 4, (140, 140, 140), (70, 70, 70)),
    ("Road", 5, (100, 60, 100), (128, 64, 128)),
    ("GuardRail", 6, (250, 100, 255), None),
    ("TrafficSign", 7, (255, 255, 0), (220, 220, 0)),
    ("TrafficLight", 8, (200, 200, 0), (250, 170, 30)),
    ("Pole", 9, (255, 130, 0), (153, 153, 153)),
    ("Misc", 10, (80, 80, 80), None),
    ("Truck", 11, (160, 60, 60), (0, 0, 142)),
    ("Car", 12, (255, 127, 80), (0, 0, 142)),
    ("Van", 13, (0, 139, 139), (0, 0, 142)),
]
