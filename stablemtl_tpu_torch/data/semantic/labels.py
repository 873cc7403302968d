"""Virtual KITTI 2 label table (dataset constants: names, ids, the
official palette, and the color each class takes in the shared 8-class
VKITTI2<->Cityscapes space that the model regresses in latent space).
Counterpart of `stablemtl_tpu/data/semantic/labels.py`, as far as the
serving path needs it."""

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
