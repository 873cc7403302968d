"""Virtual KITTI 2 id -> train id in the shared 8-class space (road,
building, pole, traffic light, traffic sign, vegetation, sky, vehicle).
Counterpart of `stablemtl_tpu/data/semantic/mappings.py`, as far as the
serving path needs it."""

VKITTI2_CLS08 = {
    5: 0,   # Road
    4: 1,   # Building
    9: 2,   # Pole
    8: 3,   # TrafficLight
    7: 4,   # TrafficSign
    2: 5,   # Tree
    3: 5,   # Vegetation
    1: 6,   # Sky
    11: 7,  # Truck
    12: 7,  # Car
    13: 7,  # Van
}

VKITTI2 = {"cls08": VKITTI2_CLS08}
