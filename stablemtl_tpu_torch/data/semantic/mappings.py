"""Dataset-id -> train-id mappings for the shared 8-class label space.

Mirrors reference src/dataset/semantic/mappings.py:1-43.
The framework's eval protocol uses the 8-class VKITTI2<->Cityscapes space:
road, building, pole, traffic light, traffic sign, vegetation, sky, vehicle.

Copy of `stablemtl_tpu/data/semantic/mappings.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

CITYSCAPES_CLS08 = {
    7: 0,   # road
    11: 1,  # building
    17: 2,  # pole
    19: 3,  # traffic light
    20: 4,  # traffic sign
    21: 5,  # vegetation
    23: 6,  # sky
    26: 7,  # vehicle (car)
    28: 7,  # vehicle (bus)
}

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

CITYSCAPES = {"cls08": CITYSCAPES_CLS08}
VKITTI2 = {"cls08": VKITTI2_CLS08}
