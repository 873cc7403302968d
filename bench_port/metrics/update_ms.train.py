"""update_ms.train: device ms of an optimizer update (clip and Adam at
the accumulation boundary), between CUDA events the benchmark records
around `Optimizer._apply`, over the window's updates."""


def read(record):
    if record.get("kind") != "train" or not record["update_ms"]:
        return None
    return record["update_ms"]
