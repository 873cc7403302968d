"""launches_per_step.train: device kernels a micro-step in the traced
micro-steps (updates included)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["trace"]["n_kernels"] / record["traced_steps"]
