"""launches_per_step.infer: device kernels a step in the traced steps."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["trace"]["n_kernels"] / record["traced_steps"]
