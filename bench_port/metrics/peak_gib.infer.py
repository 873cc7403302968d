"""peak_gib.infer: torch.cuda.max_memory_allocated over the measured
window, in GiB."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["window_peak_bytes"] / 2**30
