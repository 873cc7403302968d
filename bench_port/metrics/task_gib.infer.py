"""task_gib.infer: GiB of child taps and K/V tables a window step makes:
the program's counter `stablemtl.infer.task_bytes` (`pipeline.
main_streams`) over the window's steps (its `stablemtl.infer.encode`
spans). None for a pipeline without banks."""


def read(record):
    if record.get("kind") != "infer" or "spans" not in record:
        return None
    spans = record["spans"]
    total = spans["counters"].get("stablemtl.infer.task_bytes")
    steps = spans["names"].get("stablemtl.infer.encode")
    if not total or not steps:
        return None
    return total / steps["count"] / 2**30
