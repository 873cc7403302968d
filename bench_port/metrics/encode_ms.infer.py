"""encode_ms.infer: device ms a window step in the program's
`stablemtl.infer.encode` span (the VAE encode of the step's images,
`pipeline.infer_tasks_body`), between the CUDA events the span records,
over the window's steps (one encode span a step)."""


def read(record):
    if record.get("kind") != "infer" or "spans" not in record:
        return None
    d = record["spans"]["names"].get("stablemtl.infer.encode")
    if not d or d["device_ms"] is None:
        return None
    return d["device_ms"] / d["count"]
