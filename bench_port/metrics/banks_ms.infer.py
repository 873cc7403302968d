"""banks_ms.infer: device ms a window step in the program's
`stablemtl.bank` spans (`TaskAttentionBank.forward`: 16 a step, one an
attention layer of the main UNet's streams), between the CUDA events
each records, over the window's steps (its `stablemtl.infer.encode`
spans). None for a pipeline without banks."""


def read(record):
    if record.get("kind") != "infer" or "spans" not in record:
        return None
    names = record["spans"]["names"]
    bank, steps = (names.get(n) for n in ("stablemtl.bank",
                                          "stablemtl.infer.encode"))
    if not bank or not steps or bank["device_ms"] is None:
        return None
    return bank["device_ms"] / steps["count"]
