"""fwd_host_ms.train: host ms a window micro-step in the program's
`stablemtl.train.forward` span (the batch to the card, the VAE encodes,
the frozen child and the main UNet forward, the loss), over the window's
micro-steps (one such span each)."""


def read(record):
    if record.get("kind") != "train" or "spans" not in record:
        return None
    span = record["spans"]["names"].get("stablemtl.train.forward")
    return span["host_ms"] / span["count"] if span else None
