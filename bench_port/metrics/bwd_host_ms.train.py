"""bwd_host_ms.train: host ms a window micro-step in the program's
`stablemtl.train.backward` span (`torch.autograd.grad` and the gradients
made contiguous), over the window's micro-steps (its
`stablemtl.train.forward` spans)."""


def read(record):
    if record.get("kind") != "train" or "spans" not in record:
        return None
    names = record["spans"]["names"]
    span = names.get("stablemtl.train.backward")
    steps = names.get("stablemtl.train.forward")
    return span["host_ms"] / steps["count"] if span and steps else None
