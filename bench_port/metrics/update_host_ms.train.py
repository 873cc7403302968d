"""update_host_ms.train: host ms a window micro-step in the program's
`stablemtl.train.update` span (`state.apply_gradients`: the running mean
every micro-step, clip and Adam at the accumulation boundary), over the
window's micro-steps (its `stablemtl.train.forward` spans)."""


def read(record):
    if record.get("kind") != "train" or "spans" not in record:
        return None
    names = record["spans"]["names"]
    span = names.get("stablemtl.train.update")
    steps = names.get("stablemtl.train.forward")
    return span["host_ms"] / steps["count"] if span and steps else None
