"""idle_fwd.train: the share of the stretch that the profiler records
device activity alone in during which no device operation runs while the
main thread was in the program's `stablemtl.train.forward` span (the
batch to the card, the VAE encodes, the frozen child and the main UNet
forward, the loss): the gaps' midpoints put down to the spans open on
that thread (harness/spans.py::idle_by_span)."""


def read(record):
    if record.get("kind") != "train" or "idle_by_span" not in record:
        return None
    idle = record["idle_by_span"]
    return 100.0 * idle["idle_s"].get(
        "stablemtl.train.forward", 0.0) / idle["window_s"]
