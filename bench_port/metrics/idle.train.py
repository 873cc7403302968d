"""idle.train: the share of the traced micro-steps' window in which no
device operation runs, from the stretch that records device activity
alone (harness/trace.py: a profiler of host operations slows this
host-bound step by more than half)."""


def read(record):
    if record.get("kind") != "train":
        return None
    tr = record["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
