"""idle.infer: the share of the traced window in which no device
operation runs, from the stretch that records device activity alone."""


def read(record):
    if record.get("kind") != "infer":
        return None
    tr = record["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
