"""idle.serve: the share of the traced stretch of open-loop serving in
which no device operation runs, from the stretch that records device
activity alone."""


def read(record):
    if record.get("kind") != "serve":
        return None
    tr = record["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
