"""queue_wait_p95_ms.serve: the nearest-rank 95th percentile of the
window's requests' waits in `ServingSession`'s queue (the program's
`stablemtl.serve.queue` spans, from `submit` to the start of the
request's group's step), host ms."""

from bench_port.harness.stats import percentile


def read(record):
    if record.get("kind") != "serve" or "spans" not in record:
        return None
    waits = record["spans"]["queue_ms"]
    return percentile(waits, 95) if waits else None
