"""idle_copy.serve: the share of the stretch that the profiler records
device activity alone in during which no device operation runs while the
session's collector thread was in the program's `stablemtl.serve.copy`
span (the result's cast, its copy to host memory and the per-request
copies): the gaps' midpoints put down to the spans open on that thread
(harness/spans.py::idle_by_span)."""


def read(record):
    if record.get("kind") != "serve" or "idle_by_span" not in record:
        return None
    idle = record["idle_by_span"]
    return 100.0 * idle["idle_s"].get(
        "stablemtl.serve.copy", 0.0) / idle["window_s"]
