"""copy_ms.serve: host ms a window step in the program's
`stablemtl.serve.copy` span (the result's cast to f32, its copy to host
memory and each request's own copy, until the group's last future is
resolved), over its steps."""


def read(record):
    if record.get("kind") != "serve" or "spans" not in record:
        return None
    d = record["spans"]["names"].get("stablemtl.serve.copy")
    return d["host_ms"] / d["count"] if d else None
