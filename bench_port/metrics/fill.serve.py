"""fill.serve: the share of the rows of the window's serving steps that
held a request (the rest pad the fixed batch): 100 x the program's
counter `stablemtl.serve.requests` over `stablemtl.serve.requests` +
`stablemtl.serve.padding_rows`, which is steps x batch."""


def read(record):
    if record.get("kind") != "serve" or "spans" not in record:
        return None
    c = record["spans"]["counters"]
    rows = c.get("stablemtl.serve.requests", 0) + \
        c.get("stablemtl.serve.padding_rows", 0)
    return 100.0 * c["stablemtl.serve.requests"] / rows if rows else None
