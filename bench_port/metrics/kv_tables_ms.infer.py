"""kv_tables_ms.infer: device ms a window step in the program's
`stablemtl.infer.kv_tables` span (`pipeline.main_streams`: every bank's K
and V projections of every task's child taps, once a step), between the
CUDA events it records, over the window's steps (its
`stablemtl.infer.encode` spans). None for a pipeline without banks."""


def read(record):
    if record.get("kind") != "infer" or "spans" not in record:
        return None
    names = record["spans"]["names"]
    tables, steps = (names.get(n) for n in ("stablemtl.infer.kv_tables",
                                            "stablemtl.infer.encode"))
    if not tables or not steps or tables["device_ms"] is None:
        return None
    return tables["device_ms"] / steps["count"]
