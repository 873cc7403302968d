"""unet_ms.infer: device ms a step between CUDA events the benchmark
records around the pipeline's `child_taps_all_tasks` and `main_streams`
(the frozen child's pass and the main UNet's streams), over the
window's steps."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["span_ms"]["unet"]
