"""decode_ms.infer: device ms a step between CUDA events the benchmark
records around the pipeline's `decode_latent` (the VAE decodes of every
task's latents), over the window's steps."""


def read(record):
    if record.get("kind") != "infer":
        return None
    return record["span_ms"]["decode"]
