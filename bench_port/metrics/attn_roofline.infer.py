"""attn_roofline.infer: the flash forward kernels' share of their
roofline over the traced steps: the least time of the step's attention
calls that the kernels serve (self-attention of at least MIN_SEQ tokens,
shapes from the benchmark's own count on the plain reference, bound by
workcount/bounds.py in bf16) over the device time of the kernels whose
names match PATTERNS."""

from bench_port.workcount.bounds import flash_bound_ms

# kernel A (K1) and kernel B (K2) of csrc/flash_fwd_a_sm90.cuh and
# csrc/flash_fwd_b.cu
PATTERNS = ("flash_fwd_a_sm90", "flash_fwd_b_sm90")
MIN_SEQ = 1024


def read(record):
    if record.get("kind") != "infer":
        return None
    bound_ms = sum(flash_bound_ms("fwd", bh, sq, d)
                   for bh, sq, sk, d, _ in record["attention_calls"]
                   if sq == sk and sq >= MIN_SEQ)
    device_s = sum(s for name, s in record["trace"]["kernels"].items()
                   if any(p in name for p in PATTERNS))
    if device_s <= 0:
        return None
    return 100.0 * bound_ms * record["traced_steps"] / (device_s * 1e3)
