"""attn_roofline.train: the flash kernels' share of their roofline over
the traced micro-steps: the least time of a micro-step's attention calls
that the kernels serve (self-attention of at least MIN_SEQ tokens; with
a gradient the forward with its logsumexp, K3, and the backward's dQ,
K4, and dK/dV, K5; without, the forward, K1 or K2), shapes from the
benchmark's own count on the plain reference, bound by
workcount/bounds.py in bf16, over the device time of the kernels whose
names match PATTERNS."""

from bench_port.workcount.bounds import flash_bound_ms

# kernel A's template (K1, K3), kernel B (K2), the backward (K4, K5)
PATTERNS = ("flash_fwd_a_sm90", "flash_fwd_b_sm90", "flash_bwd_sm90")
MIN_SEQ = 1024


def read(record):
    if record.get("kind") != "train":
        return None
    bound_ms = 0.0
    for bh, sq, sk, d, grad in record["attention_calls"]:
        if sq != sk or sq < MIN_SEQ:
            continue
        kinds = ("fwd_lse", "bwd_dq", "bwd_dkv") if grad else ("fwd",)
        bound_ms += sum(flash_bound_ms(k, bh, sq, d) for k in kinds)
    device_s = sum(s for name, s in record["trace"]["kernels"].items()
                   if any(p in name for p in PATTERNS))
    if device_s <= 0:
        return None
    return 100.0 * bound_ms * record["traced_steps"] / (device_s * 1e3)
