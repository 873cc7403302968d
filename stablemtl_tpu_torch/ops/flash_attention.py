"""Flash attention: hand-written Hopper kernels as custom ops, their plain
versions, and the autograd Functions around them.

Each kernel replaces a TPU kernel of `stablemtl_tpu/ops/flash_attention.py`:

| wrapper                  | op                       | TPU kernel          |
| ------------------------ | ------------------------ | ------------------- |
| `flash_fwd_resident`     | `flash_fwd_a` (kernel A) | `_fa_kernel_nolse`  |
| `flash_fwd_resident_lse` | `flash_fwd_lse` (K3)     | `_fa_kernel` + lse  |
| `flash_bwd_dq`           | `flash_bwd_dq` (K4)      | `_fa_dq_kernel`     |
| `flash_bwd_dkv`          | `flash_bwd_dkv` (K5)     | `_fa_dkv_kernel`    |
| `flash_fwd_stream`       | `flash_fwd_b` (kernel B) | `_fa_stream_kernel` |

The op `stablemtl::<op>` launches the kernel built from `csrc/<op>.cu`.

Each wrapper takes folded [batch*heads, S, d] tensors (the logsumexp and
delta rows as [batch*heads, S] f32) and calls its `torch.library` custom op
(`cuda_build.define_op`), which runs the plain version for CPU tensors,
launches the kernel for CUDA tensors (or raises) and counts the launch in
the wrapper's `launches` attribute, and gives shapes alone under a trace,
so `torch.export` records the op as one node. In bf16 all five are Hopper
kernels on TMA and `wgmma` (`csrc/sm90.cuh`): A and K3 share
`csrc/flash_fwd_a_sm90.cuh`, K4 and K5 `csrc/flash_bwd_sm90.cuh`; their
f32 instances are scalar checking kernels (`csrc/flash_fwd.cuh`,
`csrc/flash_common.cuh`). Each source notes what bounds it on the H100 and
how its design answers that.

`_Flash` and `_FlashStream` are the counterparts of the JAX package's
`_flash` and `_flash_stream` custom VJPs, taken only under autograd: the
resident path runs K3 and saves q, k, v, o and the logsumexp, and its
backward runs K4 and K5; the streaming path's backward is autograd of the
plain version, as in JAX (no training path differentiates it: the VAE runs
under no_grad). Without a gradient `flash_attention` calls kernel A's or
B's op directly.

The JAX package's two forward variants are read at call time from the same
flags, off by default: STABLEMTL_FLASH_POLY_EXP = 3 or 4 (`exp2_poly`
replaces exp2 in kernels A, B and K3; the backward keeps exp2, reading the
variant's logsumexp) and STABLEMTL_FLASH_MXU_LSUM (the row sum of kernel A
and K3 out of the tensor cores, for head dims below 128, as the ones column
the JAX package appends to V). Each op takes them as arguments (`poly`,
`lsum`), so a traced program holds them as constants.
"""

from __future__ import annotations

import torch

from ..utils.env import env_flag, mxu_lsum, poly_exp, reject_tpu_only_flags
from . import cuda_build

LOG2E = 1.4426950408889634  # the softmax runs in base 2
# fast-softmax guard: base-2 scores clamp to +-FAST_CLAMP, so a row with
# |logits| beyond ~76 nats flattens instead of overflowing exp2 to inf
FAST_CLAMP = 110.0
# the exact softmax's running max before the first key tile (its rescale
# factor, exp2 of about -1e30, multiplies zeros)
NEG_INF = -1e30
# minimax coefficients of 2^f on [0, 1), highest degree first (the JAX
# package's _EXP2_POLY_COEFFS)
EXP2_POLY_COEFFS = {
    3: (0.07801587, 0.22605866, 0.69584812, 0.99992266),
    4: (0.01353328, 0.05201061, 0.24144534, 0.69300269, 1.00000269),
}
# the head dims each kernel has instances for: the presets' UNet heads and
# the tiny VAE's mid block (A, K3, K4, K5), the small and full VAE mid
# blocks (B)
RESIDENT_HEAD_DIMS = (16, 32, 64)  # kernel A family: accumulator in registers
STREAM_HEAD_DIMS = (256, 512)      # kernel B: output d split across warpgroups
RESIDENT_MAX_HEAD_DIM = 128        # larger head dims go to kernel B
# MXU_LSUM applies below this head dim, as in the JAX package
LSUM_MAX_HEAD_DIM = 127


def _key_tiles() -> dict:
    """Keys per tile of each forward kernel's online softmax, by op and
    dtype, read from the kernels' own constants (A_BN, B_BN and the f32
    templates' in csrc/flash_common.cuh). Under the exact softmax with a
    variant on, the result depends on the tile, as the JAX kernel's depends
    on its block_k: the polynomial's rescale factor is not exact (at 0 it
    is 1 - 7.7e-5 at degree 3, and every tile rescales), and the row sum of
    p rounded to bf16 rounds p against each tile's running max. The ops'
    plain versions run the same tiles."""
    import re

    text = (cuda_build.CSRC / "flash_common.cuh").read_text()
    bn = {name: int(n) for name, n in
          re.findall(r"constexpr int (\w+_BN) = (\d+);", text)}
    return {("flash_fwd_a", torch.bfloat16): bn["A_BN"],
            ("flash_fwd_a", torch.float32): bn["RESIDENT_F32_BN"],
            ("flash_fwd_lse", torch.bfloat16): bn["A_BN"],
            ("flash_fwd_lse", torch.float32): bn["RESIDENT_F32_BN"],
            ("flash_fwd_b", torch.bfloat16): bn["B_BN"],
            ("flash_fwd_b", torch.float32): bn["STREAM_F32_BN"]}


KEY_TILE = _key_tiles()
_DTYPE_CODE = cuda_build.DTYPE_CODE


def variant(d: int) -> tuple:
    """(poly, lsum) the flags give a flash call at head dim d: the
    polynomial everywhere, the row sum on the tensor cores on the resident
    path below head dim 128 only, as in the JAX package."""
    lsum = d <= LSUM_MAX_HEAD_DIM and mxu_lsum()
    return poly_exp(), lsum


def fast_softmax() -> bool:
    """Drop the running max (p = exp2(clamp(s))): STABLEMTL_FLASH_FAST_SOFTMAX,
    defaulting to the STABLEMTL_FAST_MATH tier, as in the JAX package."""
    return env_flag("STABLEMTL_FLASH_FAST_SOFTMAX",
                    default=env_flag("STABLEMTL_FAST_MATH"))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def exp2_poly(x, degree: int):
    """2^x as the JAX package's `_exp2_fast`, operation for operation: x
    clamped at -126, xi = floor(x), f = x - xi, a degree-`degree`
    polynomial in f by Horner's rule in f32, times 2^xi built as
    ((xi + 127) << 23) in int32 viewed as f32. Relative error up to 7.74e-5
    at degree 3 (at f = 0) and 2.78e-6 at degree 4."""
    if degree not in EXP2_POLY_COEFFS:
        raise ValueError(f"exp2_poly: degree {degree} is not 3 or 4")
    x = x.float().clamp(min=-126.0)
    xi = torch.floor(x)
    f = x - xi
    c = EXP2_POLY_COEFFS[degree]
    p = torch.full_like(f, c[0])
    for ci in c[1:]:
        p = p * f + ci
    return p * ((xi.to(torch.int32) + 127) << 23).view(torch.float32)


def _exp2(poly: int):
    """The forward's exp2: exact, or the polynomial of degree `poly`."""
    if poly:
        return lambda x: exp2_poly(x, poly)
    return torch.exp2


def flash_forward_lse_reference(q, k, v, fast_softmax: bool, poly: int = 0,
                                lsum: bool = False, block_k=None):
    """Plain version of kernel A, K3 and kernel B on [BH, S, d]: base-2
    softmax of the f32 scores (clamped and max-free under fast_softmax),
    probabilities rounded to the input dtype for the P.V product, f32
    accumulation, o = acc / l. Returns (o, lse), lse [BH, S] f32 the base-2
    logsumexp m + log2(l) (log2(l) under fast softmax, where m = 0).

    poly (3, 4): p from `exp2_poly` instead of exp2. lsum: l is the f32 sum
    of p rounded to the input dtype, what a ones column in V gives. With
    either set, the exact softmax and `block_k`, the online softmax runs
    over tiles of block_k keys as the kernels and the JAX kernel's body
    do (`KEY_TILE`); otherwise over all keys at once."""
    if poly not in (0, *EXP2_POLY_COEFFS):
        raise ValueError(f"poly {poly} is not 0, 3 or 4")
    if block_k and (poly or lsum) and not fast_softmax:
        return _tiled_exact_forward(q, k, v, poly, lsum, block_k)
    e2 = _exp2(poly)
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2
    if fast_softmax:
        m = torch.zeros(s.shape[:-1] + (1,), device=s.device)
        p = e2(s.clamp(-FAST_CLAMP, FAST_CLAMP))
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = e2(s - m)
    p_in = p.to(q.dtype).float()
    l = (p_in if lsum else p).sum(dim=-1, keepdim=True)
    out = torch.matmul(p_in, v.float())
    return (out / l).to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _tiled_exact_forward(q, k, v, poly: int, lsum: bool, block_k: int):
    """The exact online softmax over tiles of `block_k` keys (the JAX
    package's `_fa_kernel` body at that block_k): per tile, the running max
    m, the rescale alpha = exp2(m_prev - m), p = exp2(s - m), acc and l
    rescaled by alpha before the tile's p v and row sum are added."""
    e2 = _exp2(poly)
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf = q.float()
    m = torch.full(q.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for j in range(0, k.shape[1], block_k):
        s = torch.matmul(qf, k[:, j:j + block_k].float().transpose(-1, -2))
        s = s * scale2
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = e2(m - m_new)
        p = e2(s - m_new[..., None])
        p_in = p.to(q.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(
            p_in, v[:, j:j + block_k].float())
        l = l * alpha + (p_in if lsum else p).sum(dim=-1)
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m + torch.log2(l)


def flash_reference(q, k, v, fast_softmax: bool, poly: int = 0,
                    lsum: bool = False, block_k=None):
    """The attention output of `flash_forward_lse_reference`."""
    return flash_forward_lse_reference(q, k, v, fast_softmax, poly, lsum,
                                       block_k)[0]


def row_delta(do, o):
    """delta = rowsum(dO o O) in f32, [BH, S]: computed outside the backward
    kernels, as the JAX package computes it outside its Pallas kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_probs(q, k, v, do, lse, delta):
    """(P, dS) of the backward, f32 [BH, S, S]: P = exp2(s - lse) with no
    clamp (as the TPU kernels), dS = P o (dO V^T - delta)."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale2
    p = torch.exp2(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta):
    """Plain version of K4: dQ = d^-1/2 * dS K, dS rounded to the input
    dtype before its product, f32 accumulation, scaled at the end."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta)
    dq = torch.matmul(ds.to(q.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta):
    """Plain version of K5: dK = d^-1/2 * dS^T Q and dV = P^T dO, with P and
    dS rounded to the input dtype before their products."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, o, lse, do):
    """(dq, dk, dv) of the flash backward: the plain versions of K4 and K5
    with delta = rowsum(dO o O)."""
    delta = row_delta(do, o)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta))


# ---------------------------------------------------------------------------
# Custom ops: one per kernel
# ---------------------------------------------------------------------------

def _check(entry: str, head_dims, xs, rows=()):
    """Raise unless the [BH, S, d] tensors `xs` share one device, shape and
    dtype, with d in head_dims, and the per-row tensors `rows` are [BH, S]
    f32 there; every tensor contiguous."""
    q = xs[0]
    if q.dim() != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{entry}: tensors must share one [BH, S, d] shape: "
                         f"{[tuple(x.shape) for x in xs]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{entry}: head dim {q.shape[-1]} not in {head_dims}")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"flash kernels take float32 or bfloat16 tensors; "
                         f"got {[x.dtype for x in xs]}")
    if any(r.shape != q.shape[:2] or r.dtype != torch.float32 for r in rows):
        raise ValueError(f"{entry}: per-row tensors must be [BH, S] float32")
    if any(x.device != q.device for x in (*xs, *rows)):
        raise ValueError(f"{entry}: tensors on different devices")
    if not all(x.is_contiguous() for x in (*xs, *rows)):
        raise ValueError("flash kernels take contiguous tensors")


def _shape_args(q):
    bh, s, d = q.shape
    return bh, s, d, _DTYPE_CODE[q.dtype]


def _forward(entry, head_dims, q, k, v, fast_softmax, variant,
             want_lse=False):
    """Launch forward kernel `entry`; `variant` holds its variant ints
    ((poly, lsum), or (poly,) for kernel B), which pick the instance."""
    _check(entry, head_dims, (q, k, v))
    o = torch.empty_like(q)
    tensors = (q, k, v, o)
    if want_lse:
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        tensors += (lse,)
    cuda_build.launch(entry, tensors, *_shape_args(q), int(fast_softmax),
                      *(int(x) for x in variant),
                      q.shape[-1] ** -0.5 * LOG2E)
    return (o, lse) if want_lse else o


def _bwd_scalars(q):
    d = q.shape[-1]
    return (*_shape_args(q), d ** -0.5 * LOG2E, d ** -0.5)


def _fwd_a_cuda(q, k, v, fast, poly=0, lsum=False):
    o = _forward("flash_fwd_a", RESIDENT_HEAD_DIMS, q, k, v, fast,
                 (poly, lsum))
    cuda_build.count_launch(flash_fwd_resident)
    return o


def _fwd_lse_cuda(q, k, v, fast, poly=0, lsum=False):
    out = _forward("flash_fwd_lse", RESIDENT_HEAD_DIMS, q, k, v, fast,
                   (poly, lsum), want_lse=True)
    cuda_build.count_launch(flash_fwd_resident_lse)
    return out


def _fwd_b_cuda(q, k, v, fast, poly=0):
    o = _forward("flash_fwd_b", STREAM_HEAD_DIMS, q, k, v, fast, (poly,))
    cuda_build.count_launch(flash_fwd_stream)
    return o


def _bwd_dq_cuda(q, k, v, do, lse, delta):
    _check("flash_bwd_dq", RESIDENT_HEAD_DIMS, (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    cuda_build.launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq),
                      *_bwd_scalars(q))
    cuda_build.count_launch(flash_bwd_dq)
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta):
    _check("flash_bwd_dkv", RESIDENT_HEAD_DIMS, (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cuda_build.launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                      *_bwd_scalars(q))
    cuda_build.count_launch(flash_bwd_dkv)
    return dk, dv


def _fwd_fake(q, k, v, fast, poly=0, lsum=False):
    return q.new_empty(q.shape)


def _fwd_lse_fake(q, k, v, fast, poly=0, lsum=False):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2],
                                             dtype=torch.float32)


def _bwd_dq_fake(q, k, v, do, lse, delta):
    return q.new_empty(q.shape)


def _bwd_dkv_fake(q, k, v, do, lse, delta):
    return k.new_empty(k.shape), v.new_empty(v.shape)


def _plain_forward(op: str, want_lse: bool):
    """The CPU implementation of forward op `op`: the plain version on the
    key tiles of the op's kernel in the tensors' dtype (`KEY_TILE`)."""
    def plain(q, k, v, fast, poly=0, lsum=False):
        out = flash_forward_lse_reference(q, k, v, fast, poly, lsum,
                                          KEY_TILE.get((op, q.dtype)))
        return out if want_lse else out[0]
    return plain


_FWD = ("(Tensor q, Tensor k, Tensor v, bool fast, int poly=0, "
        "bool lsum=False) -> ")
_FWD_B = "(Tensor q, Tensor k, Tensor v, bool fast, int poly=0) -> "
_BWD = ("(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
        "Tensor delta) -> ")
OPS = {
    "flash_fwd_a": cuda_build.define_op(
        "flash_fwd_a", _FWD + "Tensor", _plain_forward("flash_fwd_a", False),
        _fwd_a_cuda, _fwd_fake),
    "flash_fwd_lse": cuda_build.define_op(
        "flash_fwd_lse", _FWD + "(Tensor, Tensor)",
        _plain_forward("flash_fwd_lse", True), _fwd_lse_cuda,
        _fwd_lse_fake),
    "flash_fwd_b": cuda_build.define_op(
        "flash_fwd_b", _FWD_B + "Tensor", _plain_forward("flash_fwd_b", False),
        _fwd_b_cuda, _fwd_fake),
    "flash_bwd_dq": cuda_build.define_op(
        "flash_bwd_dq", _BWD + "Tensor", flash_bwd_dq_reference,
        _bwd_dq_cuda, _bwd_dq_fake),
    "flash_bwd_dkv": cuda_build.define_op(
        "flash_bwd_dkv", _BWD + "(Tensor, Tensor)", flash_bwd_dkv_reference,
        _bwd_dkv_cuda, _bwd_dkv_fake),
}


# ---------------------------------------------------------------------------
# Kernel wrappers: each calls its op and holds its launch count
# ---------------------------------------------------------------------------

def _call(name, *args):
    """Op `name` on args; a tensor on neither the CPU nor CUDA raises (a
    meta tensor would reach the op's shape-only implementation)."""
    if args[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash kernels take CUDA or CPU tensors, got "
                         f"{args[0].device}")
    return OPS[name](*args)


def flash_fwd_resident(q, k, v, fast_softmax: bool, poly: int = 0,
                       lsum: bool = False):
    """Kernel A (op `stablemtl::flash_fwd_a`): attention on [BH, S, d] with
    d in RESIDENT_HEAD_DIMS; `poly` and `lsum` pick a variant."""
    return _call("flash_fwd_a", q, k, v, fast_softmax, poly, lsum)


def flash_fwd_resident_lse(q, k, v, fast_softmax: bool, poly: int = 0,
                           lsum: bool = False):
    """K3 (op `stablemtl::flash_fwd_lse`): kernel A's output and the per-row
    base-2 logsumexp [BH, S] f32."""
    return _call("flash_fwd_lse", q, k, v, fast_softmax, poly, lsum)


def flash_fwd_stream(q, k, v, fast_softmax: bool, poly: int = 0):
    """Kernel B (op `stablemtl::flash_fwd_b`): attention on [BH, S, d] with
    d in STREAM_HEAD_DIMS; `poly` picks a variant (no `lsum`: the JAX
    package's streaming kernel ignores that flag)."""
    return _call("flash_fwd_b", q, k, v, fast_softmax, poly)


def flash_bwd_dq(q, k, v, do, lse, delta):
    """K4 (op `stablemtl::flash_bwd_dq`): dQ [BH, S, d] from q, k, v, dO and
    the per-row lse and delta."""
    return _call("flash_bwd_dq", q, k, v, do, lse, delta)


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """K5 (op `stablemtl::flash_bwd_dkv`): (dK, dV) [BH, S, d] from q, k, v,
    dO and the per-row lse and delta."""
    return _call("flash_bwd_dkv", q, k, v, do, lse, delta)


KERNELS = (flash_fwd_resident, flash_fwd_stream, flash_fwd_resident_lse,
           flash_bwd_dq, flash_bwd_dkv)
for _kernel in KERNELS:
    _kernel.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """Resident flash attention on [BH, S, d] under autograd: the forward is
    K3 (in the variant `poly`, `lsum` picks) and saves q, k, v, o and the
    logsumexp; the backward, the same for every variant, computes
    delta = rowsum(dO o O) in f32, then dQ (K4) and dK, dV (K5). Under
    activation recompute (`models/unet.py`) the forward runs again in the
    backward, K3 included: the "dots" policy keeps only matrix products'
    outputs, and a custom op is not one."""

    @staticmethod
    def forward(ctx, q, k, v, fast: bool, poly: int, lsum: bool):
        o, lse = flash_fwd_resident_lse(q, k, v, fast, poly, lsum)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = row_delta(do, o)
        dq = flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
        return dq, dk, dv, None, None, None


class _FlashStream(torch.autograd.Function):
    """Streaming flash attention (kernel B) under autograd. Its backward
    differentiates the plain exact-softmax version, as JAX's
    `_flash_stream` does."""

    @staticmethod
    def forward(ctx, q, k, v, fast: bool, poly: int):
        ctx.save_for_backward(q, k, v)
        return flash_fwd_stream(q, k, v, fast, poly)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            o = flash_reference(*qkv, fast_softmax=False)
        return (*torch.autograd.grad(o, qkv, do), None, None)


def flash_attention(q, k, v):
    """Self-attention [B, S, H, d] -> [B, S, H, d] through the kernels that
    fit the head dim: up to 128 the output accumulator fits registers
    (kernel A, or K3/K4/K5 under autograd); beyond, kernel B splits it
    across the warpgroups of a CTA. On the card a head dim the kernel has no
    instance of raises. STABLEMTL_FLASH_POLY_EXP and STABLEMTL_FLASH_MXU_LSUM
    are read here, as the JAX package reads them at trace time; the row sum
    rides the tensor cores on the resident path below head dim 128 only."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention needs q, k, v of one [B, S, H, d] "
                         "shape")
    if q.is_cuda:
        reject_tpu_only_flags()
    b, s, h, d = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    args = (fold(q), fold(k), fold(v), fast_softmax())
    resident = d <= RESIDENT_MAX_HEAD_DIM
    poly, lsum = variant(d)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if resident:
            out = _Flash.apply(*args, poly, lsum)
        else:
            out = _FlashStream.apply(*args, poly)
    else:  # the op itself, so a trace records it; the variant's keywords
        # only where set, so the default call keeps its four arguments
        kwargs = {k: v for k, v in (("poly", poly), ("lsum", lsum)) if v}
        out = (flash_fwd_resident if resident else flash_fwd_stream)(
            *args, **kwargs)
    return out.view(b, h, s, d).permute(0, 2, 1, 3)
