"""PyTorch port, ops layer: the plain flash functions (forward, forward with
logsumexp, backward) against the JAX Pallas kernels (interpret mode), the
autograd Functions around the kernels, the attention dispatch, the plain
GEGLU projection against the JAX plain and Pallas paths and the port's
GEGLU gate, the folded-kernel upsample, and the port's import isolation and
entry-point contract."""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from stablemtl_tpu.ops.attention import _xla_attention
from stablemtl_tpu.ops.flash_attention import (_flash, _flash_backward,
                                                _flash_forward, _flash_stream)
from stablemtl_tpu.ops.geglu import _plain_geglu
from stablemtl_tpu.ops.geglu import geglu_proj as jax_geglu_proj
from stablemtl_tpu.ops.phase_upsample import upsample2x_conv3x3 as jax_up
from stablemtl_tpu_torch.ops import attention as port_attention
from stablemtl_tpu_torch.ops import flash_attention as port_flash
from stablemtl_tpu_torch.ops.flash_attention import (
    flash_attention, flash_backward_reference, flash_bwd_dkv,
    flash_bwd_dkv_reference, flash_bwd_dq, flash_bwd_dq_reference,
    flash_forward_lse_reference, flash_fwd_resident, flash_fwd_resident_lse,
    flash_fwd_stream, flash_reference, row_delta)
from stablemtl_tpu_torch.ops import geglu as port_geglu
from stablemtl_tpu_torch.ops.phase_upsample import upsample2x_conv3x3
from torch_port_helpers import assert_close, nhwc_to_nchw
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(shape, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape,jax_fn", [
    ((1, 256, 2, 64), _flash),          # resident kernel (kernel A)
    ((1, 512, 1, 128), _flash_stream),  # streaming kernel, routed to A
    ((1, 256, 1, 512), _flash_stream),  # VAE mid block's d: kernel B
], ids=["resident", "stream", "stream_d512"])
def test_flash_plain_matches_pallas(monkeypatch, shape, jax_fn, fast, dtype):
    monkeypatch.setenv("STABLEMTL_FLASH_FAST_SOFTMAX", "1" if fast else "0")
    q, k, v = _qkv(shape, seed=shape[1])
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    assert got.dtype == tdt and got.shape == shape
    assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_fast_softmax_extreme_logits_bounded(monkeypatch):
    """Under fast softmax rows with logits far beyond ~76 nats degrade
    through the clamp: finite, inside the hull of V, and equal to the JAX
    kernel's output on the same inputs."""
    r = np.random.RandomState(33)
    base_q, base_k = r.standard_normal((2, 1, 256, 64))
    v = r.standard_normal((1, 256, 1, 64)).astype(np.float32)
    for scale in (40.0, -40.0):
        q = (base_q * scale).astype(np.float32)[..., None, :]
        k = (base_k * abs(scale)).astype(np.float32)[..., None, :]
        qf, kf, vf = (torch.from_numpy(x[:, :, 0]) for x in (q, k, v))
        got = flash_reference(qf, kf, vf, fast_softmax=True)
        assert torch.isfinite(got).all()
        assert got.abs().max() <= float(np.abs(v).max()) + 1e-3
        monkeypatch.setenv("STABLEMTL_FLASH_FAST_SOFTMAX", "1")
        with pltpu.force_tpu_interpret_mode():
            want = _flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        assert_close(got, np.asarray(want)[:, :, 0], atol=2e-5, rtol=2e-5)


def _fold(x):
    """[B, S, H, d] numpy -> [B*H, S, d] torch, the kernels' layout (and the
    Pallas kernels' `_fold`)."""
    b, s, h, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(b * h, s, d)))


# every head dim K3, K4 and K5 have instances for; d = 32 keeps the ids it
# had before the other two were added
@pytest.mark.parametrize("d,fast", [(32, False), (32, True), (16, False),
                                    (16, True), (64, False), (64, True)],
                         ids=["False", "True", "d16-False", "d16-True",
                              "d64-False", "d64-True"])
def test_lse_and_backward_plain_match_pallas(monkeypatch, d, fast):
    """The plain versions of K3, K4 and K5 against the Pallas kernels they
    replace, `_flash_forward(want_lse=True)` and `_flash_backward`, in
    interpret mode at [1, 512, 2, d] for every head dim the kernels ship
    (RESIDENT_HEAD_DIMS), with 128-row and 128-key blocks, so every JAX loop
    spans several blocks. o and lse at the per-block bar 2e-5; dq, dk, dv
    at the attention-gradient bar 2e-4."""
    assert d in port_flash.RESIDENT_HEAD_DIMS
    monkeypatch.setenv("STABLEMTL_FLASH_FAST_SOFTMAX", "1" if fast else "0")
    for name in ("STABLEMTL_FLASH_BLOCK_Q", "STABLEMTL_FLASH_BLOCK_K",
                 "STABLEMTL_FLASH_BLOCK_K_BWD"):
        monkeypatch.setenv(name, "128")
    shape = (1, 512, 2, d)
    q, k, v = _qkv(shape, seed=11)
    do = _qkv(shape, seed=12)[0]
    with pltpu.force_tpu_interpret_mode():
        jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
        j_o, j_lse = _flash_forward(jq, jk, jv, want_lse=True)
        j_grads = _flash_backward(jq, jk, jv, j_o, j_lse, jdo)
    j_o, j_lse = np.asarray(j_o), np.asarray(j_lse)[..., 0]
    o, lse = flash_forward_lse_reference(_fold(q), _fold(k), _fold(v), fast)
    assert_close(o, _fold(j_o), atol=2e-5, rtol=2e-5)
    assert_close(lse, j_lse, atol=2e-5, rtol=2e-5)
    grads = flash_backward_reference(_fold(q), _fold(k), _fold(v), _fold(j_o),
                                     torch.from_numpy(j_lse.copy()),
                                     _fold(do))
    for got, want in zip(grads, j_grads):
        assert_close(got, _fold(np.asarray(want)), atol=2e-4, rtol=2e-4)


def _graph_nodes(t):
    """Names of the autograd nodes behind t."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack.extend(f for f, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


@pytest.mark.parametrize("d,function", [(32, "_FlashBackward"),
                                        (256, "_FlashStreamBackward")],
                         ids=["resident", "stream"])
def test_flash_functions_give_plain_gradients(d, function):
    """On CPU tensors that require grad, flash_attention runs its autograd
    Function (resident: the plain K3 forward, K4 and K5 backward; stream:
    autograd of the plain version) and its dq, dk, dv equal autograd of
    plain_attention, at the per-block bar 2e-5."""
    shape = (2, 96, 2, d)
    qkv = [torch.from_numpy(x).requires_grad_() for x in _qkv(shape, seed=d)]
    g = torch.from_numpy(_qkv(shape, seed=d + 1)[0])
    out = flash_attention(*qkv)
    assert function in _graph_nodes(out)
    want = torch.autograd.grad(port_attention.plain_attention(*qkv), qkv, g)
    for got, w in zip(torch.autograd.grad(out, qkv, g), want):
        assert_close(got, w, atol=2e-5, rtol=2e-5)
    with torch.no_grad():  # no graph, and kernel A's path
        assert flash_attention(*qkv).grad_fn is None


def test_train_wrappers_cpu_run_plain_and_count_nothing():
    """K3, K4 and K5's wrappers run their plain versions on CPU tensors and
    count no launch; a tensor on neither the CPU nor CUDA raises instead of
    reaching plain math."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _qkv((2, 70, 16), seed=3) + _qkv((2, 70, 16), seed=4)[:1])
    wrappers = (flash_fwd_resident_lse, flash_bwd_dq, flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    o, lse = flash_fwd_resident_lse(q, k, v, fast_softmax=False)
    ref_o, ref_lse = flash_forward_lse_reference(q, k, v, False)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert lse.shape == (2, 70) and lse.dtype == torch.float32
    delta = row_delta(do, o)
    assert torch.equal(flash_bwd_dq(q, k, v, do, lse, delta),
                       flash_bwd_dq_reference(q, k, v, do, lse, delta))
    for got, want in zip(flash_bwd_dkv(q, k, v, do, lse, delta),
                         flash_bwd_dkv_reference(q, k, v, do, lse, delta)):
        assert torch.equal(got, want)
    assert [w.launches for w in wrappers] == before
    meta = torch.empty(2, 70, 16, device="meta")
    rows = torch.empty(2, 70, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_bwd_dq(meta, meta, meta, meta, rows, rows)


@pytest.mark.parametrize("wrapper", [flash_fwd_resident, flash_fwd_stream])
def test_wrapper_cpu_runs_plain_and_counts_nothing(wrapper):
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 64, 64), seed=1))
    before = wrapper.launches
    out = wrapper(q, k, v, fast_softmax=False)
    assert wrapper.launches == before
    assert torch.equal(out, flash_reference(q, k, v, fast_softmax=False))


@pytest.mark.parametrize("sq,sk,bias", [(16, 16, False), (16, 77, False),
                                        (12, 12, True)])
def test_plain_attention_matches_xla(sq, sk, bias):
    r = np.random.RandomState(sq + sk)
    q = r.standard_normal((2, sq, 3, 32)).astype(np.float32)
    k, v = (r.standard_normal((2, sk, 3, 32)).astype(np.float32)
            for _ in range(2))
    b = (r.standard_normal((2, 3, sq, sk)).astype(np.float32)
         if bias else None)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if b is None else jnp.asarray(b))
    got = port_attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if b is None else torch.from_numpy(b))
    assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_dispatch_rule(monkeypatch):
    q = torch.zeros(1, 1024, 1, 64)
    assert not port_attention.use_flash(q, q)  # CPU tensor: plain math
    meta = torch.zeros(1, 1024, 1, 64, device="meta")
    assert not port_attention.use_flash(meta, meta)  # not CUDA either
    # head dims up to 128 go to kernel A, larger ones to kernel B
    called = []
    for name in ("flash_fwd_resident", "flash_fwd_stream"):
        monkeypatch.setattr(port_flash, name,
                            lambda q, k, v, fast_softmax, name=name:
                            called.append(name) or q)
    for d in (16, 32, 64, 128, 256, 512):
        x = torch.zeros(1, 8, 1, d)
        flash_attention(x, x, x)
        assert called.pop() == ("flash_fwd_resident" if d <= 128
                                else "flash_fwd_stream"), d
    # every preset's long self-attention has a kernel instance on the card:
    # the UNet heads (block width / heads) and the VAE's single mid head
    from stablemtl_tpu_torch.factory import model_configs
    for preset in ("nano", "tiny", "small", "full"):
        ucfg, ccfg, vcfg, _ = model_configs(preset, multi_stream=True)
        dims = {c // h for cfg in (ucfg, ccfg)
                for c, h in zip(cfg.block_out_channels, cfg.attention_heads)}
        dims.add(vcfg.block_out_channels[-1])
        for d in dims:
            have = (port_flash.RESIDENT_HEAD_DIMS
                    if d <= port_flash.RESIDENT_MAX_HEAD_DIM
                    else port_flash.STREAM_HEAD_DIMS)
            assert d in have, (preset, d)


def _geglu_inputs(rows, c, f, seed):
    """x [rows, C], the Flax kernel [C, 2F] (value columns, then gate
    columns) and bias [2F], scaled so both projections are ~N(0, 1)."""
    r = np.random.RandomState(seed)
    x = r.standard_normal((rows, c)).astype(np.float32)
    kernel = (r.standard_normal((c, 2 * f)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(2 * f)).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_geglu_reference_matches_jax_plain_and_pallas(fast_gelu):
    """K6's plain version against the JAX package's plain formulation and
    its Pallas kernel (interpret mode) at R=64, C=32, F=128."""
    x, kernel, bias = _geglu_inputs(64, 32, 128, seed=40 + fast_gelu)
    f = 128
    want_plain = _plain_geglu(jnp.asarray(x), jnp.asarray(kernel[:, :f]),
                              jnp.asarray(kernel[:, f:]),
                              jnp.asarray(bias[:f]), jnp.asarray(bias[f:]),
                              fast_gelu=fast_gelu)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax_geglu_proj(jnp.asarray(x), jnp.asarray(kernel),
                                     jnp.asarray(bias), fast_gelu=fast_gelu,
                                     use_fused=True)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.T))
    got = port_geglu.geglu_reference(torch.from_numpy(x), weight,
                                     torch.from_numpy(bias), fast_gelu)
    assert got.shape == (64, f)
    assert_close(got, want_plain, atol=2e-5, rtol=2e-5)
    assert_close(got, want_pallas, atol=2e-5, rtol=2e-5)
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    before = port_geglu.geglu_fused.launches
    assert torch.equal(port_geglu.geglu_fused(torch.from_numpy(x), weight,
                                              torch.from_numpy(bias),
                                              fast_gelu), got)
    assert port_geglu.geglu_fused.launches == before


def test_geglu_gate(monkeypatch):
    """The flag on a CPU tensor runs the plain version; forcing the kernel
    on the CPU or on an unsupported shape raises; gradients flow with the
    flag on; with the flag on, a card tensor takes the kernel's wrapper,
    which raises for an unsupported shape; every preset's feed-forward
    shape passes the kernel's gate."""
    x, kernel, bias = _geglu_inputs(10, 32, 128, seed=43)
    w = torch.from_numpy(np.ascontiguousarray(kernel.T))
    xt, b = torch.from_numpy(x), torch.from_numpy(bias)
    monkeypatch.setenv("STABLEMTL_FUSED_GEGLU", "1")
    before = port_geglu.geglu_fused.launches
    plain = port_geglu.geglu_reference(xt, w, b, False)
    assert torch.equal(port_geglu.geglu_proj(xt, w, b), plain)
    with pytest.raises(ValueError, match="CUDA"):
        port_geglu.geglu_proj(xt, w, b, use_fused=True)
    with pytest.raises(ValueError, match="unsupported shape"):
        port_geglu.geglu_proj(xt[:, :24], w[:, :24], b, use_fused=True)
    with pytest.raises(ValueError, match="unsupported shape"):
        port_geglu.geglu_proj(xt, w[:192], b[:192], use_fused=True)
    odd_w, odd_b = torch.ones(257, 32), torch.ones(257)  # an odd 2F
    assert not port_geglu.supported(xt, odd_w)
    with pytest.raises(ValueError, match="unsupported shape"):
        port_geglu.geglu_proj(xt, odd_w, odd_b, use_fused=True)
    with pytest.raises(ValueError, match="unsupported shapes"):
        port_geglu.geglu_fused(xt, odd_w, odd_b, False)
    assert port_geglu.geglu_fused.launches == before
    xg, wg = xt.clone().requires_grad_(), w.clone().requires_grad_()
    out = port_geglu.geglu_proj(xg, wg, b)
    gx, gw = torch.autograd.grad(out.square().sum(), (xg, wg))
    want = torch.autograd.grad(
        port_geglu.geglu_reference(xg, wg, b, False).square().sum(),
        (xg, wg))
    assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])

    class CudaLike(torch.Tensor):
        """A CPU tensor the gate takes for one on the card."""

        @property
        def is_cuda(self):
            return True

    # auto mode on a card tensor with no gradient goes to the kernel's
    # wrapper for every shape: an unsupported one raises there, it does not
    # run the plain version unannounced
    xc = xt.as_subclass(CudaLike)
    with pytest.raises(ValueError, match="unsupported shape"):
        port_geglu.geglu_proj(xc[:, :24], w[:, :24], b)
    called = []
    monkeypatch.setattr(port_geglu, "geglu_fused",
                        lambda *args: called.append(args) or plain)
    port_geglu.geglu_proj(xc, w, b)
    assert len(called) == 1
    monkeypatch.setenv("STABLEMTL_FUSED_GEGLU", "0")
    assert torch.equal(port_geglu.geglu_proj(xc, w, b), plain)
    assert len(called) == 1
    from stablemtl_tpu_torch.factory import model_configs
    from stablemtl_tpu_torch.models.layers import FeedForward
    widths = set()
    for preset in ("nano", "tiny", "small", "full"):
        ucfg, ccfg, _, _ = model_configs(preset, multi_stream=True)
        widths |= set(ucfg.block_out_channels) | set(ccfg.block_out_channels)
    assert sorted(widths) == [32, 64, 160, 320, 640, 1280]
    for c in sorted(widths):
        # the feed-forward of width C projects to [2F, C], F = 4C
        ff_w = FeedForward(c).net_0.proj.weight
        assert tuple(ff_w.shape) == (8 * c, c)
        assert port_geglu.supported(torch.zeros(1, c), ff_w), c


@pytest.mark.parametrize("hw", [(3, 5), (4, 4)])
def test_upsample_matches_jax_and_literal(hw):
    r = np.random.RandomState(hw[0])
    x = r.standard_normal((2,) + hw + (6,)).astype(np.float32)
    w = r.standard_normal((3, 3, 6, 5)).astype(np.float32) * 0.3  # HWIO
    b = r.standard_normal(5).astype(np.float32)
    want = jax_up(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = upsample2x_conv3x3(nhwc_to_nchw(x), w_t, torch.from_numpy(b))
    assert_close(got.permute(0, 2, 3, 1), want, atol=2e-5)
    literal = F.conv2d(F.interpolate(nhwc_to_nchw(x), scale_factor=2,
                                     mode="nearest"), w_t,
                       torch.from_numpy(b), padding=1)
    assert_close(got, literal, atol=2e-5)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in no jax and nothing of
    the JAX package (a fresh process: this one already imported jax)."""
    mods = sorted(
        "stablemtl_tpu_torch." + str(p.relative_to(REPO / "stablemtl_tpu_torch")
                                     .with_suffix("")).replace("/", ".")
        for p in (REPO / "stablemtl_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'stablemtl_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 10
    for m in ("serving", "cli.serve", "config", "models.clip", "ops.geglu",
              "data.semantic.encoding", "evaluation", "predict",
              "utils.png", "utils.visualizer", "factory", "cli.train",
              "cli.eval", "trainer", "checkpoint", "data.loader",
              "models.torch_convert", "utils.safetensors_io",
              "cli.convert_sd2"):
        assert "stablemtl_tpu_torch." + m in mods, m


def test_port_sources_import_no_jax():
    """Static check over the package, chip_smoke.py and the port's probes
    under tools/."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|stablemtl_tpu)"
                     r"(\s|\.|$)", re.M)
    files = list((REPO / "stablemtl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("torch_*.py"))
    for f in files:
        assert not pat.search(f.read_text()), f


def test_every_kernel_source_is_built_and_bound():
    """Every csrc/*.cu is a library of cuda_build (so chip_smoke.py's phase
    1 builds it), and every library has the ctypes signature of its entry
    point, which ctypes would otherwise truncate silently."""
    from stablemtl_tpu_torch.ops import cuda_build

    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    assert sources == sorted(cuda_build.SOURCES.values())
    assert set(cuda_build.SIGNATURES) == set(cuda_build.SOURCES)
    for name, source in cuda_build.SOURCES.items():
        n_ptr, n_int, n_float = cuda_build.SIGNATURES[name]
        text = (cuda_build.CSRC / source).read_text()
        decl = re.search(rf'extern "C" int smtl_{name}\((.*?)\)', text,
                         re.S)
        assert decl, source
        args = [a.strip() for a in decl.group(1).split(",")]
        assert args[-1] == "void* stream", source
        kinds = [("ptr" if "*" in a else a.split()[0]) for a in args[:-1]]
        assert kinds == (["ptr"] * n_ptr + ["int"] * n_int
                         + ["float"] * n_float), (source, kinds)


def test_entry_point_needs_cuda_unless_cpu():
    from stablemtl_tpu_torch.factory import build_pipeline

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline({"model": {"size_preset": "tiny"}}, image_hw=(16, 16))
    pipe = build_pipeline({"model": {"size_preset": "nano"}},
                          image_hw=(16, 16), device="cpu")
    assert pipe.device.type == "cpu"


def test_tpu_only_flags_raise(monkeypatch):
    from stablemtl_tpu_torch.utils.env import (TPU_ONLY_FLAGS,
                                               reject_tpu_only_flags)

    reject_tpu_only_flags()
    for name in TPU_ONLY_FLAGS:
        monkeypatch.setenv(name, "0")
        reject_tpu_only_flags()  # "0" keeps the default
        monkeypatch.setenv(name, "1")
        with pytest.raises(RuntimeError, match=name):
            reject_tpu_only_flags()
        monkeypatch.delenv(name)

