"""PyTorch port, the helpers left over: the losses and their weighter,
seeding, `chw2hwc` and the multi-resolution noise, `find_value_in_config`
and the profiling helpers, against the JAX package's on the same inputs
(numpy, f32, the CPU)."""

import glob
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.config import find_value_in_config as jax_find
from stablemtl_tpu.config import recursive_load_config as jax_load_config
from stablemtl_tpu.utils import loss as jax_loss
from stablemtl_tpu.utils import profiling as jax_profiling
from stablemtl_tpu.utils import seeding as jax_seeding
from stablemtl_tpu.utils.image_util import chw2hwc as jax_chw2hwc
from stablemtl_tpu_torch.config import (find_value_in_config,
                                        recursive_load_config)
from stablemtl_tpu_torch.utils import loss, profiling, seeding
from stablemtl_tpu_torch.utils.image_util import (chw2hwc,
                                                  multi_res_noise_like)
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loss_inputs(seed):
    """pred, target (positive: the silog losses take logs) [2, 5, 7] and a
    random valid mask with every image holding valid cells."""
    r = np.random.RandomState(seed)
    pred = r.uniform(0.5, 3.0, (2, 5, 7)).astype(np.float32)
    target = r.uniform(0.5, 3.0, (2, 5, 7)).astype(np.float32)
    mask = r.uniform(size=(2, 5, 7)) > 0.4
    mask[:, 0, 0] = True
    return pred, target, mask


@pytest.mark.parametrize("name,kwargs", [
    ("mse_loss", {}), ("l1_loss", {}),
    ("l1_loss_with_mask", {"batch_reduction": True}),
    ("mean_abs_rel", {}),
    ("silog_mse", {"reduction": "mean"}),
    ("silog_mse", {"log_pred": False, "batch_reduction": False}),
    ("silog_rmse", {}), ("silog_rmse", {"log_pred": False, "alpha": 2.0}),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())))
def test_losses_match_jax(name, kwargs):
    """get_loss by name, with and without a mask, at 1e-6 relative."""
    pred, target, mask = _loss_inputs(seed=len(name) + len(kwargs))
    port_fn = loss.get_loss(name, **kwargs)
    jax_fn = jax_loss.get_loss(name, **kwargs)
    for m in (mask, None):
        got = port_fn(torch.from_numpy(pred), torch.from_numpy(target),
                      None if m is None else torch.from_numpy(m))
        want = jax_fn(jnp.asarray(pred), jnp.asarray(target),
                      None if m is None else jnp.asarray(m))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)
    with pytest.raises(NotImplementedError):
        loss.get_loss("no_such_loss")


def test_moving_average_loss_weighter_matches_jax():
    """The weights over a sequence of steps: 1.0 while any loss is unseen,
    then the EMA balance clipped to [min_weight, max_weight]."""
    names = ["depth", "normal", "flow"]
    port = loss.MovingAverageLossWeighter(names, alpha=0.9)
    ref = jax_loss.MovingAverageLossWeighter(names, alpha=0.9)
    r = np.random.RandomState(3)
    # values a float32 tensor holds exactly, as a loss tensor would
    steps = [{"depth": 0.5}] + [
        {n: float(np.float32(v)) for n, v in
         zip(names, r.uniform(0.01, 20.0, 3))} for _ in range(12)]
    for step in steps:
        got = port({n: torch.tensor(v) for n, v in step.items()})
        assert got == ref(step)
    assert port.ema == ref.ema and min(got.values()) >= 0.2


def test_seeding_matches_jax():
    """generate_seed_sequence and step_rng equal the JAX package's;
    seed_all leaves Python's and numpy's generators as its does."""
    assert seeding.generate_seed_sequence(2024, 10) == \
        jax_seeding.generate_seed_sequence(2024, 10)
    assert seeding.generate_seed_sequence(1, 10) != \
        seeding.generate_seed_sequence(2024, 10)
    for seed, step, salt in ((0, 5, 0), (7, 6, 3), (2**40 + 1, 0, 1)):
        np.testing.assert_array_equal(
            seeding.step_rng(seed, step, salt).integers(0, 1 << 30, 4),
            jax_seeding.step_rng(seed, step, salt).integers(0, 1 << 30, 4))
    draws = []
    for seed_all in (seeding.seed_all, jax_seeding.seed_all):
        seed_all(2**33 + 5)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    seeding.seed_all(9)
    a = torch.rand(3)
    seeding.seed_all(9)
    assert torch.equal(torch.rand(3), a)


def test_chw2hwc_matches_jax():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(chw2hwc(x), jax_chw2hwc(x))


@pytest.mark.parametrize("strategy", ["original", "every_layer",
                                      "power_of_two", "random_step"])
def test_multi_res_noise_like(strategy):
    """The JAX package's own checks (tests/test_config_and_misc.py:98-116):
    shape, determinism under one generator state, unit std within 0.15,
    finite with strength 0, and an unknown strategy raises."""
    x = torch.zeros(2, 16, 16, 4)

    def noise(**kw):
        return multi_res_noise_like(torch.Generator().manual_seed(0), x,
                                    downscale_strategy=strategy, **kw)

    n1, n2 = noise(strength=0.9), noise(strength=0.9)
    assert n1.shape == x.shape and n1.dtype == torch.float32
    assert torch.equal(n1, n2)
    assert abs(float(n1.std()) - 1.0) < 0.15
    assert torch.isfinite(noise(strength=0.0)).all()
    with pytest.raises(ValueError, match="strategy"):
        multi_res_noise_like(torch.Generator(), x, downscale_strategy="nope")


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "config", "*.yaml"))), ids=os.path.basename)
def test_find_value_in_config_matches_jax(path):
    """Every key of the config tree, on the loaded Config and on its dict."""
    cfg, ref = recursive_load_config(path), jax_load_config(path)
    keys = set()

    def walk(node):
        if isinstance(node, dict):
            keys.update(node)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(ref.to_dict())
    assert keys
    for key in sorted(keys):
        assert find_value_in_config(cfg, key) == jax_find(ref, key), key
        assert find_value_in_config(cfg.to_dict(), key) == \
            jax_find(ref.to_dict(), key), key


def test_step_timer_annotate_and_trace(monkeypatch, tmp_path):
    """StepTimer's EMA against the JAX package's on one fake clock;
    `annotate` names a region the trace records; `trace` writes its file
    on the CPU."""
    clock = iter([0.0, 0.5, 1.0, 1.1, 2.0, 2.2] * 2)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    values = []
    for timer in (profiling.StepTimer(ema=0.5),
                  jax_profiling.StepTimer(ema=0.5)):
        for _ in range(3):
            with timer:
                pass
            values.append(timer.value)
    assert values[:3] == values[3:] == pytest.approx([0.5, 0.3, 0.25])
    monkeypatch.undo()

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("test-region"):
            torch.ones(4).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert "test-region" in {e.key for e in prof.key_averages()}
