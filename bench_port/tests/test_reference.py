"""The plain reference against the port's pipeline at the tiny preset on
the CPU, in float32: the same seeded weights, text table and images,
every task's map within 1e-4 relative L2 (the repository's bar for a
composed UNet or VAE)."""

import pytest
import torch

from bench_port.harness import program
from bench_port.harness.check import worst_rel_l2
from bench_port.harness.refcheck import plain_reference
from bench_port.tests.bench_helpers import tiny_config


@pytest.mark.parametrize("name", ["stablemtl-ms-sd2", "stablemtl-s-sd2"])
def test_reference_matches_the_port(name):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = tiny_config(name)
    pipe = program.build_program(cfg, "cpu", (32, 32))
    program.load_program(pipe, cfg, 2**31 + 11, "cpu")
    images = program.draw_images(2**31 + 11, 2, (32, 32), "cpu")
    out = pipe.infer_all_tasks(torch.from_numpy(images), None)
    ref = plain_reference(cfg, 2**31 + 11, "cpu")
    want = ref.infer_all_tasks(torch.from_numpy(images), None, block=1)
    assert out.shape == want.shape == (7, 2, 32, 32, 3)
    assert worst_rel_l2(out.numpy(), want.numpy()) < 1e-4
    # the maps are not flat: every task and image carries signal
    assert float(want.std(dim=(2, 3, 4)).min()) > 1e-2


def test_same_seed_same_inputs_and_another_seed_others():
    cfg = tiny_config("stablemtl-ms-sd2")
    a = program.draw_weights(cfg, 3, "cpu", program.weight_dtypes(cfg))
    b = program.draw_weights(cfg, 3, "cpu", program.weight_dtypes(cfg))
    c = program.draw_weights(cfg, 4, "cpu", program.weight_dtypes(cfg))
    for key in a:
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name])
    name = "conv_in.weight"
    assert not torch.equal(a["unet"][name], c["unet"][name])
    assert (program.draw_images(3, 2, (8, 8), "cpu")
            == program.draw_images(3, 2, (8, 8), "cpu")).all()
