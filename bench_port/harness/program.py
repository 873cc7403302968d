"""What the benchmark takes from the program, and the inputs it hands to
both sides: the port's pipeline built through `factory.build_pipeline`,
and the seeded weights, conditioning and images."""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import cells

# what each derived seed draws (`derived_seed`)
SALT = {"weights": 1, "text": 2, "images": 3, "arrivals": 4, "sample": 5,
        "batches": 6, "steps": 7}
INIT_STD = 0.02


def derived_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose, mixed from the run's seed."""
    seq = np.random.SeedSequence([int(seed) % 2**64, SALT[what]])
    return int(seq.generate_state(1, dtype=np.uint64)[0] >> 1)


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, what))


def host_rng(seed: int, what: str) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, what))


def _fan_in(name: str, shape) -> int:
    """The inputs summed into each output of a product's weight: a bank
    kernel is [..., in, out], a linear weight [out, in], a conv weight
    [out, in, kh, kw]; 0 for a leaf that is no product's weight."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("_kernel"):
        return int(shape[-2])
    if leaf == "weight" and len(shape) in (2, 4):
        return int(torch.Size(shape[1:]).numel())
    return 0


def _scale_like(name: str) -> bool:
    """Norm scales: a `weight` of a module named *norm*, or a bank's
    `*_scale`. They are drawn around 1, the rest around 0."""
    parts = name.split(".")
    return "scale" in parts[-1] or (parts[-1] == "weight" and len(parts) > 1
                                    and "norm" in parts[-2])


def draw_weights(config: dict, seed: int, device, dtypes: dict) -> dict:
    """{module: {name: tensor}} for the modules of the configuration's
    plain reference (`build`), in the order they name their parameters: one
    normal draw per module of all its values, in `dtypes[module]`, each
    leaf scaled in place: a product's weight by 1/sqrt(fan-in) (signal
    keeps its scale through every layer, as in a trained model, so each
    output depends on its image), a bias by 0.02, a norm scale to 1 +
    0.02 z. The tensors are views of that one buffer."""
    gen = generator(seed, "weights", device)
    out = {}
    for key, module in cells.reference_of(config).build(config,
                                                         "meta").items():
        shapes = [(n, p.shape) for n, p in module.named_parameters()]
        total = sum(s.numel() for _, s in shapes)
        flat = torch.randn((total,), generator=gen, device=device,
                           dtype=dtypes[key]).mul_(INIT_STD)
        views, off = {}, 0
        for name, shape in shapes:
            v = flat[off:off + shape.numel()].view(shape)
            fan_in = _fan_in(name, shape)
            if fan_in:
                v.mul_(1.0 / (INIT_STD * fan_in ** 0.5))
            elif _scale_like(name):
                v.add_(1.0)
            views[name] = v
            off += shape.numel()
        out[key] = views
    return out


def draw_images(seed: int, n: int, hw, device, what="images") -> np.ndarray:
    """n distinct images [n, H, W, 3] in [-1, 1], made on the card and
    kept on the host."""
    gen = generator(seed, what, device)
    img = torch.rand((n, *hw, 3), generator=gen, device=device) * 2 - 1
    return img.cpu().numpy()


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` over the module's parameters, which must be the
    same names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise RuntimeError(f"the program's parameters differ from the "
                           f"reference's: not in the program {missing}, "
                           f"not in the reference {extra}")
    with torch.no_grad():
        for name, w in weights.items():
            p = params[name]
            if tuple(p.shape) != tuple(w.shape):
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"reference {tuple(w.shape)}")
            p.copy_(w)


def build_program(config: dict, device, hw, trainable: bool = False):
    """The port's pipeline of the configuration, through its normal
    path, at input size `hw`."""
    from stablemtl_tpu_torch.factory import build_pipeline

    return build_pipeline(copy.deepcopy(config["program_config"]), seed=0,
                          device=device, image_hw=tuple(hw),
                          trainable=trainable)


def weight_dtypes(config: dict, trainable: bool = False) -> dict:
    """The dtype each module's weights are drawn in: the compute dtype
    the program serves them in, float32 for trained master weights."""
    served = getattr(torch, config["program_config"]["model"].get(
        "compute_dtype", "float32"))
    return {"vae": served, "child": served,
            "unet": torch.float32 if trainable else served}


def load_program(pipe, config: dict, seed: int, device,
                 trainable: bool = False) -> None:
    """The benchmark's weights and conditioning into the program, each
    module's parameters and each conditioning tensor in the dtype the
    program keeps it in. The pipeline must have every attribute the
    conditioning names, at its shape: none is added."""
    weights = draw_weights(config, seed, device,
                           weight_dtypes(config, trainable))
    load_into(pipe.vae, weights["vae"])
    load_into(pipe.unet, weights["unet"])
    if "child" in weights:
        load_into(pipe.unet_child, weights["child"])
    elif pipe.unet_child is not None:
        raise RuntimeError("the program built a child UNet the "
                           "configuration does not have")
    for name, value in cells.reference_of(config).conditioning(
            config, seed, device).items():
        have = getattr(pipe, name, None)
        if not isinstance(have, torch.Tensor):
            raise RuntimeError(f"the program's pipeline has no tensor "
                               f"{name!r} for the reference's conditioning")
        if tuple(have.shape) != tuple(value.shape):
            raise RuntimeError(f"{name}: program {tuple(have.shape)}, "
                               f"reference {tuple(value.shape)}")
        setattr(pipe, name, value.to(have.dtype))
    del weights
