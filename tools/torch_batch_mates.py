#!/usr/bin/env python3
"""Does an image's output from the PyTorch port depend on the other images
of its batch, or on its place there? A probe of `stablemtl_tpu_torch` on
one NVIDIA GPU.

    python3 tools/torch_batch_mates.py [--dtype float32] [--res 512]
        [--variants all] [--bisect mix|place] [--json out.json]

It builds the flagship serving configuration (`chip_smoke.FLAGSHIP_CONFIG`,
seeded random weights) and runs `infer_all_tasks` on batches of two
serving requests x and y: A = [x, y], B = [x, x], D = [y, y], E = [y, x].
For each variant of the path (the kernels on or off, cuDNN's
deterministic algorithms or none, bf16 GEMM reductions in f32) it prints
max |A[:, 0] - B[:, 0]| and max |A[:, 1] - E[:, 0]| (the effect of the
batch mate's content), max |E[:, 1] - B[:, 0]| (the effect of the place in
the batch) and A run twice (run-to-run determinism).

--bisect finds the first op that makes such a difference. Module forward
hooks record every call's inputs and outputs; the first call whose output
is faulty is descended into, down to a module whose called submodules are
all sound, whose own aten ops are then recorded (a TorchDispatchMode) to
name the first faulty op. "mix": an element of run A that equals neither
run B's (image x) nor run D's (image y) has mixed the images, or the op is
not deterministic. "place": in run B both images are x, so a tensor whose
two images' parts differ under every layout the port folds the batch in
(leading axis interleaved, task-major; halved, batch-major; or axis 1 of
2) depends on the place. `--device cpu --preset tiny --res 16` rehearses
the probe on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_KERNELS = {"STABLEMTL_FUSED_GEGLU": "0", "STABLEMTL_DISABLE_FLASH": "1"}
# (name, environment, torch backend settings) of each variant of the path
VARIANTS = [
    ("default", {}, {}),
    ("no K6", {"STABLEMTL_FUSED_GEGLU": "0"}, {}),
    ("no K6, no flash", NO_KERNELS, {}),
    ("no K6, no flash, cuDNN deterministic", NO_KERNELS,
     {"cudnn": "deterministic"}),
    ("no K6, no flash, no prefix share, cuDNN deterministic",
     {**NO_KERNELS, "STABLEMTL_DISABLE_PREFIX_SHARE": "1"},
     {"cudnn": "deterministic"}),
    ("no K6, no flash, cuDNN off", NO_KERNELS, {"cudnn": "off"}),
    ("cuDNN deterministic", {}, {"cudnn": "deterministic"}),
    ("bf16 GEMM reductions in f32", {}, {"bf16_reduced": False}),
    ("cuDNN deterministic, bf16 GEMM reductions in f32", {},
     {"cudnn": "deterministic", "bf16_reduced": False}),
    ("no K6, no flash, cuDNN deterministic, bf16 GEMM reductions in f32",
     NO_KERNELS, {"cudnn": "deterministic", "bf16_reduced": False}),
]


def tensors(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in tensors(o)]
    return []


def host_copy(obj) -> list:
    return [t.detach().to("cpu", copy=True) for t in tensors(obj)]


def mixed(runs) -> tuple:
    """runs: the tensors of runs A, B, D. (elements of A equal to neither
    B's nor D's, the largest distance of such an element to the nearer)."""
    n, dist = 0, 0.0
    for ta, tb, td in zip(*runs):
        if ta.shape != tb.shape or ta.shape != td.shape:
            raise RuntimeError(f"runs disagree in shape: {ta.shape}, "
                               f"{tb.shape}, {td.shape}")
        m = (ta != tb) & (ta != td)
        k = int(m.sum())
        if k:
            n += k
            if ta.is_floating_point():
                near = ((ta - tb).abs().float().minimum(
                    (ta - td).abs().float()))[m]
                dist = max(dist, float(near.max()))
    return n, dist


def placed(runs) -> tuple:
    """runs: the tensors of run B ([x, x]). (elements that differ between
    the two images' parts under the nearest layout, their largest
    distance), summed over the tensors none of whose layouts splits them
    into equal parts."""
    import torch

    n, dist = 0, 0.0
    for t in runs[0]:
        if t.dim() == 0:
            continue
        parts = []
        if t.shape[0] % 2 == 0:
            half = t.shape[0] // 2
            parts += [(t[0::2], t[1::2]), (t[:half], t[half:])]
        if t.dim() >= 2 and t.shape[1] == 2:
            parts.append((t[:, 0], t[:, 1]))
        best = None
        for a, b in parts:
            if torch.equal(a, b):
                best = None
                break
            d = (a.float() - b.float()).abs()
            if best is None or float(d.max()) < best[1]:
                best = (int((d > 0).sum()), float(d.max()))
        if parts and best is not None:
            n += best[0]
            dist = max(dist, best[1])
    return n, dist


CHECKS = {"mix": ("ABD", mixed), "place": ("B", placed)}


class Runner:
    """The pipeline and the batches A, B, D, E."""

    def __init__(self, args):
        import torch

        import chip_smoke
        from stablemtl_tpu_torch.factory import build_pipeline
        from stablemtl_tpu_torch.predict import _to_norm

        cfg = json.loads(json.dumps(chip_smoke.FLAGSHIP_CONFIG))
        cfg["model"]["compute_dtype"] = args.dtype
        if args.preset:
            cfg["model"]["size_preset"] = args.preset
        chip_smoke.SERVE_RES = args.res
        t0 = time.perf_counter()
        self.pipe = build_pipeline(cfg, seed=0, device=args.device,
                                   image_hw=(args.res, args.res))
        print(f"[mates] {cfg['model']['size_preset']} {args.dtype} pipeline "
              f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        x, y = (torch.from_numpy(_to_norm(im)).to(self.pipe.device)
                for im in chip_smoke.serving_requests(2, seed=12))
        self.batches = {"A": torch.stack([x, y]), "B": torch.stack([x, x]),
                        "D": torch.stack([y, y]), "E": torch.stack([y, x])}

    def run(self, name):
        return self.pipe.infer_all_tasks(self.batches[name], None)


def apply_settings(settings: dict):
    """Set torch's backend switches; returns the previous ones."""
    import torch

    before = {"cudnn": ("off" if not torch.backends.cudnn.enabled else
                        "deterministic" if torch.backends.cudnn.deterministic
                        else "on"),
              "bf16_reduced": torch.backends.cuda.matmul
              .allow_bf16_reduced_precision_reduction}
    cudnn = settings.get("cudnn", "on")
    torch.backends.cudnn.enabled = cudnn != "off"
    torch.backends.cudnn.deterministic = cudnn == "deterministic"
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        settings.get("bf16_reduced", True)
    return before


def end_to_end(runner, variants) -> list:
    """The differences of each variant."""
    out = []
    for name, env, settings in variants:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        before = apply_settings(settings)
        try:
            a, b, e = (runner.run(k).float() for k in "ABE")
            again = runner.run("A").float()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            apply_settings(before)
        row = dict(variant=name,
                   mate_max_abs=float((a[:, 0] - b[:, 0]).abs().max()),
                   y_mate_max_abs=float((a[:, 1] - e[:, 0]).abs().max()),
                   place_max_abs=float((e[:, 1] - b[:, 0]).abs().max()),
                   rerun_max_abs=float((again - a).abs().max()))
        print(f"[mates] {name}: |A0-B0| {row['mate_max_abs']:.4e} "
              f"|A1-E0| {row['y_mate_max_abs']:.4e} (mate), |E1-B0| "
              f"{row['place_max_abs']:.4e} (place), A run twice "
              f"{row['rerun_max_abs']:.4e}", flush=True)
        out.append(row)
    return out


def record_calls(runner, modules, batch):
    """[(name, inputs, outputs)] of every call of `modules` in one run."""
    calls = []

    def hook(name):
        def fn(mod, args, kwargs, out):
            calls.append((name, host_copy((args, kwargs)), host_copy(out)))
        return fn

    handles = [m.register_forward_hook(hook(n), with_kwargs=True)
               for n, m in modules]
    try:
        runner.run(batch)
    finally:
        for h in handles:
            h.remove()
    return calls


def first_faulty_call(runner, modules, check):
    """The first call of `modules` whose output is faulty: (index, name,
    faulty output elements, their largest distance, faulty input
    elements), or None."""
    batches, fn = CHECKS[check]
    runs = [record_calls(runner, modules, b) for b in batches]
    if len({len(r) for r in runs}) != 1:
        raise RuntimeError("the runs made different calls")
    for i, calls in enumerate(zip(*runs)):
        n_out, dist = fn([c[2] for c in calls])
        if n_out:
            n_in, _ = fn([c[1] for c in calls])
            return i, calls[0][0], n_out, dist, n_in
    return None


def children(module, prefix: str) -> list:
    """The module's submodules that are called: its children, with the
    elements of ModuleList/ModuleDict containers in their place."""
    import torch

    out = []
    for n, m in module.named_children():
        if isinstance(m, (torch.nn.ModuleList, torch.nn.ModuleDict)):
            out += children(m, f"{prefix}.{n}")
        else:
            out.append((f"{prefix}.{n}", m))
    return out


def record_ops(runner, module, call_index: int, batch):
    """[(aten op, input shapes, outputs)] of the module's own code in its
    call `call_index` of one run (ops inside its submodules' calls are run,
    not recorded)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []
    depth = [0]

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if depth[0] == 0 and "empty" not in name:
                ops.append((name, [tuple(t.shape) for t in
                                   tensors((args, kwargs))], host_copy(out)))
            return out

    count, active = [0], [False]
    mode = Record()

    def pre(mod, args):
        if count[0] == call_index:
            mode.__enter__()
            active[0] = True

    def post(mod, args, out):
        if count[0] == call_index:
            mode.__exit__(None, None, None)
            active[0] = False
        count[0] += 1

    def enter(mod, args):
        depth[0] += 1

    def leave(mod, args, out):
        depth[0] -= 1

    handles = [module.register_forward_pre_hook(pre),
               module.register_forward_hook(post)]
    for _, m in children(module, ""):
        handles += [m.register_forward_pre_hook(enter),
                    m.register_forward_hook(leave)]
    try:
        runner.run(batch)
    finally:
        if active[0]:  # the call raised inside the recorded module
            mode.__exit__(None, None, None)
        for h in handles:
            h.remove()
    return ops


def call_names(runner, modules) -> list:
    """The names of the calls of `modules` in one run, in order."""
    names = []
    handles = [m.register_forward_hook(
        lambda mod, a, o, n=n: names.append(n)) for n, m in modules]
    try:
        runner.run("B")
    finally:
        for h in handles:
            h.remove()
    return names


def op_witness(runner, modules, index: int, check) -> list:
    """The first faulty aten ops of the own code of call `index` of
    `modules`."""
    batches, fn = CHECKS[check]
    order = call_names(runner, modules)
    name = order[index]
    k = sum(1 for n in order[:index] if n == name)
    module = dict(modules)[name]
    runs = [record_ops(runner, module, k, b) for b in batches]
    found = []
    for j, ops in enumerate(zip(*runs)):
        n, dist = fn([o[2] for o in ops])
        if n:
            op, shapes = ops[0][0], ops[0][1]
            found.append(dict(module=name, call=k, op_index=j, op=op,
                              input_shapes=shapes, faulty=n,
                              max_distance=dist,
                              before=[o[0] for o in
                                      runs[0][max(0, j - 4):j]]))
            print(f"[bisect] op #{j} of {name}'s own code, its call {k}: "
                  f"{op} on {shapes}: {n} faulty elements (up to "
                  f"{dist:.3e}); the ops before it: {found[-1]['before']}",
                  flush=True)
            if len(found) == 3:
                break
    if not found:
        print(f"[bisect] no aten op of {name}'s own code (call {k}) is "
              f"faulty: the fault is in a kernel launched outside the "
              f"dispatcher", flush=True)
    return found


def bisect(runner, check) -> dict:
    """Descend from the pipeline's modules to the first faulty op."""
    pipe = runner.pipe
    modules = children(pipe.vae, "vae")
    modules += [("unet_child", pipe.unet_child), ("unet", pipe.unet)]
    path, parent = [], None
    found = first_faulty_call(runner, modules, check)
    while found is not None:
        i, name, n_out, dist, n_in = found
        path.append(dict(call=i, module=name, faulty_outputs=n_out,
                         max_distance=dist, faulty_inputs=n_in))
        print(f"[bisect] {check}: first faulty call #{i} of its level: "
              f"{name}, {n_out} faulty output elements (up to {dist:.3e}), "
              f"{n_in} faulty input elements", flush=True)
        if n_in:
            # faulty before the call: in the parent's own code
            if parent is not None:
                path[-1]["ops"] = op_witness(runner, *parent, check)
            break
        subs = children(dict(modules)[name], name)
        sub = first_faulty_call(runner, subs, check) if subs else None
        if sub is None:
            path[-1]["ops"] = op_witness(runner, modules, i, check)
            break
        parent = (modules, i)
        modules, found = subs, sub
    if not path:
        print(f"[bisect] {check}: no module call is faulty", flush=True)
    return {"check": check, "path": path}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--res", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--preset", default=None,
                        help="override the config's size_preset")
    parser.add_argument("--variants", default="all",
                        help="'all', 'none' or comma-separated indices")
    parser.add_argument("--bisect", choices=sorted(CHECKS), default=None)
    parser.add_argument("--json", default=None)
    args = parser.parse_args()

    import torch

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("STABLEMTL_FUSED_GEGLU", "1")
    runner = Runner(args)
    variants = (VARIANTS if args.variants == "all" else [] if
                args.variants == "none" else
                [VARIANTS[int(i)] for i in args.variants.split(",")])
    with torch.inference_mode():
        result = dict(dtype=args.dtype, res=args.res,
                      end_to_end=end_to_end(runner, variants))
        if args.bisect:
            result["bisect"] = bisect(runner, args.bisect)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
