"""Readings behind a cell's output limits, on the card, in one process:

    python3 bench_port/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--fault-seeds 31,32,33] [--out FILE]

All-task inference cells (kind offline or serve, at the mix's batch and
size): for each of --seeds, the seed's weights, conditioning and images
into the program, one timed-path step (`infer_all_tasks`), and its worst
relative L2 gap to the float32 reference on the same inputs (the lower
reading is the largest), with the gap a result handed to the wrong image
would read (the reference's maps of one image against the next's). For
each of --control-seeds the same gap of the control: the reference with
every product's operands rounded to fp8 e4m3 (the upper reading is the
smallest).

The training cell: for each of --seeds, the program's checked
micro-steps (`kinds/train.py`) and the numbers compared against the
reference following them; for each of --control-seeds the same numbers
of the fp8 reference put in the program's place; for each of
--fault-seeds those of the reference put in its place with half of each
batch left out (the mean taken over the rest).

One JSON line a seed and side to standard output and to --out.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def infer_readings(cell, args, emit) -> None:
    import torch

    from bench_port.harness import device as card
    from bench_port.harness import program
    from bench_port.harness.check import worst_rel_l2
    from bench_port.harness.refcheck import plain_float32, plain_reference
    from bench_port.reference.precision import precision

    cfg, mix, dev = cell.config, cell.mix, args.device
    B = int(mix.get("batch", 8))
    hw = (int(mix["height"]), int(mix["width"]))
    pipe = program.build_program(cfg, dev, hw)
    # the program runs under the process's defaults, the reference under
    # `plain_float32`
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    for seed, side in [(s, "program") for s in _seeds(args.seeds)] + \
            [(s, "control") for s in _seeds(args.control_seeds)]:
        t = time.perf_counter()
        x = torch.from_numpy(program.draw_images(seed, B, hw, dev)).to(dev)
        if side == "program":
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = defaults
            program.load_program(pipe, cfg, seed, dev)
            produced = pipe.infer_all_tasks(x, None).float().cpu().numpy()
        plain_float32()
        ref = plain_reference(cfg, seed, dev)
        want = ref.infer_all_tasks(x, None).cpu().numpy()
        if side == "control":
            with precision("fp8"):
                produced = ref.infer_all_tasks(x, None).cpu().numpy()
        del ref
        card.empty_cache(dev)
        wrong = min(worst_rel_l2(want[:, (b + 1) % B][:, None],
                                 want[:, b][:, None]) for b in range(B))
        emit({"seed": seed, "side": side,
              "worst_rel_l2": worst_rel_l2(produced, want),
              "wrong_image_rel_l2": wrong,
              "seconds": time.perf_counter() - t})


def train_readings(cell, args, emit) -> None:
    import gc

    from bench_port.harness import device as card
    from bench_port.harness import program
    from bench_port.harness.kinds import train
    from bench_port.harness.main import Context
    from bench_port.reference.precision import precision

    dev = args.device
    mix = cell.mix
    sides = [(s, "program") for s in _seeds(args.seeds)] + \
        [(s, "control") for s in _seeds(args.control_seeds)] + \
        [(s, "half_batch") for s in _seeds(args.fault_seeds)]
    for seed, side in sides:
        t = time.perf_counter()
        ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                      t_start=t, device=dev)
        if side == "program":
            prog = train.build(ctx)
            got = train.checked_steps(ctx, prog)
            pool, base_seed, oc = prog.pool, prog.base_seed, prog.oc
            del prog
        else:
            pool = train.make_batches(seed, mix, dev)
            base_seed = program.derived_seed(seed, "steps")
            oc = train.optimizer_config(cell.config,
                                        int(mix["accumulation"]))
            if side == "control":
                with precision("fp8"):
                    got, _ = train.reference_readings(ctx, pool, base_seed,
                                                      oc)
            else:
                half = slice(0, int(mix["micro_batch"]) // 2)
                got, _ = train.reference_readings(ctx, pool, base_seed, oc,
                                                  rows=half)
        gc.collect()
        card.empty_cache(dev)
        ref = train.reference_readings(ctx, pool, base_seed, oc,
                                       follow=got.draws)
        checks = train.compare(ctx, got, ref)
        del ref
        gc.collect()
        card.empty_cache(dev)
        emit({"seed": seed, "side": side,
              **{k: v for k, (v, _) in checks.items()},
              "losses": got.losses, "seconds": time.perf_counter() - t})


def main(argv=None) -> int:
    import argparse
    import json

    from bench_port.harness import cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name in [n for n in os.environ if n.startswith("STABLEMTL_")]:
        del os.environ[name]
    cell = cells.find(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(line: dict) -> None:
        text = json.dumps({"workload": cell.name, **line})
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    try:
        if cell.mix["kind"] == "train":
            train_readings(cell, args, emit)
        else:
            infer_readings(cell, args, emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
