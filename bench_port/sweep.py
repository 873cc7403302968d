"""The rate sweep behind a serving cell's offered rate, on the card, in one
process:

    python3 bench_port/sweep.py --workload ms-serve-poisson \
        --rates 4,5,6,7 --seconds 30 --seed 1

For each rate, the cell's open-loop schedule (`kinds/serve.py`, in the
mix's arrival order) into one `ServingSession`, then: requests,
failures, p50 and p95 latency, and the
mean latency of the last quarter of the requests over that of the
first (a ratio that grows with the rate marks a backlog growing through
the window: the rate is above what the program sustains). One JSON line
a rate."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import numpy as np

    from bench_port.harness import cells, program
    from bench_port.harness.kinds.serve import Sender, schedule, wait_all
    from bench_port.harness.stats import percentile
    from stablemtl_tpu_torch.serving import ServingSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for name in [n for n in os.environ if n.startswith("STABLEMTL_")]:
        del os.environ[name]
    cell = cells.find(args.workload)
    cfg, mix = cell.config, cell.mix
    hw = (int(mix["height"]), int(mix["width"]))
    pipe = program.build_program(cfg, "cuda", hw)
    program.load_program(pipe, cfg, args.seed, "cuda")
    pool = program.draw_images(args.seed, int(mix["pool"]), hw, "cuda")
    with ServingSession(pipe, batch=int(mix["batch"]),
                        max_delay_s=float(mix["max_delay_s"])) as session:
        for _ in range(int(mix["warmup_steps"])):
            session.warmup(hw)
        for rate in [float(r) for r in args.rates.split(",")]:
            offsets = schedule(int(mix["arrival_seed"]), rate, args.seconds)
            n = len(offsets)
            pick = np.arange(n) % len(pool)
            sender = Sender(session, pool, pick)
            t0 = time.perf_counter()
            futures = sender.send(offsets, t0)
            wait_all(futures, t0 + offsets[-1] + float(mix["drain_s"]))
            lat = np.array([sender.done_at.get(i, np.inf) - (t0 + off)
                            for i, off in enumerate(offsets)])
            q = max(1, n // 4)
            print(json.dumps({
                "rate": rate, "requests": n,
                "failed": int(np.isinf(lat).sum()),
                "p50_ms": percentile(lat, 50) * 1e3,
                "p95_ms": percentile(lat, 95) * 1e3,
                "last_over_first_quarter": float(lat[-q:].mean()
                                                 / lat[:q].mean()),
                "sender_late_ms": sender.lateness * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
