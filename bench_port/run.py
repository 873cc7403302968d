"""The benchmark of `stablemtl_tpu_torch` on one or more NVIDIA cards.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; the last line of standard output is the result as one JSON
object. The program's switches (every STABLEMTL_* variable) are cleared,
so its defaults are what is measured, and its caches stay inside the
checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _name in [n for n in os.environ if n.startswith("STABLEMTL_")]:
    del os.environ[_name]
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from bench_port.harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
