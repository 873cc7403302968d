"""Nothing a run loads is JAX, Flax or the JAX package: a run of the
harness at the tiny preset on the CPU, in a fresh process, then its
loaded modules by whole top-level name (`stablemtl_tpu_torch` begins
with `stablemtl_tpu` and is the program)."""

import json
import os
import subprocess
import sys

from bench_port.harness import cells
from bench_port.harness.main import FORBIDDEN, forbidden_modules

SCRIPT = """
import json, sys
from bench_port.tests.bench_helpers import tiny_context
from bench_port.harness import cells
from bench_port.harness.main import forbidden_modules
for w, mix in (("ms-infer-b8", dict(batch=1, pool_batches=1,
                                    warmup_steps=1)),
               ("ms-serve-poisson", dict(batch=1, rate=4.0, pool=2,
                                         check_requests=1,
                                         warmup_steps=1))):
    ctx = tiny_context(w, seconds=0.3, **mix)
    cells.kind(ctx.cell.mix).run(ctx)
for name in [m["name"] for m in json.load(open("BENCHMARK.json"))
             ["per_layer"]]:
    cells.reader(name)
import bench_port.calibrate, bench_port.sweep
import bench_port.workcount.count
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": forbidden_modules(), "tops": tops}))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=cells.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert "stablemtl_tpu_torch" in res["tops"]
    assert not set(res["tops"]) & set(FORBIDDEN)


def test_the_check_compares_whole_top_level_names():
    names = ["stablemtl_tpu_torch", "stablemtl_tpu_torch.ops", "jaxtyping",
             "flaxen", "numpy"]
    assert forbidden_modules(names) == []
    names += ["stablemtl_tpu.ops", "jax.numpy"]
    assert forbidden_modules(names) == ["jax", "stablemtl_tpu"]
