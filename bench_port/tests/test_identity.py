"""What the SD2 configurations' plain reference gives the benchmark:
seeded weights, conditioning and outputs at the tiny preset on the CPU,
and each cell's work at full size on the meta device, held to constants
recorded from the harness when it reached the SD2 reference by name.
A change to how the harness finds a configuration's reference that moves
any of them changes what the benchmark reads."""

import hashlib
import json

import pytest
import torch

from bench_port.harness import cells, program
from bench_port.harness.refcheck import plain_reference
from bench_port.tests.bench_helpers import tiny_config, tiny_context
from bench_port.workcount.count import infer_work, train_work

SEED = 2**31 + 18
# the weights' digests: (compute dtype, drawn for training) -> module ->
# SHA-256; the text table's; all-task maps of two 32x32 images, float32
TINY = {
    "stablemtl-ms-sd2": {
        "weights": {
            ("float32", False): {
                "vae": "801616284352dae4e259364a52171b1e3113b2103a1ae8382f6390ea2527e40f",
                "unet": "ec32dc8aff5b2917c1aac641893a414de5bcf60b47fcc236555b6dbe722c71ed",
                "child": "e9f064fbb5db8f7bfe658c95a605f65110fe739a05bfed4776bd47ca8a38841c"},
            ("bfloat16", False): {
                "vae": "4ef6be02f5f713a4c2e8c568aebf75a4950cef1775004c623a169fe1b7f3f6c6",
                "unet": "9659a6f94645d6823cb4b74e3a009a6c00d04d699fa61b0e3eaa54af71ce669d",
                "child": "29edcc0a28bd9394336241c91087650a05f726aa81ca642f1ef698fd97d2c842"},
            ("bfloat16", True): {
                "vae": "4ef6be02f5f713a4c2e8c568aebf75a4950cef1775004c623a169fe1b7f3f6c6",
                "unet": "88b781a1d73cab1a4971553d9dcc1b2f078df2597faec36fb10b53d963c8469a",
                "child": "6ea19823dd0910f3ff1e1e715b931bc6c393081151b6e29b51bf8f44678b6bde"}},
        "text_embed_table": "34b1b9fe46eb09508fe69e4a88f195fc23aee6bafb203bd239220724bb75a622",
        "infer_all_tasks": "1e6a4adffb557b62fb82de79a01e1ecc283575a799b199097448bf25e00fb7c7"},
    "stablemtl-s-sd2": {
        "weights": {
            ("float32", False): {
                "vae": "801616284352dae4e259364a52171b1e3113b2103a1ae8382f6390ea2527e40f",
                "unet": "0fc8fac552840a143a05cd5e608f1f928b398c03e3ee6f7354aca30ee2c818b3"},
            ("bfloat16", False): {
                "vae": "4ef6be02f5f713a4c2e8c568aebf75a4950cef1775004c623a169fe1b7f3f6c6",
                "unet": "6763287c9d1794237e587be3e049e1d529cd6972d13aba1eb3d9eb76853756f5"},
            ("bfloat16", True): {
                "vae": "4ef6be02f5f713a4c2e8c568aebf75a4950cef1775004c623a169fe1b7f3f6c6",
                "unet": "2c472a247b23e18e41213c097f5a01800420a56345fb65764fd941a8b6031503"}},
        "text_embed_table": "34b1b9fe46eb09508fe69e4a88f195fc23aee6bafb203bd239220724bb75a622",
        "infer_all_tasks": "37383d9d0105ae1059a41284d2e2df020e677bccde3093b2cedc79d3c16f926f"},
}
# each cell's step at full size: (FLOPs, attention calls, the calls'
# SHA-256); training: the main tasks 0 and 3 (a two-frame task)
WORK = {
    "ms-infer-b8": {None: (215527980531712, 72, "55bae6e96463f1469cc15aa1d773b33fe9a761dfab4fa9e6d23b40b141336e07")},
    "ms-serve-poisson": {None: (215527980531712, 72, "55bae6e96463f1469cc15aa1d773b33fe9a761dfab4fa9e6d23b40b141336e07")},
    "s-infer-b8": {None: (168666183237632, 40, "62ae6ac0aad33c4f3cdeb9a4a3c25c59d676d066a6ae8b1438028e096d7e2b7c")},
    "ms-train-mb16": {
        0: (68508895019008, 65, "182de94380cb388eaae75618d6397fc2e0ec811760ec073b255c30275a1d13a9"),
        3: (68508895019008, 65, "182de94380cb388eaae75618d6397fc2e0ec811760ec073b255c30275a1d13a9")},
}
# the training reference through the checked micro-steps of
# ms-train-mb16 at the tiny preset, micro-batch 2, 32x48
TRAIN = {
    "losses": ["0.1640254408121109", "0.17081564664840698",
               "0.19947348535060883", "0.2745629847049713",
               "0.26765453815460205", "0.21052607893943787"],
    "first_grad": "dcdb4ac1026a95ca3bceba0beb1f7069c79fb40cf302c60c5a42152587d8011f",
    "params": "0c8682ae4a6393446b4663626fd9ed59796766e958114f339f003e4b9dcd8f62",
    "draws": "4b200c70f4a06e553001ba7b92d538af633c917b1aa6614184fa12590fe67a4a",
}


def digest(named) -> str:
    """SHA-256 of (name, dtype, shape, bytes) of each tensor in turn."""
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    """One CPU thread: the same order of every sum, run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cells_of(config: str) -> list:
    bench = cells.load_json(f"{cells.ROOT}/BENCHMARK.json")
    return [w["name"] for w in bench["workloads"] if w["config"] == config]


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_reference_draws_and_counts_as_recorded(name, one_thread):
    want = TINY[name]
    for (dtype, trainable), modules in want["weights"].items():
        cfg = tiny_config(name, dtype)
        weights = program.draw_weights(
            cfg, SEED, "cpu", program.weight_dtypes(cfg, trainable))
        assert {k: digest(v.items()) for k, v in weights.items()} \
            == modules, (dtype, trainable)
        plain = cells.reference_of(cfg)
        assert {k: digest([(k, v)]) for k, v in plain.conditioning(
            cfg, SEED, "cpu").items()} == {
                "text_embed_table": want["text_embed_table"]}
    cfg = tiny_config(name)
    x = torch.from_numpy(program.draw_images(SEED, 2, (32, 32), "cpu"))
    out = plain_reference(cfg, SEED, "cpu").infer_all_tasks(x, None)
    assert digest([("out", out)]) == want["infer_all_tasks"]
    for workload in _cells_of(name):
        cell = cells.find(workload)
        hw = (int(cell.mix["height"]), int(cell.mix["width"]))
        for task, (flops, n_calls, calls) in WORK[workload].items():
            if task is None:
                got = infer_work(cell.config, int(cell.mix["batch"]), hw)
            else:
                got = train_work(cell.config, int(cell.mix["micro_batch"]),
                                 hw, task=task)
            assert got["flops"] == flops, (workload, task)
            assert len(got["attention"]) == n_calls, (workload, task)
            assert hashlib.sha256(json.dumps(
                [list(c) for c in got["attention"]]).encode()
            ).hexdigest() == calls, (workload, task)


def test_the_training_reference_follows_as_recorded(one_thread):
    from bench_port.harness.kinds import train

    ctx = tiny_context("ms-train-mb16", micro_batch=2, pool=6, height=32,
                       width=48, seed=SEED)
    mix = ctx.cell.mix
    oc = train.optimizer_config(ctx.cell.config, int(mix["accumulation"]))
    readings, trainer = train.reference_readings(
        ctx, train.make_batches(SEED, mix, "cpu"),
        program.derived_seed(SEED, "steps"), oc)
    assert [repr(x) for x in readings.losses] == TRAIN["losses"]
    assert digest(sorted(readings.first_grad.items())) == TRAIN["first_grad"]
    assert digest(zip(trainer.names, trainer.params)) == TRAIN["params"]
    assert digest([(f"{i}.{j}.{k}", x) for i, d in enumerate(readings.draws)
                   for j, drawn in enumerate(d)
                   for k, x in enumerate(drawn)]) == TRAIN["draws"]
