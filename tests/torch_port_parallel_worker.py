"""One rank of tests/test_torch_port_parallel.py's data-parallel and
tensor-parallel runs, on the CPU over gloo. Imports no jax (the test module
does).

    STABLEMTL_COORDINATOR=127.0.0.1:PORT STABLEMTL_NUM_PROCESSES=2 \\
    STABLEMTL_PROCESS_ID=R python tests/torch_port_parallel_worker.py DIR
    STABLEMTL_COORDINATOR=127.0.0.1:PORT STABLEMTL_NUM_PROCESSES=4 \\
    STABLEMTL_PROCESS_ID=R python tests/torch_port_parallel_worker.py DIR tp

DIR/inputs.pt (written by the test) holds the nano pipeline's state dicts
and the batches; each rank writes what it computed to DIR/rank<R>.pt
(DIR/tp_rank<R>.pt for the 2 x 2 (data x model) mesh), and rank 0
checkpoints under DIR/ckpt_*. Rank 0 also runs the one-process references
on the global batches.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stablemtl_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from stablemtl_tpu_torch.models.unet import (  # noqa: E402
    UNet2DConditionModel, tiny_unet_config)
from stablemtl_tpu_torch.models.vae import (  # noqa: E402
    AutoencoderKL, tiny_vae_config)
from stablemtl_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, make_mesh, shard_batch)
from stablemtl_tpu_torch.parallel.distributed import (  # noqa: E402
    loader_shard, maybe_initialize, shutdown)
from stablemtl_tpu_torch.parallel.sharded_train import (  # noqa: E402
    ShardedOptimizer, create_sharded_train_state, make_sharded_train_step)
from stablemtl_tpu_torch.pipeline import StableMTLPipeline  # noqa: E402
from stablemtl_tpu_torch.train_state import (  # noqa: E402
    Optimizer, OptimizerConfig, TrainState, create_train_state,
    downsample_valid_mask, flax_axes, make_train_step)

# the nano preset (factory.model_configs) with `highest` masking at ratio 1
NANO = dict(block_out_channels=(32, 64), attention_heads=(2, 2))
TRAINER = dict(attn_mask_ratio=1.0, attn_mask_type="highest")
HW = (16, 16)
# the ZeRO-1 runs: Adam with the flagship's clip over 4 micro-steps, an
# update every 2; leaves below ZERO1_MIN elements stay replicated
OPT = dict(lr=1e-3, max_grad_norm=5.0, accumulation_steps=2,
           use_schedule=False)
ZERO1_MIN = 64


def build_pipeline(inputs, **unet_kw) -> StableMTLPipeline:
    unet = UNet2DConditionModel(tiny_unet_config(
        use_task_attention=True, **dict(NANO, **unet_kw), **TRAINER))
    unet.load_state_dict(inputs["unet"], strict=True)
    child = UNet2DConditionModel(tiny_unet_config(**NANO))
    child.load_state_dict(inputs["child"], strict=True)
    vae = AutoencoderKL(tiny_vae_config())
    vae.load_state_dict(inputs["vae"], strict=True)
    return StableMTLPipeline(
        vae=vae.eval().requires_grad_(False), unet=unet.train(),
        unet_child=child.eval().requires_grad_(False),
        text_embed_table=inputs["table"], image_hw=HW)


def reset(pipe, inputs):
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            p.copy_(inputs["unet"][n])


def run(pipe, state, step, batches, mesh):
    losses = []
    for batch in batches:
        state, metrics = step(state, shard_batch(batch, mesh)
                              if mesh is not None else batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def bit_diff(a, b) -> float:
    """max |a - b| over two lists of tensors (0.0: bit-equal values)."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def state_lists(opt) -> list:
    """The optimizer's per-leaf state in order: mu, nu, acc."""
    return [t for key in ("mu", "nu") for t in opt.moments()[key]] + \
        list(opt.acc)


def main(d: str) -> None:
    torch.set_num_threads(1)
    if not maybe_initialize(device="cpu"):
        raise SystemExit("no process group asked for")
    mesh = make_mesh()
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=True)
    pipe = build_pipeline(inputs)
    out = {"rank": mesh.rank, "world": mesh.data}
    names = [n for n, _ in pipe.unet.named_parameters()]

    # -- loss and gradients of the global batch ----------------------------
    grad_batch = inputs["grad_batch"]
    state = TrainState(step=0, params=dict(pipe.unet.named_parameters()))
    step = make_sharded_train_step(pipe, mesh)
    loss, _, grads = step.loss_and_grads(state, shard_batch(grad_batch,
                                                            mesh))
    out["loss"] = float(loss)
    out["grads_digest"] = [float(g.double().sum()) for g in grads]
    if mesh.rank == 0:
        out["grads"] = dict(zip(names, grads))
    out["reduced_bytes"] = mesh.reduced_bytes

    # the clip's global norm and apply_if_finite's test on ZeRO-1 slices
    cfg = OptimizerConfig(**OPT)
    sharded = ShardedOptimizer(state.params.values(), cfg, mesh, ZERO1_MIN)
    local = [sharded.local(i, g) for i, g in enumerate(grads)]
    out["norm_sharded"] = float(sharded._global_norm(local))
    out["norm_whole"] = float(Optimizer._global_norm(sharded, grads))
    out["norm_f64"] = sum(float(g.double().square().sum())
                          for g in grads) ** 0.5
    out["replicated_sq"] = float(sum(
        g.double().square().sum() for g, a in zip(grads, sharded.shard_axes)
        if a is None))
    planted = [t.clone() for t in local]
    i = next(i for i, a in enumerate(sharded.shard_axes) if a is not None)
    if mesh.rank == mesh.data - 1:
        planted[i].view(-1)[0] = float("nan")  # only the last rank holds it
    out["finite_clean"] = sharded._all_finite(local)
    out["finite_planted"] = sharded._all_finite(planted)
    del sharded, local, planted

    # Adafactor under ZeRO-1 (the factored leaves' slices gathered at the
    # update) against the whole optimizer, on copies of the parameters and
    # the all-reduced gradients, through an update and a save
    fcfg = OptimizerConfig(optimizer="adafactor", lr=1e-3,
                           accumulation_steps=2, use_schedule=False)
    axes = [flax_axes(n, p.dim()) for n, p in state.params.items()]
    whole_p = [p.detach().clone() for p in state.params.values()]
    sliced_p = [p.detach().clone() for p in state.params.values()]
    whole = Optimizer(whole_p, fcfg, axes)
    sliced = ShardedOptimizer(sliced_p, fcfg, mesh, ZERO1_MIN, axes)
    for _ in range(3):
        whole.update(grads)
        sliced.update(grads)
    out["adafactor_params_diff"] = bit_diff(sliced_p, whole_p)
    CheckpointManager(os.path.join(d, "ckpt_adafactor"), mesh=mesh).save(
        TrainState(step=3, params=dict(zip(names, sliced_p)), opt=sliced))
    if mesh.rank == 0:
        saved = torch.load(os.path.join(d, "ckpt_adafactor", "latest",
                                        "opt_state.pt"), weights_only=True)
        out["adafactor_saved_diff"] = max(bit_diff(
            [saved[key][n] for n, t in zip(names, tensors) if t is not None],
            [t for t in tensors if t is not None])
            for key, tensors in dict(whole.moments(), acc=whole.acc).items())
    del whole, sliced, whole_p, sliced_p

    if mesh.rank == 0:
        # one process on the global batch, and each rank's rows on their
        # own (what a step without the reductions would see)
        plain = make_train_step(pipe)
        loss1, _, grads1 = plain.loss_and_grads(state, grad_batch)
        out["loss_1rank"] = float(loss1)
        diff = sum(float((g.double() - g1.double()).square().sum())
                   for g, g1 in zip(grads, grads1))
        norm = sum(float(g1.double().square().sum()) for g1 in grads1)
        out["grads_rel_l2_vs_1rank"] = (diff / norm) ** 0.5
        out["grads_max_abs_vs_1rank"] = max(
            float((g - g1).abs().max()) for g, g1 in zip(grads, grads1))
        k = len(grad_batch["rgb_norm"]) // mesh.data
        out["rows_losses"] = [float(plain.loss_and_grads(state, {
            key: v[r * k:(r + 1) * k] if torch.is_tensor(v) else v
            for key, v in grad_batch.items()})[0])
            for r in range(mesh.data)]
        out["rows_counts"] = [int(downsample_valid_mask(
            grad_batch["valid_mask"][r * k:(r + 1) * k]).sum())
            for r in range(mesh.data)]
    del state, grads

    # -- ZeRO-1 against replicated data parallelism, and resume ------------
    # (compared here, leaf by leaf on this rank's slices: the states are
    # 450 MB each at the nano preset)
    batches = inputs["batches"]
    runs = {}
    for zero1 in (False, True):
        tag = "zero1" if zero1 else "replicated"
        reset(pipe, inputs)
        st = create_sharded_train_state(pipe.unet, cfg, mesh, zero1=zero1,
                                        zero1_min_size=ZERO1_MIN)
        step = make_sharded_train_step(pipe, mesh, zero1=zero1,
                                       zero1_min_size=ZERO1_MIN)
        st, losses = run(pipe, st, step, batches[:3], mesh)
        CheckpointManager(os.path.join(d, f"ckpt_{tag}"), mesh=mesh).save(
            st, meta={"effective_iter": 1})
        st, more = run(pipe, st, step, batches[3:], mesh)
        out[f"{tag}_losses"] = losses + more
        runs[tag] = ([p.detach().clone() for p in st.params.values()],
                     [t.clone() for t in state_lists(st.opt)], st.opt)
        del st
    params_r, state_r, opt_r = runs["replicated"]
    params_z, state_z, opt_z = runs["zero1"]
    out["shard_axes"] = opt_z.shard_axes
    out["local_shapes"] = [tuple(t.shape) for t in opt_z.mu]
    out["zero1_params_diff"] = bit_diff(params_z, params_r)
    n = len(names)
    out["zero1_state_diff"] = bit_diff(state_z, [
        opt_z.local(i % n, t) for i, t in enumerate(state_r)])
    out["params_digest"] = [float(p.double().sum()) for p in params_z]
    del runs, state_r, opt_r, state_z, opt_z

    # resume: a fresh ZeRO-1 state restores micro-step 3 from the replicated
    # run's checkpoint (the layout of any world size) and runs micro-step 4
    reset(pipe, inputs)
    st = create_sharded_train_state(pipe.unet, cfg, mesh, zero1=True,
                                    zero1_min_size=ZERO1_MIN)
    st = CheckpointManager(os.path.join(d, "ckpt_replicated"),
                           mesh=mesh).restore(st)
    out["resumed_step"] = st.step
    step = make_sharded_train_step(pipe, mesh, zero1=True,
                                   zero1_min_size=ZERO1_MIN)
    st, _ = run(pipe, st, step, batches[3:], mesh)
    out["resumed_params_diff"] = bit_diff(
        [p.detach() for p in st.params.values()], params_z)
    del st, params_r, params_z
    out["staged_bytes"] = mesh.staged_bytes
    mesh.barrier()
    if mesh.rank == 0:
        out.update(check_checkpoints(pipe, cfg, d))
    torch.save(out, os.path.join(d, f"rank{mesh.rank}.pt"))
    mesh.barrier()
    shutdown()


def check_checkpoints(pipe, cfg, d: str) -> dict:
    """Rank 0 alone, after both runs: the ZeRO-1 run's checkpoint (slices
    gathered to rank 0) against the replicated run's, file for file; one
    process (no mesh) restores the ZeRO-1 one. The slots (600 MB each at
    the nano preset) are deleted after."""
    files = {}
    for tag in ("zero1", "replicated"):
        slot = os.path.join(d, f"ckpt_{tag}", "latest")
        files[tag] = [torch.load(os.path.join(slot, f), weights_only=True)
                      for f in ("params.pt", "opt_state.pt")]
    (pz, oz), (pr, orr) = files["zero1"], files["replicated"]
    res = {"ckpt_params_equal": set(pz) == set(pr) and all(
        torch.equal(pz[k], pr[k]) for k in pr)}
    res["ckpt_state_equal"] = all(
        set(oz[key]) == set(orr[key]) and all(
            torch.equal(oz[key][k], orr[key][k]) for k in orr[key])
        for key in ("mu", "nu", "acc"))
    res["ckpt_counters"] = {k: oz[k] for k in ("count", "mini_step")}
    state = CheckpointManager(os.path.join(d, "ckpt_zero1")).restore(
        create_train_state(pipe.unet, cfg))
    names = list(state.params)
    res["one_process_step"] = state.step
    res["one_process_params_equal"] = all(
        torch.equal(p, pz[n]) for n, p in state.params.items())
    res["one_process_state_equal"] = all(
        torch.equal(t, oz[key][n]) for key, tensors in (
            ("mu", state.opt.mu), ("nu", state.opt.nu),
            ("acc", state.opt.acc)) for n, t in zip(names, tensors))
    for tag in ("zero1", "replicated", "adafactor"):
        shutil.rmtree(os.path.join(d, f"ckpt_{tag}"))
    return res


def tp_main(d: str) -> None:
    """A rank of the 2 x 2 (data x model) mesh: tensor parallelism with
    ZeRO-1 over the data axis."""
    torch.set_num_threads(1)
    if not maybe_initialize(device="cpu"):
        raise SystemExit("no process group asked for")
    mesh = make_mesh(MeshConfig(model=2))
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=True)
    pipe = build_pipeline(inputs)
    names = [n for n, _ in pipe.unet.named_parameters()]
    out = {"process": mesh.process_rank, "data": mesh.data,
           "rank": mesh.rank, "model": mesh.model,
           "model_rank": mesh.model_rank}
    cfg = OptimizerConfig(**OPT)
    state = create_sharded_train_state(pipe.unet, cfg, mesh, zero1=True,
                                       zero1_min_size=ZERO1_MIN)
    layout = state.layout
    step = make_sharded_train_step(pipe, mesh, zero1=True,
                                   zero1_min_size=ZERO1_MIN)
    out["split"] = [layout.sharded(n) for n in names]

    # -- loss and gradients of the global batch, gathered whole -----------
    grad_batch = inputs["grad_batch"]
    mine = shard_batch(grad_batch, mesh)
    out["rows_digest"] = float(sum(mine[k].double().sum() for k in (
        "rgb_norm", "rgb_next_norm", "target_3ch")))
    out["loader_shard"] = loader_shard(mesh)
    loss, _, grads = step.loss_and_grads(state, mine)
    out["loss"] = float(loss)
    whole = [layout.whole(n, g) for n, g in zip(names, grads)]
    if mesh.process_rank == 0:
        out["grads"] = dict(zip(names, whole))
    out["model_bytes"] = mesh.model_bytes

    # the clip's norm on the state's layout: shards summed over the model
    # group, ZeRO-1 slices over the data group, whole leaves once
    opt = state.opt
    local = [opt.local(i, g) for i, g in enumerate(grads)]
    out["norm_tp"] = float(opt._global_norm(local))
    out["norm_f64"] = sum(float(g.double().square().sum())
                          for g in whole) ** 0.5

    # Adafactor on the TP + ZeRO-1 layout (a split factored leaf's
    # gradient gathered whole for its statistics) against the whole
    # optimizer on whole copies, through an update and a half
    fcfg = OptimizerConfig(optimizer="adafactor", lr=1e-3,
                           accumulation_steps=2, use_schedule=False)
    axes = [flax_axes(n, len(layout.shapes[n])) for n in names]
    whole_p = [layout.whole(n, p.detach()).clone()
               for n, p in state.params.items()]
    split_p = [p.detach().clone() for p in state.params.values()]
    ref = Optimizer(whole_p, fcfg, axes)
    split = ShardedOptimizer(split_p, fcfg, mesh, ZERO1_MIN, axes,
                             layout=layout, names=names)
    for _ in range(3):
        ref.update(whole)
        split.update(grads)
    out["adafactor_params_diff"] = bit_diff(
        [layout.whole(n, p) for n, p in zip(names, split_p)], whole_p)

    # Adam with a bf16 first moment on the same layout: its ZeRO-1 slices
    # gathered whole (as a checkpoint save gathers them; gloo takes no
    # bfloat16) against the whole optimizer's, bit for bit
    mcfg = OptimizerConfig(lr=1e-3, mu_dtype="bfloat16",
                           accumulation_steps=2, use_schedule=False)
    whole_p = [layout.whole(n, p.detach()).clone()
               for n, p in state.params.items()]
    split_p = [p.detach().clone() for p in state.params.values()]
    ref = Optimizer(whole_p, mcfg, axes)
    split = ShardedOptimizer(split_p, mcfg, mesh, ZERO1_MIN, axes,
                             layout=layout, names=names)
    for _ in range(3):
        ref.update(whole)
        split.update(grads)
    mu = dict(split.gathered(split.mu))
    out["bf16_mu_sliced"] = sum(a is not None for a in split.shard_axes)
    out["bf16_mu_dtypes"] = sorted({str(t.dtype) for t in mu.values()})
    out["bf16_mu_diff"] = bit_diff([mu[i] for i in range(len(names))],
                                   ref.mu)
    out["bf16_params_diff"] = bit_diff(
        [layout.whole(n, p) for n, p in zip(names, split_p)], whole_p)
    del grads, local, whole, ref, split, whole_p, split_p, mu

    # -- 4 micro-steps, an update every 2, and the optimizer's layout -----
    losses = []
    for _ in range(4):
        state, metrics = step(state, mine)
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["state_shapes"] = [(tuple(m.shape), tuple(a.shape))
                           for m, a in zip(opt.mu, opt.acc)]
    out["param_shapes"] = [tuple(p.shape) for p in state.params.values()]
    out["shard_axes"] = opt.shard_axes

    # -- checkpoint: TP -> one process -> TP, bit for bit -----------------
    CheckpointManager(os.path.join(d, "ckpt_tp"), mesh=mesh,
                      schedule={"model": 2}).save(state)
    mesh.barrier()
    if mesh.process_rank == 0:
        out.update(tp_one_process(inputs, cfg, d))
    mesh.barrier()
    fresh = build_pipeline(inputs)
    st2 = create_sharded_train_state(fresh.unet, cfg, mesh, zero1=True,
                                     zero1_min_size=ZERO1_MIN)
    st2 = CheckpointManager(os.path.join(d, "ckpt_one")).restore(st2)
    out["roundtrip_step"] = st2.step
    out["roundtrip_params_diff"] = bit_diff(
        [p.detach() for p in st2.params.values()],
        [p.detach() for p in state.params.values()])
    out["roundtrip_state_diff"] = bit_diff(state_lists(st2.opt),
                                           state_lists(opt))
    out["roundtrip_counters"] = (st2.opt.count, st2.opt.mini_step)
    del fresh, st2, state, step, opt, pipe

    # -- heads the model size does not divide: gathered q, k, v -----------
    pipe = build_pipeline(inputs, attention_heads=(1, 2))
    plain = None
    if mesh.process_rank == 0:
        ref = TrainState(step=0, params=dict(pipe.unet.named_parameters()))
        loss1, _, grads1 = make_train_step(pipe).loss_and_grads(
            ref, grad_batch)
        plain = (float(loss1), [g.clone() for g in grads1])
        del ref, grads1
    state = create_sharded_train_state(pipe.unet, cfg, mesh, zero1=True,
                                       zero1_min_size=ZERO1_MIN)
    step = make_sharded_train_step(pipe, mesh, zero1=True,
                                   zero1_min_size=ZERO1_MIN)
    loss, _, grads = step.loss_and_grads(state, mine)
    whole = [state.layout.whole(n, g) for n, g in zip(names, grads)]
    out["gathered_loss"] = float(loss)
    if mesh.process_rank == 0:
        out["gathered_grads"] = dict(zip(names, whole))
    if plain is not None:
        out["gathered_loss_1proc"] = plain[0]
        out["gathered_grad_rel"] = max(
            float((g - g1).abs().max()) / max(float(g1.abs().max()), 1e-12)
            for g, g1 in zip(whole, plain[1]))
    mesh.barrier()
    if mesh.process_rank == 0:
        for tag in ("tp", "one"):
            shutil.rmtree(os.path.join(d, f"ckpt_{tag}"))
    torch.save(out, os.path.join(d, f"tp_rank{mesh.process_rank}.pt"))
    mesh.barrier()
    shutdown()


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def tp_one_process(inputs, cfg, d: str) -> dict:
    """Process 0 alone: one process (no mesh) restores the TP checkpoint,
    bit-equal to its files, and saves it again for the ranks to restore."""
    files = [torch.load(os.path.join(d, "ckpt_tp", "latest", f),
                        weights_only=True)
             for f in ("params.pt", "opt_state.pt")]
    pipe = build_pipeline(inputs)
    mgr = CheckpointManager(os.path.join(d, "ckpt_tp"))
    state = mgr.restore(create_train_state(pipe.unet, cfg))
    params, opt = files
    res = {"one_process_step": state.step,
           "one_process_params_equal": all(
               torch.equal(p, params[n]) for n, p in state.params.items()),
           "one_process_state_equal": all(
               torch.equal(t, opt[key][n]) for key, tensors in (
                   ("mu", state.opt.mu), ("nu", state.opt.nu),
                   ("acc", state.opt.acc))
               for n, t in zip(state.params, tensors)),
           "saved_model": _json(os.path.join(d, "ckpt_tp", "latest",
                                             "state.json"))["model"]}
    CheckpointManager(os.path.join(d, "ckpt_one")).save(state)
    return res


if __name__ == "__main__":
    if sys.argv[2:] == ["tp"]:
        tp_main(sys.argv[1])
    else:
        main(sys.argv[1])
