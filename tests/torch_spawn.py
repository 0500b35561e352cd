"""Spawned ranks for the port's multi-rank tests: gloo groups on the CPU
(``tests/test_torch_ring.py``, ``tests/test_torch_train.py``,
``tests/test_torch_fsdp.py``, ``tests/test_torch_pipeline.py``) and
NCCL groups, one card per rank (``tests/test_torch_cuda.py``).

The children import torch and the port only, never JAX: the parent test
hands them numpy inputs in an .npz and reads rank 0's results back from
another. Each child runs one thread and joins a FileStore under the
test's tmp_path. ``run_ranks`` gives the group a time limit: past it,
every child is killed and the test fails, so no hang can stall the
suite.
"""

import itertools
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_runs = itertools.count()


def run_ranks(target, world, tmp_path, inputs, *args, timeout=150.0,
              backend="gloo"):
    """Run ``target(rank, world, inputs, *args)`` on ``world`` spawned
    ranks of one ``backend`` group (NCCL: rank r on card r); returns
    rank 0's result dict (numpy)."""
    name = f"{target.__name__}_{world}_{next(_runs)}"
    base = os.path.join(str(tmp_path), name)
    np.savez(base + "_in.npz", **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, base, backend, args),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"{name}: ranks {hung} still running after "
                             f"{timeout} s; killed")
    errors = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            path = f"{base}_err{r}.txt"
            errors.append(f"rank {r} exit {p.exitcode}:\n"
                          + (open(path).read() if os.path.exists(path)
                             else ""))
    if errors:
        raise AssertionError(f"{name}:\n" + "\n".join(errors))
    with np.load(base + "_out.npz") as f:
        return dict(f)


def _rank_main(target, rank, world, base, backend, args):
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
            torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            backend, store=dist.FileStore(base + ".store", world), rank=rank,
            world_size=world)
        with np.load(base + "_in.npz") as f:
            inputs = dict(f)
        res = target(rank, world, inputs, *args)
        if rank == 0:
            np.savez(base + "_out.npz", **res)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{base}_err{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise


def _device():
    """This rank's device: its card in an NCCL group, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _np(t):
    return t.detach().cpu().numpy()


def flatten(tree, prefix=""):
    """Nested dict of arrays/tensors -> {"a/b": numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (_np(v) if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def unflatten(flat, prefix, device="cpu"):
    """{"<prefix>a/b": numpy} -> nested dict of torch tensors."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.tensor(arr, device=device)
    return out


def ring_worker(rank, world, inp, cases):
    """Each case: ``ring_attention_sharded`` of the whole q, k, v on
    every rank, backward of sum(out * dout), q/k/v gradients summed over
    the group (each rank's cover the positions it owns)."""
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.parallel.ring_attention import ring_attention_sharded
    mesh = make_mesh({"sp": world})
    group = mesh.get_group("sp")
    dev = _device()
    out = {}
    for name, kw in cases:
        q, k, v = (torch.tensor(inp[f"{name}_{x}"], device=dev,
                                requires_grad=True) for x in "qkv")
        o = ring_attention_sharded(q, k, v, mesh=mesh, **kw)
        (o * torch.tensor(inp[f"{name}_do"], device=dev)).sum().backward()
        out[f"{name}_out"] = _np(o)
        for x, t in zip("qkv", (q, k, v)):
            dist.all_reduce(t.grad, group=group)
            out[f"{name}_d{x}"] = _np(t.grad)
    return out


def train_worker(rank, world, inp, cfg, mesh_sizes, lr, steps, wd):
    """forward under ``pctx.sp`` (logits gathered to rank 0), then
    ``steps`` SGD steps (``make_spmd_train_step``) and ``steps`` AdamW
    steps from the given state (``make_adamw_spmd_train_step``)."""
    from tpushare_torch.models import training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    tokens = torch.tensor(inp["tokens"], device=dev)
    inputs, _ = training.shard_batch(tokens, mesh)
    pctx = tt.ParallelCtx(sp=mesh.get_group("sp"))
    with torch.no_grad():
        logits, _ = tt.forward(unflatten(inp, "p/", dev), inputs, cfg,
                               pctx=pctx)
    parts = [torch.empty_like(logits) for _ in range(world)]
    dist.all_gather(parts, logits.contiguous())
    dp, sp = mesh["dp"].size(), mesh["sp"].size()
    rows = [torch.cat(parts[i * sp:(i + 1) * sp], dim=1) for i in range(dp)]
    out = {"logits": _np(torch.cat(rows, dim=0))}

    params = unflatten(inp, "p/", dev)
    step = training.make_spmd_train_step(cfg, mesh, lr=lr)
    for s in range(steps):
        params, loss = step(params, tokens)
        out[f"sgd_loss{s}"] = _np(loss)
    out.update(flatten(params, "sgd/"))

    params = unflatten(inp, "p/", dev)
    state = {"mu": unflatten(inp, "mu/", dev),
             "nu": unflatten(inp, "nu/", dev),
             "count": torch.tensor(inp["count"], dtype=torch.int32,
                                   device=dev)}
    astep = training.make_adamw_spmd_train_step(cfg, mesh, lr=lr,
                                                weight_decay=wd)
    for s in range(steps):
        params, state, loss = astep(params, state, tokens)
        out[f"adamw_loss{s}"] = _np(loss)
    out.update(flatten(params, "adamw/"))
    out.update(flatten(state["mu"], "adamw_mu/"))
    out["adamw_count"] = _np(state["count"])
    return out


def ulysses_worker(rank, world, inp, cases):
    """Each case: ``ulysses_attention_sharded`` of the whole q, k, v on
    every rank, backward of sum(out * dout), q/k/v gradients summed over
    the group."""
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.parallel.ulysses import ulysses_attention_sharded
    mesh = make_mesh({"sp": world})
    group = mesh.get_group("sp")
    dev = _device()
    out = {}
    for name, kw in cases:
        q, k, v = (torch.tensor(inp[f"{name}_{x}"], device=dev,
                                requires_grad=True) for x in "qkv")
        o = ulysses_attention_sharded(q, k, v, mesh=mesh, **kw)
        (o * torch.tensor(inp[f"{name}_do"], device=dev)).sum().backward()
        out[f"{name}_out"] = _np(o)
        for x, t in zip("qkv", (q, k, v)):
            dist.all_reduce(t.grad, group=group)
            out[f"{name}_d{x}"] = _np(t.grad)
    return out


def a2a_train_worker(rank, world, inp, cfg, mesh_sizes, lr, steps):
    """``steps`` SGD steps and ``steps`` AdamW steps (from the given
    state) of the dense LM over the mesh with Ulysses sequence
    parallelism (``sp_impl="a2a"``)."""
    from tpushare_torch.models import training
    from tpushare_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    tokens = torch.tensor(inp["tokens"], device=dev)
    params = unflatten(inp, "p/", dev)
    step = training.make_spmd_train_step(cfg, mesh, lr=lr, sp_impl="a2a")
    out = {}
    for s in range(steps):
        params, loss = step(params, tokens)
        out[f"sgd_loss{s}"] = _np(loss)
    out.update(flatten(params, "sgd/"))
    params = unflatten(inp, "p/", dev)
    astep = training.make_adamw_spmd_train_step(cfg, mesh, lr=lr,
                                                sp_impl="a2a")
    state = {"mu": unflatten(inp, "mu/", dev),
             "nu": unflatten(inp, "nu/", dev),
             "count": torch.tensor(inp["count"], dtype=torch.int32,
                                   device=dev)}
    for s in range(steps):
        params, state, loss = astep(params, state, tokens)
        out[f"adamw_loss{s}"] = _np(loss)
    out.update(flatten(params, "adamw/"))
    return out


def moe_train_worker(rank, world, inp, cfg, mesh_sizes, lr, steps):
    """``steps`` MoE SGD steps (``moe.make_spmd_train_step``) and
    ``steps`` AdamW steps from the given state
    (``moe.make_adamw_spmd_train_step``) over the mesh."""
    from tpushare_torch.models import moe
    from tpushare_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    tokens = torch.tensor(inp["tokens"], device=dev)
    params = unflatten(inp, "p/", dev)
    step = moe.make_spmd_train_step(cfg, mesh, lr=lr)
    out = {}
    for s in range(steps):
        params, loss = step(params, tokens)
        out[f"sgd_loss{s}"] = _np(loss)
    out.update(flatten(params, "sgd/"))
    params = unflatten(inp, "p/", dev)
    astep, opt_init = moe.make_adamw_spmd_train_step(cfg, mesh, lr=lr)
    zeros = opt_init(params)
    state = {"mu": unflatten(inp, "mu/", dev),
             "nu": unflatten(inp, "nu/", dev),
             "count": torch.tensor(inp["count"], dtype=torch.int32,
                                   device=dev)}
    out["opt_init_count"] = _np(zeros["count"])
    for s in range(steps):
        params, state, loss = astep(params, state, tokens)
        out[f"adamw_loss{s}"] = _np(loss)
    out.update(flatten(params, "adamw/"))
    return out


def _gather_stages(params, mesh, P, perm=None):
    """Whole layer stacks from every stage's block (rank 0's view), put
    back in model order when ``perm`` (interleaved storage) is given."""
    from tpushare_torch.parallel.mesh import axis_group
    group = axis_group(mesh, "pp")
    out = dict(params)
    out["layers"] = {}
    for k, a in params["layers"].items():
        if group is not None:
            parts = [torch.empty_like(a) for _ in range(P)]
            dist.all_gather(parts, a.contiguous(), group=group)
            a = torch.cat(parts)
        if perm is not None:
            a = a[torch.as_tensor(np.argsort(perm), device=a.device)]
        out["layers"][k] = a
    return out


def fsdp_worker(rank, world, inp, cfg, mesh_sizes, lr, steps, wd, ckpt):
    """``steps`` steps of each fsdp step (``make_fsdp_train_step``,
    ``make_fsdp_stream_train_step``, ``make_fsdp_stream_adamw_step``
    from the given AdamW state) over the mesh; their losses and the
    gathered, unsharded params (and AdamW moments). With ``ckpt`` (a
    path), the AdamW run's flat state is saved there (global leaves,
    written by rank 0) and restored through ``shardings=``: each rank's
    slices must come back equal."""
    from tpushare_torch.models import trainer, training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.mesh import axis_rank, axis_size, make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    F, idx = axis_size(mesh, "fsdp"), axis_rank(mesh, "fsdp")
    tokens = torch.tensor(inp["tokens"], device=dev)
    like = tt.init_params(0, cfg, device="meta")
    out = {}
    for name, factory, stream in (
            ("plain", training.make_fsdp_train_step, False),
            ("stream", training.make_fsdp_stream_train_step, True)):
        step, shard = factory(cfg, mesh, lr=lr)
        flat = shard(unflatten(inp, "p/", dev))
        for s in range(steps):
            flat, loss = step(flat, tokens)
            out[f"{name}_loss{s}"] = _np(loss)
        unshard = (training.fsdp_stream_unshard_params if stream
                   else training.fsdp_unshard_params)
        out.update(flatten(unshard(training.fsdp_gather_flat(
            flat, mesh, stream=stream), like), f"{name}/"))
    step, shard, opt_init = training.make_fsdp_stream_adamw_step(
        cfg, mesh, lr=lr, weight_decay=wd)
    flat = shard(unflatten(inp, "p/", dev))
    out["opt_init_count"] = _np(opt_init(flat)["count"])
    state = {"mu": shard(unflatten(inp, "mu/", dev)),
             "nu": shard(unflatten(inp, "nu/", dev)),
             "count": torch.tensor(inp["count"], dtype=torch.int32,
                                   device=dev)}
    for s in range(steps):
        flat, state, loss = step(flat, state, tokens)
        out[f"adamw_loss{s}"] = _np(loss)
    gathered = {"params": training.fsdp_gather_flat(flat, mesh, stream=True),
                "mu": training.fsdp_gather_flat(state["mu"], mesh,
                                                stream=True)}
    out.update(flatten(training.fsdp_stream_unshard_params(
        gathered["params"], like), "adamw/"))
    out.update(flatten(training.fsdp_stream_unshard_params(
        gathered["mu"], like), "adamw_mu/"))
    out["adamw_count"] = _np(state["count"])
    if ckpt:
        if rank == 0:
            trainer.save_state(ckpt, gathered["params"], {
                "mu": gathered["mu"], "nu": training.fsdp_gather_flat(
                    state["nu"], mesh, stream=True),
                "count": state["count"]}, steps)
        else:
            training.fsdp_gather_flat(state["nu"], mesh, stream=True)
        dist.barrier()
        sh = training.fsdp_shardings(like, F, idx, stream=True)
        back, opt, step_n = trainer.load_state(
            ckpt, like_params=flat, like_opt=state,
            shardings={"params": sh, "opt_state": {"mu": sh, "nu": sh}})
        out["restored_equal"] = np.asarray(step_n == steps and all(
            torch.equal(a, b) for a, b in zip(
                training.tree_leaves({"p": back, "o": opt}),
                training.tree_leaves({"p": flat, "o": state}))))
    return out


def fsdp_restore_worker(rank, world, inp, cfg, mesh_sizes, ckpt):
    """Restore a flat AdamW checkpoint (written at any fsdp size) at this
    mesh's fsdp size; the gathered, unsharded params and moments."""
    from tpushare_torch.models import trainer, training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.mesh import axis_rank, axis_size, make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    F, idx = axis_size(mesh, "fsdp"), axis_rank(mesh, "fsdp")
    like = tt.init_params(0, cfg, device="meta")
    local = training.fsdp_local(training.fsdp_stream_shard_params(
        training.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device=dev), like), F),
        F, idx, stream=True)
    zeros = training.tree_map(lambda t: t.float(), local)
    sh = training.fsdp_shardings(like, F, idx, stream=True)
    params, opt, step = trainer.load_state(
        ckpt, like_params=local,
        like_opt={"mu": zeros, "nu": zeros,
                  "count": torch.zeros((), dtype=torch.int32)},
        shardings={"params": sh, "opt_state": {"mu": sh, "nu": sh}})
    out = {"step": np.asarray(step), "count": _np(opt["count"])}
    for name, tree in (("p", params), ("mu", opt["mu"]), ("nu", opt["nu"])):
        out.update(flatten(training.fsdp_stream_unshard_params(
            training.fsdp_gather_flat(tree, mesh, stream=True), like),
            f"{name}/"))
    return out


def pp_worker(rank, world, inp, cfg, mesh_sizes, M, lr, wd, schedules,
              n_chunks=2):
    """One SGD step of each pipeline schedule, then one 1F1B AdamW step
    from the given state, over the mesh, each from the same params:
    losses and the whole updated params (stages gathered, model order)."""
    from tpushare_torch.models import pipeline as pl
    from tpushare_torch.parallel.mesh import axis_rank, axis_size, make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    P, s = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    tokens = torch.tensor(inp["tokens"], device=dev)
    out = {}
    for sched in schedules:
        full = unflatten(inp, "p/", dev)
        perm = None
        if sched == "interleaved":
            full = pl.to_interleaved_storage(full, P, n_chunks)
            perm = pl.interleaved_layer_order(cfg.n_layers, P, n_chunks)
        step = pl.make_pp_train_step(cfg, mesh, n_microbatches=M, lr=lr,
                                     schedule=sched, n_chunks=n_chunks)
        params, loss = step(pl.stage_params(full, P, s), tokens)
        out[f"{sched}_loss"] = _np(loss)
        out.update(flatten(_gather_stages(params, mesh, P, perm),
                           f"{sched}/"))
    if "mu/embed" not in inp:
        return out
    from tpushare_torch.models.training import tree_map
    stage = pl.stage_params(unflatten(inp, "p/", dev), P, s)
    state = {"mu": pl.stage_params(unflatten(inp, "mu/", dev), P, s),
             "nu": pl.stage_params(unflatten(inp, "nu/", dev), P, s),
             "count": torch.tensor(inp["count"], dtype=torch.int32,
                                   device=dev)}
    state["mu"] = tree_map(lambda t: t.clone(), state["mu"])
    state["nu"] = tree_map(lambda t: t.clone(), state["nu"])
    astep = pl.make_pp_adamw_train_step(cfg, mesh, n_microbatches=M, lr=lr,
                                        weight_decay=wd, schedule="1f1b")
    stage, state, loss = astep(stage, state, tokens)
    out["adamw_loss"] = _np(loss)
    out.update(flatten(_gather_stages(stage, mesh, P), "adamw/"))
    out.update(flatten(_gather_stages(state["mu"], mesh, P), "adamw_mu/"))
    out["adamw_count"] = _np(state["count"])
    return out


def moe_pp_worker(rank, world, inp, cases, mesh_sizes, M, lr, wd):
    """For each (name, cfg) case: one ``make_moe_pp_train_step`` SGD step
    and one AdamW step from the given state
    (``make_moe_pp_adamw_train_step``) of the MoE LM over the mesh, from
    the case's params (``<name>/p/...``); losses and the whole updated
    params."""
    from tpushare_torch.models import moe_pipeline as mp
    from tpushare_torch.models import pipeline as pl
    from tpushare_torch.models.training import tree_map
    from tpushare_torch.parallel.mesh import axis_rank, axis_size, make_mesh
    mesh = make_mesh(mesh_sizes)
    dev = _device()
    P, s = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    tokens = torch.tensor(inp["tokens"], device=dev)
    out = {}
    for name, cfg in cases:
        def stage(prefix):
            return tree_map(lambda t: t.clone(), pl.stage_params(
                unflatten(inp, f"{name}/{prefix}/", dev), P, s))
        step = mp.make_moe_pp_train_step(cfg, mesh, n_microbatches=M, lr=lr)
        params, loss = step(stage("p"), tokens)
        out[f"{name}/sgd_loss"] = _np(loss)
        out.update(flatten(_gather_stages(params, mesh, P), f"{name}/sgd/"))
        state = {"mu": stage("mu"), "nu": stage("nu"),
                 "count": torch.tensor(inp["count"], dtype=torch.int32,
                                       device=dev)}
        astep = mp.make_moe_pp_adamw_train_step(cfg, mesh, n_microbatches=M,
                                                lr=lr, weight_decay=wd)
        params, state, loss = astep(stage("p"), state, tokens)
        out[f"{name}/adamw_loss"] = _np(loss)
        out.update(flatten(_gather_stages(params, mesh, P),
                           f"{name}/adamw/"))
    return out
