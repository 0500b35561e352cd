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
    rank 0's result dict (numpy). ``backend=None`` starts no group: the
    target binds its own mesh (``ServingMesh.bind(rank, init_method)``,
    the serve CLI's way)."""
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
        if backend is not None:
            dist.init_process_group(
                backend, store=dist.FileStore(base + ".store", world),
                rank=rank, world_size=world)
        with np.load(base + "_in.npz") as f:
            inputs = dict(f)
        res = target(rank, world, inputs, *args)
        if rank == 0:
            np.savez(base + "_out.npz", **res)
        # A mesh generation after a reshard may have left this process
        # outside any group.
        if dist.is_initialized():
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


# -- sharded serving (tests/test_torch_sharded_serving.py) -------------------

def _json_out(obj):
    import json
    return np.array(json.dumps(obj))


def _drive(srv, long_prompt, vocab, ticks=8, chunk=8):
    """test_sharded_serving.py's ``_drive``: one decode stream and one
    chunk-admitted long prompt riding fused ticks; every emitted token
    in schedule order."""
    p0 = np.random.default_rng(1).integers(0, vocab, 6)
    s0 = srv.admit(p0)
    streams = {s0: [int(srv.last_token[s0, 0])]}
    a = srv.admit_start(long_prompt, chunk_tokens=chunk)
    admitted = []
    for _ in range(ticks):
        if a is not None:
            out = srv.step(prefill_work=a)
            if a in out:
                admitted.append(out.pop(a))
                a = None
        else:
            out = srv.step()
        for s, t in out.items():
            streams.setdefault(s, []).extend(t if isinstance(t, list)
                                             else [t])
    assert a is None, "admission never completed"
    return {str(k): v for k, v in streams.items()}, admitted


def _fused_vs_serial(mk, lp, vocab):
    """test_sharded_serving.py's fused-vs-serial schedule on one
    server: (admitted, streams)."""
    srv = mk()
    p0 = np.random.default_rng(1).integers(0, vocab, 6)
    out = {}
    for fused in (True, False):
        srv = mk()
        s0 = srv.admit(p0)
        streams = {s0: [int(srv.last_token[s0, 0])]}
        a = srv.admit_start(lp, chunk_tokens=8)
        admitted = []
        for _ in range(8):
            if a is not None and fused:
                o = srv.step(prefill_work=a)
                if a in o:
                    admitted.append(o.pop(a))
                    a = None
            else:
                if a is not None:
                    tok = srv.admit_step(a)
                    if tok is not None:
                        admitted.append(tok)
                        a = None
                o = srv.step()
            for s, t in o.items():
                streams.setdefault(s, []).append(t)
        out["fused" if fused else "serial"] = (
            admitted, {str(k): v for k, v in streams.items()})
    return out


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _gathered(obj):
    """Every rank's ``obj`` (gathered over the default group)."""
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, obj)
    return box


def sharded_serving_worker(rank, world, inp, sizes, families, extra):
    """The port's sharded slot servers on a ``sizes`` serving mesh: each
    family in ``families`` driven by ``_drive`` on every rank in
    lockstep (rank 0's streams, and whether every rank's equal rank
    0's), and the ``extra`` cases: "fused" (fused vs serial admission),
    "prefix" (prefix sharing on the mesh), "decoders" (the decoder
    factories' logits), "routings" (moe.forward under ep x tp per
    routing), "control" (rank 0 through ShardedServer, the others
    follow), "engine" (ServeEngine on the mesh over HTTP)."""
    import json
    from tpushare_torch.models import moe, quant, serving
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.models.paged import PagedSlotServer
    from tpushare_torch.parallel.mesh import serving_mesh
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dist.get_backend() == "nccl" else ["cpu"] * world)
    mesh = serving_mesh(sizes, devices=devices).bind()
    tcfg = tt.TransformerConfig(**json.loads(str(inp["tcfg"])),
                                dtype=torch.float32)
    mcfg = moe.MoEConfig(**json.loads(str(inp["mcfg"])),
                         dtype=torch.float32)
    tp_ = unflatten(inp, "tf/")
    mp_ = unflatten(inp, "moe/")
    mq = unflatten(inp, "moeq/")
    lp_t = _prompt(7, 21, tcfg.vocab_size)
    lp_m = _prompt(7, 21, mcfg.vocab_size)

    def fam(name, m):
        if name == "dense_tp":
            return serving.SlotServer(tp_, tcfg, n_slots=3, max_len=96,
                                      mesh=m, device="cpu")
        if name == "paged_tp":
            return PagedSlotServer(tp_, tcfg, n_slots=3, n_blocks=64,
                                   block_size=4, mesh=m, device="cpu")
        if name in ("paged_spec_tp", "paged_spec_horizon_tp"):
            return PagedSlotServer(
                tp_, tcfg, n_slots=3, n_blocks=96, block_size=4,
                speculative_draft=(tp_, tcfg), gamma=2,
                spec_horizon=2 if "horizon" in name else 1, mesh=m,
                device="cpu")
        if name == "paged_moe_eptp":
            return PagedSlotServer(mp_, mcfg, n_slots=3, n_blocks=64,
                                   block_size=4,
                                   forward_fn=moe.paged_forward, mesh=m,
                                   device="cpu")
        if name == "paged_moe_spec_eptp":
            return PagedSlotServer(
                mp_, mcfg, n_slots=3, n_blocks=96, block_size=4,
                forward_fn=moe.paged_forward,
                speculative_draft=(mq, mcfg), gamma=2,
                draft_layers_hook=quant.dequant_hook(mcfg), mesh=m,
                draft_param_specs=(quant.quant_moe_param_specs(mcfg)
                                   if m is not None else None),
                device="cpu")
        if name == "moe_rows_eptp":
            return moe.MoESlotServer(mp_, mcfg, n_slots=3, max_len=96,
                                     mesh=m, device="cpu")
        raise KeyError(name)

    res = {}
    with torch.inference_mode():
        for name in families:
            vocab = (mcfg if "moe" in name else tcfg).vocab_size
            got = _drive(fam(name, mesh), lp_m if "moe" in name else lp_t,
                         vocab)
            res[name] = got
            res[name + "/ranks_equal"] = all(g == got
                                             for g in _gathered(got))
        if "fused" in extra:
            res["fused"] = _fused_vs_serial(
                lambda: PagedSlotServer(tp_, tcfg, n_slots=3, n_blocks=64,
                                        block_size=4, mesh=mesh,
                                        device="cpu"),
                _prompt(9, 21, tcfg.vocab_size), tcfg.vocab_size)
        if "prefix" in extra:
            srv = PagedSlotServer(mp_, mcfg, n_slots=2, n_blocks=32,
                                  block_size=4, forward_fn=moe.paged_forward,
                                  prefix_cache=True, mesh=mesh, device="cpu")
            prompt = _prompt(13, 13, mcfg.vocab_size)
            a = srv.admit(prompt)
            first = int(srv.last_token[a, 0])
            srv.evict(a)
            b = srv.admit(prompt)
            res["prefix"] = [srv.last_cached_len, first,
                             int(srv.last_token[b, 0]), len(srv.cache.free),
                             srv.cache.live_blocks()]
    out = {"res": _json_out(res)}
    if "decoders" in extra:
        out.update(_decoder_logits(mesh, tcfg, tp_, mcfg, mp_, inp))
    if "routings" in extra:
        out.update(_routing_logits(mesh, mcfg, mp_, inp))
    if "control" in extra:
        out["control"] = _json_out(_control_case(mesh, tcfg, tp_, lp_t))
    if "engine" in extra:
        out["engine"] = _json_out(_engine_case(mesh, mcfg, mp_, inp))
    return out


def _decoder_logits(mesh, tcfg, tp_, mcfg, mp_, inp):
    """The decoder factories over ``mesh``: prefill then one ragged
    decode step into a sharded row cache, and one paged decode step."""
    from tpushare_torch.models import serving
    from tpushare_torch.models.transformer import param_specs
    from tpushare_torch.models.moe import param_specs as moe_specs
    from tpushare_torch.parallel.sharding import shard_tree
    out = {}
    toks = torch.tensor(inp["dec_tokens"])
    if mesh.sizes["ep"] == 1:
        pre, dec = serving.make_tp_decoder(tcfg, mesh)
        p = shard_tree(tp_, param_specs(tcfg), mesh)
        cache = serving.sharded_cache(tcfg, mesh, toks.shape[0], 32)
        lg, cache = pre(p, toks, cache)
        out["tp_prefill"] = _np(lg)
        lg, cache = dec(p, toks[:, :1], cache, toks.shape[1])
        out["tp_decode"] = _np(lg)
        pd = serving.make_tp_paged_decoder(tcfg, mesh, block_size=4)
        hkv = tcfg.n_kv_heads // mesh.sizes["tp"]
        pool = torch.tensor(inp["pool"])          # [L, nb, bs, Hkv, Dh]
        r = mesh.axis_rank("tp")
        pk = pool[:, :, :, r * hkv:(r + 1) * hkv].contiguous()
        pv = (pool[:, :, :, r * hkv:(r + 1) * hkv] * 0.5).contiguous()
        lg, _, _, lens = pd(p, toks[:, :1], pk, pv,
                            torch.tensor(inp["table"]),
                            torch.tensor(inp["lengths"]),
                            torch.ones(toks.shape[0], dtype=torch.bool))
        out["tp_paged"] = _np(lg)
        out["tp_paged_lengths"] = _np(lens)
    else:
        pre, dec = serving.make_moe_decoder(mcfg, mesh)
        p = shard_tree(mp_, moe_specs(mcfg), mesh)
        cache = serving.sharded_cache(mcfg, mesh, toks.shape[0], 32)
        lg, cache = pre(p, toks, cache)
        out["moe_prefill"] = _np(lg)
        lg, cache = dec(p, toks[:, :1], cache, toks.shape[1])
        out["moe_decode"] = _np(lg)
    return out


def _routing_logits(mesh, mcfg, mp_, inp):
    """moe.forward under ep x tp for each routing, on this rank's
    slices (int8 experts through fused_expert_hook for psum)."""
    import dataclasses
    from tpushare_torch.models import moe, quant
    from tpushare_torch.models.transformer import ParallelCtx
    from tpushare_torch.parallel.sharding import shard_tree
    toks = torch.tensor(inp["route_tokens"])
    pctx = ParallelCtx(tp=mesh.axis_group("tp"))
    ep = mesh.axis_group("ep")
    out = {}
    for name, kw in (("psum_dense", {"routing": "psum"}),
                     ("psum_capacity", {"routing": "psum",
                                        "capacity_factor": 1.25}),
                     ("a2a", {"routing": "a2a", "capacity_factor": 1.25}),
                     ("dropless", {"routing": "dropless"}),
                     ("expert_choice", {"routing": "expert_choice"})):
        cfg = dataclasses.replace(mcfg, **kw)
        p = shard_tree(mp_, moe.param_specs(cfg), mesh)
        with torch.no_grad():
            lg, _ = moe.forward(p, toks, cfg, pctx=pctx, ep_axis=ep)
        out[f"route/{name}"] = _np(lg)
    q = quant.quantize_params(mp_, mcfg)
    p = shard_tree(q, quant.quant_moe_param_specs(mcfg), mesh)
    with torch.no_grad():
        lg, _ = moe.forward(p, toks, mcfg, pctx=pctx, ep_axis=ep,
                            layers_hook=quant.fused_expert_hook(mcfg))
    out["route/psum_q8"] = _np(lg)
    return out


def _control_case(mesh, tcfg, tp_, lp):
    """Rank 0 drives ``_drive`` (and an admission the pool refuses)
    through a ShardedServer; the other ranks follow. Returns rank 0's
    streams, what it caught, and every rank's digest and call count."""
    from tpushare_torch.models.paged import PagedSlotServer, PoolExhausted
    from tpushare_torch.parallel.control import ShardedServer, follow
    import hashlib
    with torch.inference_mode():
        srv = PagedSlotServer(tp_, tcfg, n_slots=2, n_blocks=64,
                              block_size=4, mesh=mesh, device="cpu")
        if mesh.rank == 0:
            sh = ShardedServer(srv, mesh, heartbeat_s=0.2)
            got = _drive(sh, lp, tcfg.vocab_size)
            time.sleep(0.5)                    # a heartbeat or two
            caught = None
            try:
                sh.admit(_prompt(3, 5, tcfg.vocab_size))
            except PoolExhausted as e:
                caught = str(e)
            sh.stop()
            mine = {"streams": got, "caught": caught,
                    "digest": sh.digest.hexdigest(), "calls": None,
                    "broadcasts": sh.broadcasts}
        else:
            h = hashlib.sha256()
            n = follow(srv, mesh, digest=h)
            mine = {"digest": h.hexdigest(), "calls": n}
    return _gathered(mine)


def _engine_case(mesh, mcfg, mp_, inp):
    """ServeEngine on the mesh, the reference's TestShardedEngine
    schedule driven by ``_loop_once`` on rank 0, then one request over
    HTTP; the other ranks follow. Rank 0's tokens and /stats."""
    import json
    import urllib.request
    from tpushare_torch.cli import serve as serve_mod
    eng = serve_mod.ServeEngine(
        mp_, mcfg, model_family="moe", kv="paged", n_slots=4,
        n_blocks=128, block_size=4, idle_sleep_s=0.0, prefill_chunk=8,
        mesh=mesh, device="cpu")
    out_dir = str(inp["out_dir"])
    if mesh.rank > 0:
        n = eng.follow()
        return _gathered_files(out_dir, mesh, {
            "calls": n, "digests": eng._mesh_digests})
    prompts = [[5, 9, 12, 3], list(range(40, 70)), [9, 9, 2]]
    reqs = [serve_mod._Request(list(p), 5, None) for p in prompts]
    with eng._on_device():
        for r in reqs:
            assert eng.submit(r)
        for _ in range(400):
            if all(r.done.is_set() for r in reqs):
                break
            eng._loop_once()
    httpd = serve_mod.serve(eng, port=0)
    port = httpd.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": [7, 7, 3], "max_tokens": 5}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        http_tokens = json.loads(resp.read())["tokens"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=60) as resp:
        stats = json.loads(resp.read())
    chip = urllib.request.Request(
        f"http://127.0.0.1:{port}/mesh/chip",
        data=json.dumps({"device": 1, "healthy": False}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(chip, timeout=60) as resp:
            chip_status = (resp.status, json.loads(resp.read()))
    except urllib.error.HTTPError as e:
        chip_status = (e.code, json.loads(e.read())["error"])
    deadline = time.monotonic() + 60
    while eng.stats()["reshards"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    after = {k: eng.stats()[k] for k in (
        "reshards", "mesh_shape_current", "degraded", "healthy_devices")}
    httpd.shutdown()
    httpd.server_close()
    eng.stop()
    return _gathered_files(out_dir, mesh, {
        "tokens": [r.tokens for r in reqs],
        "errors": [r.error for r in reqs], "http_tokens": http_tokens,
        "stats": stats, "chip": chip_status, "after": after})


def _gathered_files(out_dir, mesh, obj, timeout=60.0):
    """Every rank's ``obj``, through files (a reshard leaves the ranks
    in different process groups): each rank writes its own, rank 0
    reads them all."""
    import json
    rank = mesh.process_id
    with open(os.path.join(out_dir, f"gathered_{rank}.json"), "w") as f:
        json.dump(obj, f)
    if rank != 0:
        return None
    deadline = time.monotonic() + timeout
    out = []
    for r in range(mesh.size):
        path = os.path.join(out_dir, f"gathered_{r}.json")
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.05)
        with open(path) as f:
            out.append(json.load(f))
    return out


# -- elastic sharded serving (ROADMAP A10b) -----------------------------

ELASTIC_PROMPTS = [[5, 9, 12, 3], list(range(40, 60)), [9, 9, 2]]


def free_ports(n):
    """``n`` free TCP ports of the host (each closed before use)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _elastic_drive(eng, prompts, max_tokens=6, shrink_at=None, dev=None,
                   host_kill=None, host_rejoin=False, limit=600,
                   sleep=0.0):
    """The reference's ``_drive`` for the elastic cases: ``prompts``
    through ``_loop_once`` on this thread, a chip event at tick
    ``shrink_at`` (card ``dev``) or a host loss (``host_kill`` = (tick,
    host)), and that host's rejoin once the engine resharded."""
    from tpushare_torch.cli import serve as serve_mod
    reqs = [serve_mod._Request(list(p), max_tokens, None) for p in prompts]
    for r in reqs:
        assert eng.submit(r)
    rejoined = False
    for i in range(limit):
        if all(r.done.is_set() for r in reqs):
            break
        if shrink_at is not None and i == shrink_at:
            eng.chip_event(dev, False)
        if host_kill is not None and i == host_kill[0]:
            eng.host_event(host_kill[1], False)
        if host_rejoin and not rejoined and eng.stats()["reshards"] >= 1:
            eng.host_event(host_kill[1], True)
            rejoined = True
        eng._loop_once()
        if sleep:
            time.sleep(sleep)
    return {"tokens": [list(r.tokens) for r in reqs],
            "errors": [r.error for r in reqs]}


_ELASTIC_KEYS = ("reshards", "grow_backs", "degraded", "replayed_on_reshard",
                 "mesh_shape_current", "mesh_shape_configured",
                 "num_devices", "num_devices_configured", "healthy_devices",
                 "reshard_ms", "grow_back_ms", "fetches_per_tick", "replays",
                 "quarantines", "host_losses", "host_rejoins",
                 "num_processes", "process_index", "healthy_processes",
                 "gang", "last_error", "chaos_fired", "mesh_generation")


def _idle_until_grown(eng, grows=1, limit_s=20.0):
    """Idle ticks until the engine grew back ``grows`` times (a process
    standing by marks itself ready on its own clock)."""
    deadline = time.monotonic() + limit_s
    while eng.stats()["grow_backs"] < grows and \
            time.monotonic() < deadline:
        eng._loop_once()
        time.sleep(0.005)


def _estats(eng):
    st = eng.stats()
    return {k: st.get(k) for k in _ELASTIC_KEYS}


def _elastic_case(name, eng, ctx):
    """Rank 0's side of one elastic case; its record."""
    from tpushare_torch.cli import serve as serve_mod
    dev = ctx["dev"]
    P = ELASTIC_PROMPTS
    out = {}
    if name in ("shrink", "host_grow"):
        if name == "shrink":
            out["run"] = _elastic_drive(eng, P, shrink_at=4, dev=dev)
        else:
            out["run"] = _elastic_drive(eng, P, host_kill=(4, 1),
                                        host_rejoin=True)
        out["shrunk"] = _estats(eng)
        if name == "shrink":
            eng.chip_event(dev, True)
        _idle_until_grown(eng)
        out["grown"] = _estats(eng)
        out["again"] = _elastic_drive(eng, [[7, 7, 3]])
    elif name == "grow_fail":
        out["run"] = _elastic_drive(eng, P, shrink_at=4, dev=dev)
        real = eng._build_server
        state = {"left": 1}

        def failing_build(*a, **kw):
            if state["left"] > 0:
                state["left"] -= 1
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory placing the tp=2 slices")
            return real(*a, **kw)
        eng._build_server = failing_build
        eng.chip_event(dev, True)
        deadline = time.monotonic() + 20.0
        while state["left"] and time.monotonic() < deadline:
            eng._loop_once()
            time.sleep(0.005)
        out["failed_grow"] = _estats(eng)
        out["failed_grow"]["draining"] = eng._draining.is_set()
        out["served"] = _elastic_drive(eng, [[5, 9, 12, 3]])
        out["still"] = _estats(eng)
        _idle_until_grown(eng)
        out["grown"] = _estats(eng)
        out["again"] = _elastic_drive(eng, [[7, 7, 3]])
    elif name == "spec_h2":
        out["run"] = _elastic_drive(eng, P, shrink_at=2, dev=dev,
                                    max_tokens=16)
        out["shrunk"] = _estats(eng)
    elif name == "undrain":
        out["run"] = _elastic_drive(eng, [[5, 9, 12, 3]], shrink_at=2,
                                    dev=dev)
        out["shrunk"] = _estats(eng)
        eng.begin_drain()
        out["end_drain"] = eng.end_drain()
        _idle_until_grown(eng)
        out["grown"] = _estats(eng)
    elif name == "checkpoint":
        out["run"] = _elastic_drive(eng, [[5, 9, 12, 3], [9, 9, 2]],
                                    shrink_at=3, dev=dev)
        out["shrunk"] = _estats(eng)
    elif name in ("budget0", "host_budget0"):
        if name == "budget0":
            eng.chip_event(dev, False)
        else:
            eng.host_event(1, False)
        eng._loop_once()
        out["st"] = _estats(eng)
        out["sticky"] = [eng._draining.is_set(), eng._drain_sticky]
        late = serve_mod._Request([5, 9], 2, None)
        out["late_submit"] = eng.submit(late)
        out["late_error"] = (late.done.wait(2)
                             and late.error is not None)
        out["end_drain"] = eng.end_drain()
    elif name == "total_loss":
        req = serve_mod._Request([5, 9, 12], 30, None)
        assert eng.submit(req)
        for _ in range(3):
            eng._loop_once()
        eng.chip_event(0, False)
        eng.chip_event(1, False)
        eng._loop_once()
        out["failed"] = req.done.is_set() and req.error is not None
        out["st"] = _estats(eng)
        out["sticky"] = [eng._draining.is_set(), eng._drain_sticky]
    elif name == "idempotent":
        eng.chip_event(1, False)
        eng._loop_once()
        out["first"] = _estats(eng)["reshards"]
        for _ in range(3):
            eng.chip_event(1, False)
            eng._loop_once()
        out["st"] = _estats(eng)
        out["draining"] = eng._draining.is_set()
    elif name == "flap":
        eng.chip_event(1, False)
        eng.chip_event(1, True)
        for _ in range(3):
            eng._loop_once()
        out["st"] = _estats(eng)
        out["fault"] = eng._mesh_fault
    elif name == "admit_death":
        from tpushare_torch.chaos import InjectedXlaRuntimeError
        real = eng.srv.admit
        state = {"left": 1}

        def dying_admit(*a, **kw):
            if state["left"] > 0:
                state["left"] -= 1
                raise InjectedXlaRuntimeError(
                    "INTERNAL: card lost mid-prefill")
            return real(*a, **kw)
        eng.srv.admit = dying_admit
        out["run"] = _elastic_drive(eng, [[5, 9, 12, 3]], max_tokens=4)
        out["st"] = _estats(eng)
    elif name == "non_serving":
        eng.chip_event(3, False)
        eng._loop_once()                # degraded to positions [0, 1]
        eng.chip_event(2, False)        # an idle card dies
        for _ in range(3):
            eng._loop_once()
        out["after_idle_death"] = _estats(eng)
        eng.chip_event(3, True)         # card 2 is still dead
        for _ in range(20):
            eng._loop_once()
            time.sleep(0.005)
        out["partial_recovery_grow_backs"] = _estats(eng)["grow_backs"]
        eng.chip_event(2, True)
        _idle_until_grown(eng)
        out["full"] = _estats(eng)
    elif name == "host_repeat":
        eng.host_event(1, False)
        eng.host_event(1, False)
        out["losses"] = _estats(eng)["host_losses"]
        eng.host_event(1, True)
        eng.host_event(1, True)
        out["rejoins"] = _estats(eng)["host_rejoins"]
    elif name == "host_undrain":
        out["run"] = _elastic_drive(eng, P, host_kill=(2, 1))
        eng.begin_drain()
        out["end_drain"] = eng.end_drain()
        out["st"] = _estats(eng)
    elif name in ("host_chaos", "chaos_no_process"):
        out["run"] = _elastic_drive(eng, P)
        out["st"] = _estats(eng)
    elif name == "process_stats":
        out["st"] = _estats(eng)
    elif name == "gang":
        leader = ctx["gang"]
        deadline = time.monotonic() + 10.0
        while leader.seen_ranks() != [1] and time.monotonic() < deadline:
            time.sleep(0.02)
        out["seen"] = leader.seen_ranks()
        reqs = [serve_mod._Request(list(p), 8, None) for p in P]
        for r in reqs:
            assert eng.submit(r)
        for i in range(4000):
            if i == 4:
                leader.sever(1)
            st = eng.stats()
            if all(r.done.is_set() for r in reqs) and \
                    st["host_rejoins"] >= 1:
                break
            eng._loop_once()
            time.sleep(0.005)
        out["run"] = {"tokens": [list(r.tokens) for r in reqs],
                      "errors": [r.error for r in reqs]}
        _idle_until_grown(eng)
        out["st"] = _estats(eng)
    elif name == "host_route":
        httpd = serve_mod.serve(eng, host="127.0.0.1", port=0,
                                timeout_s=10.0)
        port = httpd.server_address[1]
        codes = []
        for body in ({"rank": 1, "healthy": False},
                     {"rank": 1, "healthy": True}, {"healthy": False},
                     {"rank": "x", "healthy": False},
                     {"rank": True, "healthy": False},
                     {"rank": 1, "healthy": "down"},
                     {"rank": 9, "healthy": False}):
            codes.append(_post_json(port, "/mesh/host", body))
        httpd.shutdown()
        httpd.server_close()
        out["codes"] = codes
    else:
        raise KeyError(name)
    return out


def _post_json(port, path, body):
    import json
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return [r.status, json.loads(r.read())]
    except urllib.error.HTTPError as e:
        return [e.code, json.loads(e.read())]


def _case_ports(rank, out_dir, i):
    """Case ``i``'s two ports (the rendezvous, the liaison): rank 0 takes
    free ones just before binding them and hands them to the others
    through a file."""
    import json
    path = os.path.join(out_dir, f"port_{i}.json")
    if rank == 0:
        ports = free_ports(2)
        with open(path + ".tmp", "w") as f:
            json.dump(ports, f)
        os.replace(path + ".tmp", path)
        return ports
    deadline = time.monotonic() + 60
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no port for case {i}")
        time.sleep(0.01)
    with open(path) as f:
        return json.load(f)


def elastic_worker(rank, world, inp, cases):
    """The port's elastic engine (chip and host events, reshard, replay,
    grow-back) on a ``world``-rank mesh (2: tp=2 over the dense tiny
    model; 4: ep=2 x tp=2 over the MoE tiny model), one fresh mesh per
    case in ``cases`` ((name, engine options) pairs), each bound on a
    port of its own (``_case_port``) as the serve CLI binds
    (``--dist-init``).
    Rank 0 drives each case (``_elastic_case``); the other ranks follow
    through every generation. Returns rank 0's records."""
    import json
    from tpushare_torch.cli import serve as serve_mod
    from tpushare_torch.models import moe
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.gang import GangFollower, GangLeader
    from tpushare_torch.parallel.mesh import serving_mesh
    if world == 2:
        cfg = tt.TransformerConfig(**json.loads(str(inp["tcfg"])),
                                   dtype=torch.float32)
        params, sizes, family = unflatten(inp, "tf/"), {"tp": 2}, "dense"
    else:
        cfg = moe.MoEConfig(**json.loads(str(inp["mcfg"])),
                            dtype=torch.float32)
        params = unflatten(inp, "moe/")
        sizes, family = {"tp": 2, "ep": 2}, "moe"
    records = {}
    out_dir = str(inp["out_dir"])
    for i, (name, opts) in enumerate(cases):
        if dist.is_initialized():
            dist.destroy_process_group()
        opts = dict(opts)
        port, gang_port = _case_ports(rank, out_dir, i)
        if not opts.pop("gang", False):
            gang_port = None
        mesh = serving_mesh(sizes, devices=["cpu"] * world).bind(
            rank=rank, init_method=f"tcp://127.0.0.1:{port}", timeout_s=60)
        kw = dict(n_slots=4, n_blocks=128, block_size=4, idle_sleep_s=0.0,
                  max_reshards=5, mesh=mesh, device="cpu")
        if family == "moe":
            kw.update(model_family="moe", kv="paged")
        if opts.pop("speculative", False):
            kw.update(speculative_draft=(params, cfg), gamma=2,
                      spec_horizon=2, n_slots=3)
        if opts.get("reshard_checkpoint"):
            opts["reshard_checkpoint"] = os.path.join(
                out_dir, opts["reshard_checkpoint"])
        kw.update(opts)
        gang = follower = None
        if gang_port is not None:
            if rank == 0:
                gang = GangLeader(2, port=gang_port,
                                  heartbeat_timeout_s=0.25)
                kw["gang"] = gang
            else:
                follower = GangFollower(f"127.0.0.1:{gang_port}", 1,
                                        interval_s=0.03,
                                        fetches_fn=lambda: 7)
        with torch.inference_mode():
            eng = serve_mod.ServeEngine(params, cfg, **kw)
        if rank > 0:
            eng.follow()
            if follower is not None:
                follower.stop()
            continue
        ctx = {"dev": 1 if world == 2 else 3, "gang": gang}
        with eng._on_device():
            records[name] = _elastic_case(name, eng, ctx)
        eng.stop()
        if gang is not None:
            gang.close()
    return {"res": _json_out(records)} if rank == 0 else {}
