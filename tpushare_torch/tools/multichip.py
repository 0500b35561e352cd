"""BASELINE.md's mixed bin-pack row on the port: a Llama-3-8B serving pod
granted two cards' worth, and two small pods bin-packed beside it. The
counterpart of ``demo/e2e_multichip.py``. Run from the repository root:

    python -m tpushare_torch.tools.multichip                 # on the card(s)
    python -m tpushare_torch.tools.multichip --device cpu --tiny

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Prints one JSON line per part, then the record;
exits 1 when a gate fails.

- A. Placement, hardware-free as the reference's: a fake host of four
  16 GiB cards, the port's device plugin serving it to a kubelet
  simulator, an apiserver stub and the extender's bind verb
  (``tools/binpack.py``'s pieces). "serving" asks for 32 units (two
  cards' worth), "small-a" and "small-b" for 8 each. Gates: every bind
  succeeds, the serving pod's grant names two cards,
  ``GetPreferredAllocation`` spans exactly two cards, its ``Allocate``
  env names them as ``gpu_env_for_cards`` writes them, and both small
  pods share one card.
- B. The serving tenant: ``tpushare-torch-serve --mesh tp=2`` (Llama-3-
  8B at full width and depth from seed 0; ``--tiny``: the tiny config on
  the CPU) as two rank processes, their env the node's grant for the
  serving pod (``gpu_env_for_cards``). Rank 0 serves HTTP; rank 1
  follows. With fewer cards than ranks the ranks share card 0 and their
  collectives run over gloo through the host (printed): such times are
  not tensor-parallel measurements. Eight prompts of 16..2048 tokens
  (``--tiny``: 4..40) go over HTTP with chunked admission; then both
  ranks drive a direct sharded ``PagedSlotServer`` over the engine's
  slices: the prompts admitted whole, decode ticks timed, and a second
  server's greedy speculative rounds (the model drafting for itself).
  The one-card twin (the same weights on one device, a direct server,
  run in this process before the ranks start) is the oracle: every
  stream equal to the twin's or parting at a counted flip (the twin's
  top-two logit gap there within ``LOGIT_REL_TOL`` of its largest
  |logit|), the direct admissions' logits within ``LOGIT_REL_TOL`` of
  the twin's largest |logit|, every rank's streams and call digest
  equal to rank 0's, one fetch per tick on every rank.
- C. Expert parallelism: Mixtral-8x7B's width (int8 experts through
  ``quant.fused_expert_hook``), ``MOE_LAYERS`` of its 32 layers
  (``--tiny``: ``moe.tiny``), over ep=2 on the same two rank processes:
  the psum and a2a routings on a direct sharded paged server, each held
  to its one-card twin by B's gates at ``MOE_LOGIT_REL_TOL``.
- D. The small tenants: one process each, its env the node's grant for
  an 8-unit pod (on a node of more cards, on the card after the serving
  pod's), one BERT-base forward of 8 x 128 tokens (``--tiny``: 2 x 16):
  finite pooled output.

Each rank reports the kernel launches of each part (counts zeroed just
before it, read just after), its peak device memory and ms per tick.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List

import numpy as np
import torch

RESULT_TAG = "MULTICHIP_RESULT "
FAKE_CARDS, FAKE_CARD_GIB = 4, 16    # the reference's four-chip host
SERVING_UNITS, SMALL_UNITS = 32, 8   # BASELINE row 5's requests, GiB
RANKS = 2
#: max |sharded - one-card| logits over the twin's largest |logit|:
#: chip_smoke.py's gates for bf16 Llama (the tp sums split each
#: row-parallel product's f32 sum in two) and for Mixtral's int8
#: experts.
LOGIT_REL_TOL = 2e-2
MOE_LOGIT_REL_TOL = 3e-2
#: Mixtral-8x7B's published config (HF ``config.json`` of
#: mistralai/Mixtral-8x7B-v0.1), cut to ``MOE_LAYERS`` of its 32 layers
#: so a one-card twin and two ranks share one card in time.
MIXTRAL_8X7B = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    intermediate_size=14336, num_local_experts=8, num_experts_per_tok=2,
    rope_theta=1e6, rms_norm_eps=1e-5, hidden_act="silu",
    tie_word_embeddings=False, router_aux_loss_coef=0.02)
MOE_LAYERS = 4
INIT_TIMEOUT_S = 600.0

# (name, module, function, counter attribute) of every kernel wrapper.
COUNTERS = (
    ("flash_attention", "flash_attention", "flash_attention", "launches"),
    ("paged_flash_decode", "flash_attention", "paged_flash_decode",
     "launches"),
    ("paged_flash_decode_int8", "flash_attention", "paged_flash_decode",
     "launches_int8"),
    ("paged_flash_verify", "flash_attention", "paged_flash_verify",
     "launches"),
    ("paged_flash_verify_int8", "flash_attention", "paged_flash_verify",
     "launches_int8"),
    ("q8_expert_ffn", "q8_expert", "q8_expert_ffn", "launches"),
    ("flash_decode", "flash_attention", "flash_decode", "launches"),
    ("flash_attention_partial", "flash_attention",
     "flash_attention_partial", "launches"),
    ("flash_attention_bwd", "flash_attention", "flash_attention_bwd",
     "launches"))


def _counter_fns():
    import importlib
    return [(name, importlib.import_module(f"tpushare_torch.ops.{mod}"),
             fn, attr) for name, mod, fn, attr in COUNTERS]


def zero_launches() -> None:
    for _, mod, fn, attr in _counter_fns():
        setattr(getattr(mod, fn), attr, 0)


def read_launches() -> Dict[str, int]:
    return {name: int(getattr(getattr(mod, fn), attr, 0))
            for name, mod, fn, attr in _counter_fns()}


# -- the workload -------------------------------------------------------------

def llama_workload(tiny: bool):
    """(engine argv, config, prompts, tokens per request, decode ticks,
    speculative rounds, draft length gamma)."""
    from tpushare_torch.models import transformer as tt
    if tiny:
        cfg, lens = tt.tiny(), [4, 9, 17, 40]
        argv = ["--preset", "tiny", "--n-slots", "4", "--n-blocks", "128",
                "--block-size", "4", "--prefill-chunk", "8",
                "--prefill-chunk-force"]
        return argv, cfg, _prompts(cfg, lens, 1), 6, 4, 2, 2
    cfg = tt.llama3_8b()
    lens = [16, 100, 255, 511, 700, 1100, 1500, 2048]
    # 4 slots for 8 requests: a fused tick carries every slot's row at
    # the chunk's width, and over the one-card gloo stand-in each row's
    # bytes cross 64 host-staged all-reduces.
    argv = ["--preset", "llama3_8b", "--n-slots", "4", "--n-blocks",
            str(8 * 160 + 1), "--block-size", "16", "--prefill-chunk",
            "512"]
    return argv, cfg, _prompts(cfg, lens, 1), 16, 8, 2, 4


def _prompts(cfg, lens, seed) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


def moe_workload(tiny: bool):
    """(config, prompts, decode ticks, paged geometry (n_blocks, bs))."""
    from tpushare_torch.models import convert, moe
    if tiny:
        cfg = moe.tiny(remat=False)
        return cfg, _prompts(cfg, [5, 11, 23], 2), 4, (64, 4)
    cfg = dataclasses.replace(convert.moe_config_from_hf(
        argparse.Namespace(**MIXTRAL_8X7B)), n_layers=MOE_LAYERS,
        remat=False)
    return cfg, _prompts(cfg, [64, 300, 700, 1000], 2), 8, (4 * 128 + 1, 16)


def moe_weights(cfg, seed, device):
    """Random int8 MoE weights from ``seed`` (an int, or a
    ``torch.Generator`` on ``device``), made one layer (one
    expert) at a time and quantized as they are made, so no wide expert
    tree ever exists (``quant.quantize_weight`` of bf16 values, as
    ``quantize_params`` does): attention and experts int8 + f32 scales;
    router, norms, embed and unembed in ``cfg.dtype``."""
    from tpushare_torch.models import quant
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device=device).manual_seed(seed))
    L, Dm, Fd, E, V = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts,
                       cfg.vocab_size)

    def dense(shape, fan_in):
        return (torch.randn(*shape, generator=gen, device=device)
                / math.sqrt(fan_in)).to(cfg.dtype)

    shapes = {"wq": (Dm, cfg.q_dim), "wk": (Dm, cfg.kv_dim),
              "wv": (Dm, cfg.kv_dim), "wo": (cfg.q_dim, Dm),
              "w_gate": (E, Dm, Fd), "w_up": (E, Dm, Fd),
              "w_down": (E, Fd, Dm)}
    layers = {}
    for k, shp in shapes.items():
        layers[k + "#q8"] = torch.empty((L, *shp), dtype=torch.int8,
                                        device=device)
        layers[k + "#scale"] = torch.empty((L, *shp[:-2], 1, shp[-1]),
                                           device=device)
    for li in range(L):
        for k, shp in shapes.items():
            for e in range(E if len(shp) == 3 else 1):
                idx = (li, e) if len(shp) == 3 else (li,)
                q, s = quant.quantize_weight(dense(shp[-2:], shp[-2]))
                layers[k + "#q8"][idx] = q
                layers[k + "#scale"][idx] = s
    layers.update(ln1=torch.ones((L, Dm), dtype=cfg.dtype, device=device),
                  ln2=torch.ones((L, Dm), dtype=cfg.dtype, device=device),
                  router=dense((L, Dm, E), Dm))
    out = {"embed": dense((V, Dm), Dm), "layers": layers,
           "final_norm": torch.ones((Dm,), dtype=cfg.dtype, device=device)}
    if not cfg.tie_embeddings:
        out["unembed"] = dense((Dm, V), Dm)
    return out


def a2a_capacity(cfg) -> float:
    """The a2a routing's capacity factor, E / top_k: a queue holds every
    token of its share, so no assignment drops and the one-card twin
    (whose queues hold every token) computes the same function."""
    return cfg.n_experts / cfg.top_k


def moe_routings(cfg):
    """(name, config) of each routing part C serves."""
    return [("psum", dataclasses.replace(cfg, routing="psum",
                                         capacity_factor=None)),
            ("a2a", dataclasses.replace(cfg, routing="a2a",
                                        capacity_factor=a2a_capacity(cfg)))]


class RecordingSampler:
    """A server's sampler that keeps the logits of every pick made
    while ``record`` is set."""

    def __init__(self, inner):
        self.inner, self.record, self.seen = inner, False, []

    def pick(self, logits):
        if self.record:
            self.seen.append(logits.detach().float().clone())
        return self.inner.pick(logits)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def direct_run(srv, prompts, ticks, *, record=True) -> dict:
    """Admit every prompt whole, then ``ticks`` decode ticks (or
    speculative rounds): each stream's tokens, the admissions' logits
    rows and, per stream position, the row it was picked from (with
    ``record``), ms per tick, and the server's fetches."""
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    rec.record = record
    streams, rows, slot_of, admit_rows = {}, {}, {}, []
    for i, p in enumerate(prompts):
        slot = srv.admit(p)
        slot_of[slot] = i
        streams[i] = [int(srv.last_token[slot, 0])]
        if record:
            admit_rows.append(rec.seen[-1][0])
            rows[i] = [rec.seen[-1][0]]
    del rec.seen[:]
    dev = srv.device
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(ticks):
        n0 = len(rec.seen)
        out = srv.step()
        for s, tok in out.items():
            toks = tok if isinstance(tok, list) else [tok]
            streams[slot_of[s]].extend(int(t) for t in toks)
            if record and not srv.speculative:
                rows[slot_of[s]].append(rec.seen[n0][s])
        del rec.seen[:]
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(1, ticks)
    for s in list(slot_of):
        srv.evict(s)
    srv._sampler = rec.inner
    return {"streams": [streams[i] for i in range(len(prompts))],
            "rows": [rows.get(i, []) for i in range(len(prompts))],
            "admit_rows": admit_rows, "ms_per_tick": ms,
            "fetches": srv.device_fetches}


def flip_check(got, want, rows, tol):
    """Where ``got`` parts from ``want``, the twin's top-two logit gap
    at that position must be within ``tol`` of its largest |logit| (a
    counted flip; the rest of the stream is not compared). Returns the
    flip (position, gap share) or None; raises on an uncovered part."""
    for pos, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        if pos >= len(rows):
            raise AssertionError(f"stream parts at {pos} ({a} vs {b}) "
                                 f"past the twin's recorded rows")
        row = rows[pos]
        top2 = row.topk(2).values
        share = float((top2[0] - top2[1]) / row.abs().max())
        if share > tol:
            raise AssertionError(f"stream parts at {pos} ({a} vs {b}) with "
                                 f"a top-two gap of {share:.4f} of the "
                                 f"largest |logit| (gate {tol})")
        return [pos, share]
    return None


def logit_distance(got, want) -> float:
    """max |got - want| over the twin's largest |logit|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


# -- A: placement on a fake four-card host -------------------------------------

def place(tmp: str) -> dict:
    """Part A: returns its record (``failures`` listed in it)."""
    from tpushare_torch.deviceplugin import pb
    from tpushare_torch.extender.server import ExtenderService
    from tpushare_torch.k8s.client import KubeClient, load_config
    from tpushare_torch.plugin import const
    from tpushare_torch.plugin.allocate import Allocator
    from tpushare_torch.plugin.backend import FakeBackend
    from tpushare_torch.plugin.devices import expand_devices
    from tpushare_torch.plugin.podmanager import PodManager
    from tpushare_torch.plugin.server import TpuDevicePlugin
    from tpushare_torch.plugin.topology import gpu_env_for_cards
    from tpushare_torch.tools.binpack import (NAMESPACE, NODE, Apiserver,
                                              KubeletSim, write_kubeconfig)

    failures: List[str] = []
    dpp = os.path.join(tmp, "dpp")
    os.makedirs(dpp)
    api = Apiserver()
    kube = KubeClient(load_config(write_kubeconfig(
        os.path.join(tmp, "kubeconfig"), api.server_address[1])))
    topo = FakeBackend(chips=FAKE_CARDS, hbm_gib=FAKE_CARD_GIB,
                       generation="h100").probe()
    devmap = expand_devices(topo)
    kubelet = KubeletSim(dpp, api)
    plugin = TpuDevicePlugin(
        devmap, topo, Allocator(devmap, topo,
                                PodManager(kube, NODE, sleep=lambda s: None),
                                kube), device_plugin_path=dpp)
    pods = (("serving", SERVING_UNITS), ("small-a", SMALL_UNITS),
            ("small-b", SMALL_UNITS))
    try:
        plugin.serve()
        devices = kubelet.watch()
        with api.lock:           # the daemon publishes the card count
            for key in ("capacity", "allocatable"):
                api.nodes[NODE]["status"][key][const.RESOURCE_COUNT] = \
                    FAKE_CARDS
        for name, units in pods:
            api.add_pod(name, name, units)
        ext = ExtenderService(kube)
        binds = {n: ext.bind({"PodName": n, "PodNamespace": NAMESPACE,
                              "Node": NODE})["Error"] for n, _ in pods}
        with api.lock:
            idx = {n: api.pod(NAMESPACE, n)["metadata"]["annotations"].get(
                const.ANN_RESOURCE_INDEX) for n, _ in pods}
        pref = kubelet.stub.GetPreferredAllocation(
            pb.PreferredAllocationRequest(container_requests=[
                pb.ContainerPreferredAllocationRequest(
                    available_deviceIDs=devices,
                    allocation_size=SERVING_UNITS)]))
        pref_ids = list(pref.container_responses[0].deviceIDs)
        pref_cards = sorted({i.rsplit("-_-", 1)[0] for i in pref_ids})
        envs = {}
        for name, units in pods:
            ids = pref_ids if name == "serving" else devices[:units]
            resp, _ = kubelet.allocate(ids)
            envs[name] = dict(resp.envs)
    finally:
        plugin.stop()
        kubelet.close()
        api.close()
    key = const.ENV_NVIDIA_VISIBLE_DEVICES
    serving_cards = sorted(int(c) for c in str(idx["serving"]).split(",")
                           if c.strip().isdigit())
    want_env = gpu_env_for_cards(topo, serving_cards) if serving_cards \
        else {}
    if any(binds.values()):
        failures.append(f"bind errors {binds}")
    if len(serving_cards) != 2:
        failures.append(f"serving pod's grant names cards {idx['serving']}"
                        f", want two")
    if len(pref_ids) != SERVING_UNITS or len(pref_cards) != 2:
        failures.append(f"preferred allocation: {len(pref_ids)} units on "
                        f"cards {pref_cards}, want {SERVING_UNITS} on two")
    if envs["serving"].get(key) != want_env.get(key):
        failures.append(f"serving env {key}={envs['serving'].get(key)!r}"
                        f", gpu_env_for_cards wrote {want_env.get(key)!r}")
    small = [envs[n].get(key) for n in ("small-a", "small-b")]
    if len(set(small)) != 1 or "," in str(small[0]):
        failures.append(f"small pods on cards {small}, want one shared "
                        f"card")
    return {"advertised_devices": len(devices), "binds": binds,
            "grants": idx, "preferred_cards": pref_cards,
            "envs": {n: {k: v for k, v in e.items()
                         if k in (key, const.ENV_HBM_LIMIT_BYTES)}
                     for n, e in envs.items()},
            "failures": failures}


# -- B / C: a rank process ------------------------------------------------------

def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _memory(dev) -> dict:
    if dev.type != "cuda":
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "max_memory_reserved": torch.cuda.max_memory_reserved(dev)}


def _save(rows, path: str) -> None:
    torch.save([r.cpu() for r in rows], path)


def rank_main(args) -> None:
    """One rank of the serving tenant (parts B and C). Rank 0 serves
    the engine on 127.0.0.1:0, prints ``READY <port>`` and stops it at
    a ``STOP`` line on stdin; the other ranks follow. Then every rank
    drives the direct sharded servers in lockstep. Writes its record
    (and rank 0 its logits rows) under the job's ``out`` directory."""
    with open(args.job) as f:
        job = json.load(f)
    r = args.rank
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        # A bare process sees every card of the node: hold it to the
        # grant, as a container runtime would (before CUDA starts).
        from tpushare_torch.utils.tenant import (mirror_visible_cards,
                                                 read_tenant_env)
        mirror_visible_cards(read_tenant_env())
    from tpushare_torch.cli import serve as serve_mod
    from tpushare_torch.models import moe, quant
    from tpushare_torch.models.paged import PagedSlotServer
    from tpushare_torch.parallel.mesh import serving_mesh
    from tpushare_torch.parallel.sharding import (replicated_specs,
                                                  shard_tree)
    rec: Dict[str, object] = {"rank": r}
    device = ["--device", "cpu"] if job["device"] == "cpu" else []
    argv = job["engine_argv"] + device + [
        "--mesh", "tp=%d" % RANKS, "--rank", str(r), "--dist-init",
        job["dist_init"], "--port", "0"]
    t0 = time.perf_counter()
    eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    mesh, dev = eng._mesh, eng.device
    rec["build_s"] = time.perf_counter() - t0
    rec["transport"] = mesh.describe()
    zero_launches()
    if r == 0:
        httpd = serve_mod.serve(eng, "127.0.0.1", 0, timeout_s=600.0)
        print(f"READY {httpd.server_address[1]}", flush=True)
        sys.stdin.readline()                            # STOP
        httpd.shutdown()
        httpd.server_close()
        eng.stop()                        # the followers' stop message
        st = eng.stats()
    else:
        eng.follow()
        st = eng.stats()
    rec["engine"] = {
        "launches": read_launches(), "digest": st["mesh_digest"],
        "fetches": eng.srv.device_fetches,
        **{k: st.get(k) for k in ("fetches_per_tick", "forwards_per_tick",
                                  "mesh_shape", "num_devices",
                                  "mesh_transport", "mesh_broadcasts",
                                  "work_ticks", "fused_ticks")}}
    inner = getattr(eng.srv, "wrapped", eng.srv)
    params, cfg = inner.params, inner.model_cfg
    del eng, inner
    _free(dev)

    # B, direct: the engine's slices behind a plain and a speculative
    # server, the prompts admitted whole.
    prompts = [np.asarray(p) for p in job["prompts"]]
    specs = replicated_specs(params)
    nb, bs = job["paged"]
    common = dict(n_slots=len(prompts), n_blocks=nb, block_size=bs,
                  mesh=mesh, param_specs=specs)
    zero_launches()
    with torch.inference_mode():
        plain = direct_run(PagedSlotServer(params, cfg, **common), prompts,
                           job["ticks"], record=r == 0)
        spec = direct_run(PagedSlotServer(
            params, cfg, speculative_draft=(params, cfg),
            draft_param_specs=specs, gamma=job["gamma"], **common),
            prompts, job["rounds"], record=False)
    rec["direct"] = {"launches": read_launches(),
                     "streams": plain["streams"],
                     "spec_streams": spec["streams"],
                     "ms_per_tick": plain["ms_per_tick"],
                     "ms_per_round": spec["ms_per_tick"],
                     "fetches": plain["fetches"],
                     "spec_fetches": spec["fetches"]}
    if r == 0:
        _save(plain["admit_rows"], os.path.join(job["out"], "llama.pt"))
    del params, specs, plain, spec
    _free(dev)

    # C: the MoE LM over ep, int8 experts through the fused kernel.
    mcfg = moe_workload(job["tiny"])[0]
    emesh = serving_mesh({"ep": RANKS}, devices=mesh.cards[:1]
                         if mesh.n_cards == 1 else mesh.cards).bind()
    with torch.inference_mode():
        full = moe_weights(mcfg, 0, dev)
        mparams = shard_tree(full, quant.quant_moe_param_specs(mcfg), emesh)
    del full
    _free(dev)
    mspecs = replicated_specs(mparams)
    mprompts = [np.asarray(p) for p in job["moe_prompts"]]
    mnb, mbs = job["moe_paged"]
    rec["moe"] = {}
    for name, rcfg in moe_routings(mcfg):
        zero_launches()
        srv = PagedSlotServer(mparams, rcfg, n_slots=len(mprompts),
                              n_blocks=mnb, block_size=mbs,
                              forward_fn=moe.paged_forward,
                              layers_hook=quant.fused_expert_hook(rcfg),
                              mesh=emesh, param_specs=mspecs)
        with torch.inference_mode():
            run = direct_run(srv, mprompts, job["moe_ticks"],
                             record=r == 0)
        rec["moe"][name] = {"launches": read_launches(),
                            "streams": run["streams"],
                            "ms_per_tick": run["ms_per_tick"],
                            "fetches": run["fetches"]}
        if r == 0:
            _save(run["admit_rows"],
                  os.path.join(job["out"], f"moe_{name}.pt"))
        del srv, run
        _free(dev)
    rec["memory"] = _memory(dev)
    with open(os.path.join(job["out"], f"rank{r}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _post(port: int, body: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def serving_env(args) -> dict:
    """The serving pod's grant on this node: its first ``RANKS`` cards
    (all it has where it has fewer), as ``gpu_env_for_cards`` writes
    it."""
    from tpushare_torch.plugin.topology import gpu_env_for_cards
    from tpushare_torch.tools.binpack import node_topology
    topo = node_topology(args.device)
    return gpu_env_for_cards(topo, [c.index for c in topo.chips[:RANKS]])


def twins(args, llama, moe_w) -> dict:
    """The one-card oracles, run in this process before the ranks start
    (each freed before the next): the Llama direct run and each MoE
    routing's."""
    from tpushare_torch import resolve_device
    from tpushare_torch.models import moe, quant
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.models.paged import PagedSlotServer
    dev = resolve_device("cpu" if args.device == "cpu" else None)
    argv, cfg, prompts, max_tokens, ticks, rounds, gamma = llama
    nb, bs = int(argv[argv.index("--n-blocks") + 1]), int(
        argv[argv.index("--block-size") + 1])
    out = {"paged": (nb, bs)}
    with torch.inference_mode():
        params = tt.init_params(0, cfg, device=dev)
        out["llama"] = direct_run(PagedSlotServer(
            params, cfg, n_slots=len(prompts), n_blocks=nb, block_size=bs,
            device=dev), prompts,
            max(max_tokens - 1, ticks, rounds * (gamma + 1)))
        del params
        _free(dev)
        mcfg, mprompts, mticks, (mnb, mbs) = moe_w
        mparams = moe_weights(mcfg, 0, dev)
        out["moe"] = {}
        for name, rcfg in moe_routings(mcfg):
            out["moe"][name] = direct_run(PagedSlotServer(
                mparams, rcfg, n_slots=len(mprompts), n_blocks=mnb,
                block_size=mbs, forward_fn=moe.paged_forward,
                layers_hook=quant.fused_expert_hook(rcfg), device=dev),
                mprompts, mticks)
        del mparams
        _free(dev)
    return out


def run_ranks(args, tmp: str, llama, moe_w) -> dict:
    """Part B's engine over HTTP and both parts' direct runs on the two
    rank processes; their records and the HTTP answers."""
    from tpushare_torch.tools.binpack import child_env, free_port
    from tpushare_torch.tools.colocate import _readline
    argv, cfg, prompts, max_tokens, ticks, rounds, gamma = llama
    mcfg, mprompts, mticks, mgeom = moe_w
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir)
    job = {"device": args.device, "tiny": args.tiny, "engine_argv": argv,
           "dist_init": f"tcp://127.0.0.1:{free_port()}",
           "prompts": [p.tolist() for p in prompts], "ticks": ticks,
           "rounds": rounds, "gamma": gamma,
           "paged": [int(argv[argv.index("--n-blocks") + 1]),
                     int(argv[argv.index("--block-size") + 1])],
           "moe_prompts": [p.tolist() for p in mprompts],
           "moe_ticks": mticks, "moe_paged": list(mgeom), "out": out_dir}
    path = os.path.join(tmp, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = child_env(serving_env(args))
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    logs = []
    for r in range(RANKS):
        lf = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(lf)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpushare_torch.tools.multichip",
             "--rank-worker", "--job", path, "--rank", str(r)],
            env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE if r == 0 else lf,
            stderr=lf, text=True))
    res: Dict[str, object] = {}
    try:
        t0 = time.perf_counter()
        deadline, seen = time.time() + INIT_TIMEOUT_S, []
        while True:          # rank 0 prints the mesh's transport first
            line = _readline(procs[0], deadline)
            if line.startswith("READY") or not line:
                break
            seen.append(line.strip())
        if not line:
            raise RuntimeError(f"rank 0 died before READY: {seen}")
        res["printed"] = seen
        port = int(line.split()[1])
        res["ready_s"] = time.perf_counter() - t0
        answers: List[object] = [None] * len(prompts)

        def post(i):
            answers[i] = _post(port, {"prompt": prompts[i].tolist(),
                                      "max_tokens": max_tokens})
        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(INIT_TIMEOUT_S)
        res["http_s"] = time.perf_counter() - t1
        res["answers"] = [a["tokens"] if isinstance(a, dict) else None
                          for a in answers]
        res["stats"] = {k: v for k, v in _get(port, "/stats").items()
                        if k.startswith("mesh") or k in (
                            "num_devices", "num_devices_configured",
                            "healthy_devices", "degraded",
                            "fetches_per_tick", "forwards_per_tick",
                            "fused_ticks", "chunked_admits", "work_ticks")}
        procs[0].stdin.write("STOP\n")
        procs[0].stdin.flush()
        for p in procs:
            p.wait(INIT_TIMEOUT_S)
        res["rc"] = [p.returncode for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
    res["ranks"] = []
    for r in range(RANKS):
        fp = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(fp):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"rank {r} wrote no record (rc "
                               f"{res.get('rc')}): {tail}")
        with open(fp) as f:
            res["ranks"].append(json.load(f))
    res["rows"] = {n: torch.load(os.path.join(out_dir, f"{n}.pt"))
                   for n in ("llama", "moe_psum", "moe_a2a")}
    return res


def gates(twin: dict, res: dict, n_prompts: int, ticks: int,
          moe_prompts: int, moe_ticks: int) -> dict:
    """Parts B and C's readings and failures."""
    failures: List[str] = []
    out: Dict[str, object] = {}
    ranks = res["ranks"]
    tw = twin["llama"]

    def streams_vs(name, got_streams, want, tol, length=None):
        flips = []
        for i, (g, w) in enumerate(zip(got_streams, want["streams"])):
            if g is None:
                failures.append(f"{name}: prompt {i} got no answer")
                continue
            n = length or len(g)
            try:
                f = flip_check(g[:n], w[:n], want["rows"][i], tol)
            except AssertionError as e:
                failures.append(f"{name}: prompt {i}: {e}")
                continue
            if f is not None:
                flips.append([i] + f)
        return flips

    if res.get("rc") != [0] * RANKS:
        failures.append(f"rank exit codes {res.get('rc')}")
    # B: the engine over HTTP.
    out["engine_flips"] = streams_vs("engine", res["answers"], tw,
                                     LOGIT_REL_TOL)
    st = res["stats"]
    if not (st.get("fetches_per_tick") or 2) <= 1.0:
        failures.append(f"engine fetches_per_tick {st.get('fetches_per_tick')}")
    if st.get("mesh_shape") != {"tp": RANKS} or st.get("num_devices") != RANKS:
        failures.append(f"engine /stats mesh {st.get('mesh_shape')} on "
                        f"{st.get('num_devices')} devices")
    e = [rk["engine"] for rk in ranks]
    if len({x["digest"] for x in e}) != 1 or \
            len({x["fetches"] for x in e}) != 1:
        failures.append(f"engine ranks part: digests "
                        f"{[x['digest'] for x in e]}, fetches "
                        f"{[x['fetches'] for x in e]}")
    # B: the direct servers.
    d = [rk["direct"] for rk in ranks]
    for key in ("streams", "spec_streams", "fetches", "spec_fetches"):
        if any(x[key] != d[0][key] for x in d[1:]):
            failures.append(f"direct {key}: a rank parts from rank 0")
    if d[0]["fetches"] != n_prompts + ticks:
        failures.append(f"direct plain server: {d[0]['fetches']} fetches "
                        f"for {n_prompts} admissions and {ticks} ticks")
    out["direct_flips"] = streams_vs("direct", d[0]["streams"], tw,
                                     LOGIT_REL_TOL)
    out["spec_flips"] = streams_vs("speculative", d[0]["spec_streams"], tw,
                                   LOGIT_REL_TOL,
                                   length=len(tw["streams"][0]))
    dist_ = [logit_distance(g, w) for g, w in
             zip(res["rows"]["llama"], tw["admit_rows"])]
    out["admit_logit_rel"] = max(dist_)
    if max(dist_) > LOGIT_REL_TOL:
        failures.append(f"direct admissions' logits {max(dist_):.4f} of the "
                        f"twin's largest |logit| (gate {LOGIT_REL_TOL})")
    out["ms_per_tick"] = {"sharded": d[0]["ms_per_tick"],
                          "twin": tw["ms_per_tick"],
                          "sharded_spec_round": d[0]["ms_per_round"]}
    # C: each routing over ep.
    out["moe"] = {}
    for name, tw_m in twin["moe"].items():
        m = [rk["moe"][name] for rk in ranks]
        if any(x["streams"] != m[0]["streams"] or
               x["fetches"] != m[0]["fetches"] for x in m[1:]):
            failures.append(f"moe {name}: a rank parts from rank 0")
        if m[0]["fetches"] != moe_prompts + moe_ticks:
            failures.append(f"moe {name}: {m[0]['fetches']} fetches for "
                            f"{moe_prompts} admissions, {moe_ticks} ticks")
        flips = streams_vs(f"moe {name}", m[0]["streams"], tw_m,
                           MOE_LOGIT_REL_TOL)
        md = max(logit_distance(g, w) for g, w in
                 zip(res["rows"][f"moe_{name}"], tw_m["admit_rows"]))
        if md > MOE_LOGIT_REL_TOL:
            failures.append(f"moe {name} admissions' logits {md:.4f} of the "
                            f"twin's largest |logit| (gate "
                            f"{MOE_LOGIT_REL_TOL})")
        out["moe"][name] = {"flips": flips, "admit_logit_rel": md,
                            "ms_per_tick": m[0]["ms_per_tick"],
                            "twin_ms_per_tick": tw_m["ms_per_tick"]}
    out["launches"] = {
        "engine": _sum(rk["engine"]["launches"] for rk in ranks),
        "direct": _sum(rk["direct"]["launches"] for rk in ranks),
        **{f"moe_{n}": _sum(rk["moe"][n]["launches"] for rk in ranks)
           for n in twin["moe"]}}
    out["memory"] = [rk.get("memory") for rk in ranks]
    out["transport"] = ranks[0]["transport"]
    out["failures"] = failures
    return out


def _sum(dicts) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


# -- D: the small tenants ----------------------------------------------------

def small_main(args) -> None:
    """One small pod: its env first, then one BERT-base forward."""
    from tpushare_torch.models import bert
    from tpushare_torch.utils.tenant import apply_tenant_limits, tenant_device
    spec = apply_tenant_limits()
    dev = tenant_device() if args.device == "cuda" else torch.device("cpu")
    cfg = bert.tiny() if args.tiny else bert.bert_base()
    B, S = (2, 16) if args.tiny else (8, 128)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bert.init_params(gen, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        pooled = bert.forward(params, tokens, cfg)["pooled"]
        _sync(dev)
    print(RESULT_TAG + json.dumps({
        "finite": bool(torch.isfinite(pooled).all()),
        "shape": list(pooled.shape),
        "forward_ms": (time.perf_counter() - t0) * 1e3,
        "hbm_limit_bytes": spec.hbm_limit_bytes,
        "visible": os.environ.get("NVIDIA_VISIBLE_DEVICES"),
        **_memory(dev)}), flush=True)


def small_tenants(args) -> dict:
    """Part D: both small pods at once, each with the node's grant for
    an 8-unit pod."""
    from tpushare_torch.plugin.const import GIB
    from tpushare_torch.tools.binpack import child_env
    from tpushare_torch.tools.colocate import node, plugin_env
    topo, unit = node(args.device)
    if topo.chip_count > 1:
        # Bin-packed beside the serving pod: the card after its grant
        # (the last one on a smaller node) is the small pods' node.
        i = min(RANKS, topo.chip_count - 1)
        topo = dataclasses.replace(topo, chips=topo.chips[i:i + 1])
    # On the host: a quarter of the 128 MiB fake card, in MiB.
    units = SMALL_UNITS if unit == GIB else 32
    procs = []
    for _ in range(2):
        env = child_env(plugin_env(topo, unit, units))
        cmd = [sys.executable, "-m", "tpushare_torch.tools.multichip",
               "--small-tenant", "--device", args.device]
        if args.tiny:
            cmd.append("--tiny")
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    results, failures = [], []
    for p in procs:
        out, _ = p.communicate(timeout=INIT_TIMEOUT_S)
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
        if p.returncode != 0 or not lines:
            failures.append(f"small tenant rc={p.returncode}: {out[-400:]!r}")
            continue
        res = json.loads(lines[-1][len(RESULT_TAG):])
        if not res["finite"]:
            failures.append("small tenant: pooled output not finite")
        results.append(res)
    return {"tenants": results, "failures": failures}


def run(args, log=print) -> dict:
    """Parts A to D; the record, with every gate's failures."""
    record: Dict[str, object] = {"device": args.device, "tiny": args.tiny}
    t_all = time.perf_counter()
    llama = llama_workload(args.tiny)
    moe_w = moe_workload(args.tiny)
    with tempfile.TemporaryDirectory(prefix="multichip-") as tmp:
        t0 = time.perf_counter()
        record["A"] = place(tmp)
        record["A"]["seconds"] = time.perf_counter() - t0
        log(json.dumps({"part": "A", **record["A"]}))
        t0 = time.perf_counter()
        twin = twins(args, llama, moe_w)
        twin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_ranks(args, tmp, llama, moe_w)
        ranks_s = time.perf_counter() - t0
    g = gates(twin, res, len(llama[2]), llama[4], len(moe_w[1]), moe_w[2])
    record["BC"] = dict(g, twin_s=twin_s, ranks_s=ranks_s,
                        ready_s=res["ready_s"], http_s=res["http_s"],
                        printed=res["printed"],
                        stats=res["stats"],
                        build_s=[rk["build_s"] for rk in res["ranks"]])
    log(json.dumps({"part": "BC", **record["BC"]}))
    t0 = time.perf_counter()
    record["D"] = small_tenants(args)
    record["D"]["seconds"] = time.perf_counter() - t0
    log(json.dumps({"part": "D", **record["D"]}))
    record["seconds"] = time.perf_counter() - t_all
    record["failures"] = [f"{p}: {f}" for p in ("A", "BC", "D")
                          for f in record[p]["failures"]]
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--small-tenant", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--job", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.rank_worker:
        rank_main(args)
        return 0
    if args.small_tenant:
        small_main(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multichip: no CUDA card (pass --device cpu for the host "
              "run)", file=sys.stderr)
        return 2
    record = run(args)
    print(json.dumps(record, default=str))
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
