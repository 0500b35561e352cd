"""BASELINE.md's mixed bin-pack row on the port: a Llama-3-8B serving pod
granted two cards' worth, and two small pods bin-packed beside it. The
counterpart of ``demo/e2e_multichip.py``. Run from the repository root:

    python -m tpushare_torch.tools.multichip                 # on the card(s)
    python -m tpushare_torch.tools.multichip --device cpu --tiny
    python -m tpushare_torch.tools.multichip --part train    # part F

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Prints one JSON line per part, then the record
(part F: its one line); exits 1 when a gate fails.

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
  8B at full width, ``B_LAYERS`` of its 32 layers, from seed 0;
  ``--tiny``: the tiny config on the CPU) as two rank processes, their
  env the node's grant for the serving pod (``gpu_env_for_cards``).
  Rank 0 serves HTTP; rank 1 follows. With fewer cards than ranks the
  ranks share card 0 and their collectives run over gloo through the
  host (printed): such times are not tensor-parallel measurements.
  Eight prompts of 16..2048 tokens (``--tiny``: 4..40) go over HTTP
  with chunked admission; then both ranks drive a direct sharded
  ``PagedSlotServer`` over the engine's slices: the prompts admitted whole, decode ticks timed, and a second
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

- F. Training over tp and ep (``--part train``), rank processes sharing
  the card over gloo: F1, Llama-3-8B at ``F1_LAYERS`` layers over tp=2
  (the gradient of the SPMD step's loss, two SGD steps, the replicated
  leaves' digests, then ``trainer.fit`` of the AdamW step at
  ``F1_ADAMW_LAYERS`` layers with each rank's moment bytes); F2,
  Mixtral's width at ``F2_LAYERS`` layers over ep=2 under psum and a2a,
  replaying the twin's routes (``RouteLog``); F3, Llama's width at
  ``F3_LAYERS`` layers over sp=2 x tp=2 (ring attention) and pp=2 x tp=2
  (1F1B). The one-card twins run first in this process; each writes its
  gradient whole to a scratch file, and every rank holds each of its
  gradient slices, read by offset, to the twin's within
  ``GRAD_REL_L2_TOL`` (relative L2), and its losses within
  ``F_LOSS_TOL``. Every group's ranks start before the twins and wait
  for their turn.
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
#: part E's second wave (on the regrown mesh): the first prompts of B's
E_WAVE2 = 4
#: part E's process case: the model's depth there
E_KILL_LAYERS = 8
#: parts B and E's depth, of Llama-3-8B's 32 layers: chip_smoke.py ran
#: past its 1200 s limit on a slower host with B at 32
B_LAYERS = 8

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
    cfg = dataclasses.replace(tt.llama3_8b(), n_layers=B_LAYERS)
    lens = [16, 100, 255, 511, 700, 1100, 1500, 2048]
    # 4 slots for 8 requests: a fused tick carries every slot's row at
    # the chunk's width, and over the one-card gloo stand-in each row's
    # bytes cross two host-staged all-reduces a layer.
    argv = ["--preset", "llama3_8b", "--n-layers", str(B_LAYERS),
            "--n-slots", "4", "--n-blocks", str(8 * 160 + 1),
            "--block-size", "16", "--prefill-chunk", "512"]
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
        job["dist_init"], "--port", "0"] + reshard_source(job, r, rec)
    t0 = time.perf_counter()
    eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    dev = eng.device
    rec["build_s"] = time.perf_counter() - t0
    rec["transport"] = eng._mesh.describe()
    zero_launches()
    if r == 0:
        httpd = serve_mod.serve(eng, "127.0.0.1", 0, timeout_s=600.0)
        print(f"READY {httpd.server_address[1]}", flush=True)
        sys.stdin.readline()                            # STOP
        httpd.shutdown()
        httpd.server_close()
        eng.stop()                        # the followers' stop message
        st = eng.stats()
        rec["generations"] = st.get("mesh_generations")
    else:
        gens: List[dict] = []
        eng.follow(report=gens.append)
        st = eng.stats()
        rec["generations"] = gens
    # Part E ended the engine on a later mesh generation, whose groups
    # the direct servers below use.
    mesh = eng._mesh
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


def reshard_source(job: dict, rank: int, rec: dict) -> List[str]:
    """Part E's weight source for a reshard, chosen from the host's
    ``MemAvailable`` (printed first): a host copy of the whole tree on
    every rank where the host holds them with a third to spare, else a
    checkpoint of it per rank (each read back by slice)."""
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.models.reshard import host_mem_available
    argv = job["engine_argv"]
    cfg = {"llama3_8b": tt.llama3_8b, "tiny": tt.tiny}[
        argv[argv.index("--preset") + 1]]()
    if "--n-layers" in argv:
        cfg = dataclasses.replace(
            cfg, n_layers=int(argv[argv.index("--n-layers") + 1]))
    need = cfg.num_params() * torch.empty(0, dtype=cfg.dtype).element_size()
    avail = host_mem_available()
    print(f"rank {rank}: MemAvailable {avail} bytes, a whole tree "
          f"{need} bytes", file=sys.stderr, flush=True)
    host = avail is None or avail >= need * (RANKS + 1)
    rec["reshard_source"] = {"mem_available": avail, "tree_bytes": need,
                             "source": "host" if host else "checkpoint"}
    if host:
        return []
    return ["--reshard-checkpoint",
            os.path.join(job["out"], f"reshard_rank{rank}.safetensors")]


def elastic_chip(port: int, prompts, max_tokens: int, n_wave2: int) -> dict:
    """Part E on part B's engine: a wave of ``prompts`` with ``POST
    /mesh/chip`` marking rank 1's card unhealthy once the first tokens
    are out (the engine reshards to tp=1 on rank 0 and replays), the
    card healthy again once the wave is answered (the engine grows back
    to tp=2 at an idle tick), then a second wave of the first
    ``n_wave2`` prompts on the regrown mesh."""
    from tpushare_torch.parallel.multihost_smoke import _pick, _wait, _wave
    out: Dict[str, object] = {}
    st0 = _get(port, "/stats")
    out["before"] = _pick(st0)
    t0 = time.perf_counter()
    threads, wave1, codes1 = _wave(port, prompts, max_tokens,
                                   INIT_TIMEOUT_S)
    _wait(lambda: _get(port, "/stats")["tokens_out"] > st0["tokens_out"],
          INIT_TIMEOUT_S, 0.02)
    t_fault = time.perf_counter()
    out["chip_down"] = _post(port, {"device": 1, "healthy": False},
                             path="/mesh/chip")
    _wait(lambda: _get(port, "/stats")["reshards"] >= 1, INIT_TIMEOUT_S,
          0.01)
    out["reshard_s"] = time.perf_counter() - t_fault
    for t in threads:
        t.join(INIT_TIMEOUT_S)
    out["wave1_s"] = time.perf_counter() - t0
    out["degraded"] = _pick(_get(port, "/stats"))
    t_back = time.perf_counter()
    out["chip_up"] = _post(port, {"device": 1, "healthy": True},
                           path="/mesh/chip")
    _wait(lambda: _get(port, "/stats")["grow_backs"] >= 1, INIT_TIMEOUT_S,
          0.02)
    out["grow_back_s"] = time.perf_counter() - t_back
    t2 = time.perf_counter()
    threads, wave2, codes2 = _wave(port, prompts[:n_wave2], max_tokens,
                                   INIT_TIMEOUT_S)
    for t in threads:
        t.join(INIT_TIMEOUT_S)
    out["wave2_s"] = time.perf_counter() - t2
    out["after"] = _pick(_get(port, "/stats"))
    out.update(wave1=wave1, codes1=codes1, wave2=wave2, codes2=codes2)
    return out


def _post(port: int, body: dict, timeout: float = 600.0,
          path: str = "/v1/completions") -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
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
        t2 = time.perf_counter()
        res["E"] = elastic_chip(port, prompts, max_tokens, E_WAVE2)
        res["E"]["seconds"] = time.perf_counter() - t2
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
    out["E"] = gates_e(tw, res, ranks, failures, streams_vs)
    out["failures"] = failures
    return out


def _deltas(gens: List[dict]) -> Dict[int, dict]:
    """A rank's generation records (cumulative launches) -> each
    generation's own launches, shape and peak memory."""
    out, prev = {}, {}
    for g in sorted(gens or [], key=lambda g: g["mesh_generation"]):
        cum = g.get("launches") or {}
        out[g["mesh_generation"]] = {
            "rank": g.get("rank"), "mesh_shape": g.get("mesh_shape"),
            "peak_bytes": g.get("peak_bytes"), "digest": g.get("digest"),
            "launches": {k: v - prev.get(k, 0) for k, v in cum.items()
                         if v - prev.get(k, 0)}}
        prev = cum
    return out


def gates_e(tw: dict, res: dict, ranks: List[dict], failures: List[str],
            streams_vs) -> dict:
    """Part E's chip case: the shrink, the replay and the grow-back (the
    kernels of each generation only where the ranks ran on a card)."""
    e = res["E"]
    out: Dict[str, object] = {k: e[k] for k in (
        "reshard_s", "grow_back_s", "wave1_s", "wave2_s", "seconds")}
    out["reshard_ms"] = e["after"]["reshard_ms"]
    out["grow_back_ms"] = e["after"]["grow_back_ms"]
    out["reshard_source"] = [rk.get("reshard_source") for rk in ranks]
    deg, aft = e["degraded"], e["after"]
    out["stats"] = {"degraded": deg, "after": aft}
    if not (deg["reshards"] == 1 and deg["degraded"]
            and deg["mesh_shape_current"] == {}):
        failures.append(f"E: no shrink to tp=1: {deg}")
    if not (aft["grow_backs"] == 1 and not aft["degraded"]
            and aft["mesh_shape_current"] == {"tp": RANKS}):
        failures.append(f"E: no grow-back to tp={RANKS}: {aft}")
    if not deg["replayed_on_reshard"]:
        failures.append("E: the shrink replayed no request")
    for wave in ("1", "2"):
        if any(c != 200 for c in e["codes" + wave]):
            failures.append(f"E wave {wave} statuses {e['codes' + wave]}")
    out["wave1_flips"] = streams_vs("E wave 1 (shrink)", e["wave1"], tw,
                                    LOGIT_REL_TOL)
    out["wave2_flips"] = streams_vs("E wave 2 (regrown)", e["wave2"], tw,
                                    LOGIT_REL_TOL)
    per = [_deltas(rk.get("generations")) for rk in ranks]
    out["generations"] = per
    r0, r1 = per[0], per[1] if len(per) > 1 else {}
    for g in sorted(set(r0) & set(r1)):
        if r0[g]["digest"] != r1[g]["digest"]:
            failures.append(f"E generation {g}: digests {r0[g]['digest']} "
                            f"!= {r1[g]['digest']}")
    last = max(r0) if r0 else None
    if last is None or last not in r1 or \
            r1[last]["digest"] != aft["mesh_digest"]:
        failures.append(f"E: rank 1 served no final generation with "
                        f"rank 0's digest {aft['mesh_digest']}")
    if ranks[0]["transport"] == "gloo":         # the CPU: no kernels
        return out
    tp1 = [g for g, v in r0.items() if v["mesh_shape"] == {}]
    for g in tp1:
        got = r0[g]["launches"]
        for name in ("flash_attention", "paged_flash_decode",
                     "paged_flash_verify"):
            if not got.get(name):
                failures.append(f"E generation {g} (tp=1): {name} was "
                                f"not launched on rank 0 ({got})")
    if last is not None:
        for rk, gens in enumerate(per):
            got = gens.get(last, {}).get("launches", {})
            if not got.get("paged_flash_decode") or not (
                    got.get("flash_attention")
                    or got.get("paged_flash_verify")):
                failures.append(f"E generation {last} (tp={RANKS}): rank "
                                f"{rk} launched {got}")
    return out


def gates_kill(tw: dict, rec: dict) -> dict:
    """Part E's process case: the liaison's verdict, the reshard around
    the killed rank (within the liaison's heartbeat timeout + 10 s), its
    rejoin and the grow-back."""
    from tpushare_torch.parallel.gang import HEARTBEAT_TIMEOUT_S
    heartbeat_s = HEARTBEAT_TIMEOUT_S
    failures: List[str] = []
    st = rec["stats"]
    out = {k: rec.get(k) for k in ("ready_s", "detect_s", "reshard_s",
                                   "grow_back_s", "rc")}
    out["stats"] = st

    def flips(name, streams, n):
        got = []
        for i, (g, w) in enumerate(zip(streams, tw["streams"][:n])):
            if g is None:
                failures.append(f"{name}: prompt {i} got no answer")
                continue
            try:
                f = flip_check(g, w, tw["rows"][i], LOGIT_REL_TOL)
            except AssertionError as e:
                failures.append(f"{name}: prompt {i}: {e}")
                continue
            if f is not None:
                got.append([i] + f)
        return got
    out["wave1_flips"] = flips("E kill wave 1", rec["wave1"], len(
        rec["wave1"]))
    out["wave2_flips"] = flips("E kill wave 2", rec["wave2"], len(
        rec["wave2"]))
    if not ((st["host_losses"] or 0) >= 1 and st["reshards"] >= 1
            and st["grow_backs"] >= 1
            and st["mesh_shape_current"] == {"tp": RANKS}
            and st["healthy_processes"] == st["num_processes"] == RANKS):
        failures.append(f"E kill: no loss, reshard and grow-back: {st}")
    if rec.get("detect_s") is None or \
            rec["reshard_s"] > heartbeat_s + 10.0:
        failures.append(f"E kill: resharded {rec.get('reshard_s')} s after "
                        f"the kill (limit {heartbeat_s} + 10)")
    reports = rec["reports"].get("rank1_restarted") or []
    if not reports or reports[-1]["digest"] != st["mesh_digest"]:
        failures.append(f"E kill: the restarted rank's digest "
                        f"{reports[-1]['digest'] if reports else None} != "
                        f"rank 0's {st['mesh_digest']}")
    out["generations"] = {
        "rank0": _deltas(st.get("mesh_generations")),
        "rank1": _deltas(rec["reports"].get("rank1")),
        "rank1_restarted": _deltas(reports)}
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


def elastic_kill(args, tmp: str, llama, twin: dict) -> dict:
    """Part E's process case: B's engine flags on two rank processes of
    the serve CLI with ``--process-view 2`` and the gang liaison,
    rank 1's process SIGKILLed mid-wave and restarted
    (``parallel/multihost_smoke.run_elastic``), at ``E_KILL_LAYERS``
    of the model's layers (the twin cut alike); gated by ``gates_kill``."""
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.models.paged import PagedSlotServer
    from tpushare_torch.parallel.multihost_smoke import run_elastic
    from tpushare_torch.tools.binpack import child_env
    argv, cfg, prompts, max_tokens, ticks, rounds, gamma = llama
    extra = ["--device", "cpu"] if args.device == "cpu" else []
    tw = twin["llama"]
    if E_KILL_LAYERS and E_KILL_LAYERS < cfg.n_layers and not args.tiny:
        extra += ["--n-layers", str(E_KILL_LAYERS)]
        ccfg = dataclasses.replace(cfg, n_layers=E_KILL_LAYERS)
        nb, bs = twin["paged"]
        dev = torch.device("cuda")
        with torch.inference_mode():
            params = tt.init_params(0, ccfg, device=dev)
            tw = direct_run(PagedSlotServer(
                params, ccfg, n_slots=len(prompts), n_blocks=nb,
                block_size=bs, device=dev), prompts,
                max(max_tokens - 1, ticks))
            del params
        _free(dev)
    env = child_env(serving_env(args))
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    rec = run_elastic(argv + extra, [p.tolist() for p in prompts],
                      max_tokens, scenario="kill", log_dir=tmp, env=env,
                      timeout=INIT_TIMEOUT_S, n_wave2=E_WAVE2)
    out = gates_kill(tw, rec)
    out["seconds"] = time.perf_counter() - t0
    out["n_layers"] = (E_KILL_LAYERS if "--n-layers" in extra
                       else cfg.n_layers)
    return out


# -- part F: training over tp and ep -------------------------------------------
#: part F's gradient gate: the relative L2 of each rank's gradient slice
#: against the one-card twin's same slice (chip_smoke.py's
#: GRAD_REL_L2_TOL).
GRAD_REL_L2_TOL = 5e-2
#: |rank loss - twin loss| of F1's two SGD steps
F_LOSS_TOL = 1e-2
F_SEQ = 2048                  # F1, F2: tokens a row
#: F1's SGD depth, of Llama-3-8B's 32: 32 layers took part F to 202 s
#: against its 150 s budget (PERF.md §6)
F1_LAYERS = 16
F1_ADAMW_LAYERS = 4           # F1's AdamW depth (the f32 moments)
F1_ADAMW_STEPS = 3
F2_LAYERS = 2                 # of Mixtral-8x7B's 32, as slice_moe_train
F2_CAPACITY = 1.25            # psum's capacity factor
F3_LAYERS = 4                 # of Llama-3-8B's 32
F3_SP_SEQ = 4096              # F3 sp=2 x tp=2: one row in two shards
F3_PP_M, F3_PP_SEQ = 4, 1024  # F3 pp=2 x tp=2: 1F1B microbatches
TRAIN_LR = 3e-4
#: part F's rank groups: (part, mesh); F3 runs two meshes of 4 ranks
F_GROUPS = (("f1", {"tp": 2}), ("f2", {"ep": 2}),
            ("f3", {"sp": 2, "tp": 2}))


def train_workload(tiny: bool) -> dict:
    """Part F's configurations and token batches (``utils/data.py``'s
    batches over a seeded corpus)."""
    from tpushare_torch.models import convert, moe
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.utils.data import batch_at
    if tiny:
        llama, mix = tt.tiny(), moe.tiny()
        seq, f1_layers, f3_layers, sp_seq, pp_seq, f1_adamw = (
            16, 2, 4, 32, 8, 2)
    else:
        llama = tt.llama3_8b()
        mix = convert.moe_config_from_hf(argparse.Namespace(**MIXTRAL_8X7B))
        seq, f1_layers, f3_layers, sp_seq, pp_seq, f1_adamw = (
            F_SEQ, F1_LAYERS, F3_LAYERS, F3_SP_SEQ, F3_PP_SEQ,
            F1_ADAMW_LAYERS)
    corpus = np.random.default_rng(11).integers(
        0, min(llama.vocab_size, mix.vocab_size), 16 * sp_seq).astype(
            np.uint32)

    def batch(step, b, s):
        return batch_at(corpus, step, batch_size=b, seq_len=s, seed=11)
    return {
        "f1": {"cfg": dataclasses.replace(llama, n_layers=f1_layers,
                                          remat=True),
               "tokens": batch(0, 1, seq), "adamw_layers": f1_adamw,
               # One batch, repeated: the loss must fall.
               "fit": [batch(0, 1, seq)] * F1_ADAMW_STEPS},
        # Remat off: one top-k a layer, the routes the ranks replay.
        "f2": {"cfg": dataclasses.replace(mix, n_layers=F2_LAYERS,
                                          remat=False),
               "psum": batch(0, 1, seq), "a2a": batch(1, 2, seq)},
        "f3": {"cfg": dataclasses.replace(llama, n_layers=f3_layers,
                                          remat=True),
               "sp": batch(0, 1, sp_seq), "pp": batch(1, F3_PP_M, pp_seq)},
    }


def train_routings(cfg):
    """F2's routings: psum at capacity F2_CAPACITY (the batch replicated
    over ep), a2a at E / top_k (ep a data axis, nothing dropped)."""
    return [("psum", dataclasses.replace(cfg, routing="psum",
                                         capacity_factor=F2_CAPACITY)),
            ("a2a", dataclasses.replace(cfg, routing="a2a",
                                        capacity_factor=a2a_capacity(cfg)))]


class RouteLog:
    """``moe.top_k_lower_index`` patched for the with-block: each call's
    expert ids kept in order (one a layer of a forward, remat off), or,
    with ``replay`` (another run's ids cut to this rank's rows), each
    call routes to the ids replayed, its weights gathered from this
    run's own router probabilities; ``flips`` counts the entries where
    this run alone would have routed otherwise."""

    def __init__(self, moe, replay=None):
        self.moe, self.replay, self.ids, self.flips = moe, replay, [], 0

    def top_k(self, probs, k):
        vals, idx = self.orig(probs, k)
        if self.replay is None:
            self.ids.append(idx.detach().cpu())
            return vals, idx
        want = self.replay[len(self.ids)].to(idx.device)
        self.ids.append(want)
        self.flips += int((idx.sort(-1).values
                           != want.sort(-1).values).sum())
        return torch.gather(probs, -1, want), want

    def __enter__(self):
        self.orig = self.moe.top_k_lower_index
        self.moe.top_k_lower_index = self.top_k
        return self

    def __exit__(self, *exc):
        self.moe.top_k_lower_index = self.orig


def _leaves_numel(tree) -> int:
    from tpushare_torch.models.training import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def _pairs(tokens, dev):
    t = torch.as_tensor(np.asarray(tokens), device=dev)
    return t[:, :-1], t[:, 1:]


def _write_scratch(path: str, tree) -> int:
    """``tree`` in the checkpoint file format at ``path`` (``checkpoint
    .write``), with no fsync: scratch, read back at once and gone with
    the run's directory. Returns the file's bytes."""
    from tpushare_torch.utils import checkpoint
    with open(path, "wb") as f:
        checkpoint.write(f, tree)
    return os.path.getsize(path)


def _twin(out_dir: str, name: str, loss_fn, params, tokens, cfg, dev,
          rec: dict, writer):
    """One one-card gradient through the kernels: its loss, time and
    launches; the gradient is written whole to ``<out_dir>/<name>``
    (``_write_scratch``) on the ``writer`` thread while the next twin
    computes, and the ranks read their slices of it by offset. Returns
    the gradient."""
    from tpushare_torch.models import training
    inputs, targets = _pairs(tokens, dev)
    zero_launches()
    t0 = time.perf_counter()
    loss, grads = training.value_and_grad(loss_fn, params, inputs, targets,
                                          cfg)
    _sync(dev)
    rec[name] = {"loss": float(loss), "s": time.perf_counter() - t0,
                 "launches": read_launches(), **_memory(dev)}

    def write():
        t0 = time.perf_counter()
        rec[name]["grad_bytes"] = _write_scratch(
            os.path.join(out_dir, name), grads)
        rec[name]["write_s"] = time.perf_counter() - t0
    writer(write)
    return grads


def train_twins(args, tmp: str, wl: dict) -> dict:
    """Part F's one-card oracles, run in this process before the ranks
    start, each freed before the next: F1's gradient and the loss its
    second SGD step starts from, F2's gradient under each routing with
    the routes it took, F3's gradient of each batch."""
    from concurrent.futures import ThreadPoolExecutor
    from tpushare_torch import resolve_device
    dev = resolve_device("cpu" if args.device == "cpu" else None)
    rec: Dict[str, object] = {}
    # One writer a twin's kind: the gradients go to the page cache side
    # by side.
    with ThreadPoolExecutor(max_workers=3) as pool:
        writes = []
        _twins(tmp, wl, dev, rec,
               lambda fn: writes.append(pool.submit(fn)))
        for w in writes:
            w.result()                    # a failed write raises here
    # The gradients the writes held are free only now: hand their cached
    # blocks back to the card before the ranks start.
    _free(dev)
    return rec


def _twins(tmp: str, wl: dict, dev, rec: dict, writer) -> None:
    from tpushare_torch.models import moe, training
    from tpushare_torch.models import transformer as tt

    def seeded(init, cfg, seed):
        return init(torch.Generator(device=dev).manual_seed(seed), cfg,
                    device=dev)

    f1 = wl["f1"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = seeded(tt.init_params, f1["cfg"], 21)
    g = _twin(tmp, "f1", training.xent_loss, params, f1["tokens"],
              f1["cfg"], dev, rec, writer)
    training._sgd_update(params, g, TRAIN_LR)
    del g
    with torch.no_grad():
        rec["f1"]["loss_after_step"] = float(training.xent_loss(
            params, *_pairs(f1["tokens"], dev), f1["cfg"]))
    del params
    _free(dev)

    f2 = wl["f2"]
    params = seeded(moe.init_params, f2["cfg"], 22)
    for name, rcfg in train_routings(f2["cfg"]):
        with RouteLog(moe) as log:
            g = _twin(tmp, f"f2_{name}", moe.xent_loss, params, f2[name],
                      rcfg, dev, rec, writer)
        del g
        torch.save(log.ids, os.path.join(tmp, f"f2_{name}_routes.pt"))
        _free(dev)
    del params
    _free(dev)

    f3 = wl["f3"]
    params = seeded(tt.init_params, f3["cfg"], 23)
    for name in ("sp", "pp"):
        g = _twin(tmp, f"f3_{name}", training.xent_loss, params, f3[name],
                  f3["cfg"], dev, rec, writer)
        del g
        _free(dev)
    del params
    _free(dev)


def _nest(key: str, leaf):
    out = leaf
    for part in reversed(key.split("/")):
        out = {part: out}
    return out


def _pick(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def compare_slices(path: str, grads, specs, mesh) -> Dict[str, float]:
    """The relative L2 of each of this rank's gradient slices against the
    same slice of the twin's whole gradient at ``path``, read by offset
    one leaf at a time (only the slice's bytes)."""
    from tpushare_torch.utils import checkpoint
    sp = dict(checkpoint.key_paths(specs))
    out = {}
    for key, g in checkpoint.key_paths(grads):
        want = _pick(checkpoint.restore(
            path, like=_nest(key, g), shardings=checkpoint.mesh_shardings(
                _nest(key, sp[key]), mesh)), key).float()
        out[key] = float((g.float() - want).norm()
                         / want.norm().clamp_min(1e-30))
        del want
    return out


def _digests_equal(training, params, specs, mesh) -> bool:
    """Every rank of a tp group holds bit-equal replicated leaves."""
    from tpushare_torch.parallel.mesh import mesh_layout
    _, coords = mesh_layout(mesh)
    key = tuple(v for ax, v in coords.items() if ax != "tp")
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(
        got, (key, training.replicated_digest(params, specs)))
    by: Dict[tuple, set] = {}
    for k, d in got:
        by.setdefault(tuple(k), set()).add(d)
    return all(len(v) == 1 for v in by.values())


def _f1(job, mesh, dev, wl) -> dict:
    """F1 on this rank: Llama-3-8B over tp=2."""
    from tpushare_torch.models import trainer, training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.models.quant import param_bytes
    f1 = wl["f1"]
    cfg = f1["cfg"]
    tokens = torch.as_tensor(np.asarray(f1["tokens"]), device=dev)
    step = training.make_spmd_train_step(cfg, mesh, lr=TRAIN_LR)
    whole = tt.init_params(torch.Generator(device=dev).manual_seed(21), cfg,
                           device=dev)
    params = step.shard(whole)
    del whole
    _free(dev)
    out: Dict[str, object] = {"param_bytes": param_bytes(params)}
    zero_launches()
    t0 = time.perf_counter()
    with ReduceClock(dev) as clock:
        loss, grads = step.loss_and_grads(params, tokens)
        _sync(dev)
    out["grad_s"] = time.perf_counter() - t0
    out["reduce_s"] = clock.s
    out["launches"] = read_launches()
    out["losses"] = [float(loss)]
    t0 = time.perf_counter()
    out["grad_rel_l2"] = compare_slices(os.path.join(job["tmp"], "f1"),
                                        grads, step.specs, mesh)
    out["compare_s"] = time.perf_counter() - t0
    training._sgd_update(params, grads, TRAIN_LR)
    del grads
    t0 = time.perf_counter()
    params, loss = step(params, tokens)
    _sync(dev)
    out["step_s"] = time.perf_counter() - t0
    out["losses"].append(float(loss))
    out["digests_equal"] = _digests_equal(training, params, step.specs, mesh)
    out["memory"] = _memory(dev)
    del params
    _free(dev)
    # AdamW at F1_ADAMW_LAYERS layers through trainer.fit: the moments
    # shard like the params.
    acfg = dataclasses.replace(cfg, n_layers=f1["adamw_layers"])
    astep = training.make_adamw_spmd_train_step(acfg, mesh, lr=TRAIN_LR)
    whole = tt.init_params(torch.Generator(device=dev).manual_seed(24), acfg,
                           device=dev)
    whole_numel, whole_bytes = _leaves_numel(whole), param_bytes(whole)
    params = astep.shard(whole)
    del whole
    state = training.adamw_init(params)
    moments = param_bytes({"mu": state["mu"], "nu": state["nu"]})
    batches = [torch.as_tensor(np.asarray(b), device=dev) for b in f1["fit"]]
    save = _CkptWatch(astep, dev)
    t0 = time.perf_counter()
    params, state, losses = trainer.fit(
        astep, params, state, iter(batches), steps=len(batches),
        log_every=0, ckpt_dir=os.path.join(job["tmp"], "f1_ckpt"),
        ckpt_every=len(batches))
    _sync(dev)
    out["adamw"] = {"layers": acfg.n_layers, "losses":
                    [float(x) for x in losses],
                    "fit_s": time.perf_counter() - t0,
                    "moment_bytes": moments,
                    "slice_params": _leaves_numel(params),
                    "whole_params": whole_numel,
                    "whole_param_bytes": whole_bytes,
                    "ckpt": dict(save.rec, whole_leaf_max=_whole_leaf_max(
                        training, params, astep.specs, mesh))}
    del params, state
    _free(dev)
    return out


class _Sink:
    """A binary file object that keeps only the count of bytes written."""

    def __init__(self):
        self.n = 0

    def write(self, b) -> int:
        self.n += memoryview(b).nbytes
        return memoryview(b).nbytes


class _CkptWatch:
    """``step.save_state`` (``trainer.fit``'s checkpoint: its gathers and
    its file's bytes, made leaf by leaf as ever) timed, with the card
    memory it takes beyond the state already held: the peak allocated
    during the save less what was allocated before it. The file goes to
    a ``_Sink``, not the disk (``checkpoint.save`` patched for the
    save): F1's AdamW state is 19.2 GB whole, and the machine's disk
    takes 45 GiB of writes a run."""

    def __init__(self, step, dev):
        self.save, self.dev, self.rec = step.save_state, dev, {}
        step.save_state = self

    def __call__(self, path, params, opt_state, n):
        from tpushare_torch.utils import checkpoint
        _sync(self.dev)
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
            before = torch.cuda.memory_allocated(self.dev)
        sink, save = _Sink(), checkpoint.save

        def to_sink(path, tree):
            checkpoint.write(sink, tree)
            return sink.n
        checkpoint.save = to_sink
        t0 = time.perf_counter()
        try:
            size = self.save(path, params, opt_state, n)
            _sync(self.dev)
        finally:
            checkpoint.save = save
        self.rec = {"s": time.perf_counter() - t0, "file_bytes": size}
        if cuda:
            self.rec["peak_over_state"] = (
                torch.cuda.max_memory_allocated(self.dev) - before)
        return size


def _whole_leaf_max(training, params, specs, mesh) -> int:
    """The bytes of the largest leaf a checkpoint of (params, AdamW
    moments) gathers whole: an f32 moment of the largest split param."""
    from tpushare_torch.parallel.mesh import mesh_layout
    from tpushare_torch.parallel.sharding import spec_axes, walk_specs
    sizes, _ = mesh_layout(mesh)
    split = walk_specs(params, specs, lambda t, spec: math.prod(
        training._whole_shape(t, spec, sizes)) * 4
        if spec_axes(spec) else 0)
    return max(training.tree_leaves(split))


def _f2(job, mesh, dev, wl) -> dict:
    """F2 on this rank: Mixtral's width over ep=2, each routing's
    gradient with the twin's routes replayed, then one SGD step."""
    from tpushare_torch.models import moe, training
    from tpushare_torch.parallel.mesh import axis_rank
    f2 = wl["f2"]
    r = axis_rank(mesh, "ep")
    out: Dict[str, object] = {}
    for name, rcfg in train_routings(f2["cfg"]):
        step = moe.make_spmd_train_step(rcfg, mesh, lr=TRAIN_LR)
        whole = moe.init_params(torch.Generator(device=dev).manual_seed(22),
                                rcfg, device=dev)
        params = step.shard(whole)
        del whole
        _free(dev)
        routes = torch.load(os.path.join(job["tmp"], f"f2_{name}_routes.pt"))
        if name == "a2a":          # this rank's row of the twin's batch
            routes = [t[r:r + 1] for t in routes]
        tokens = torch.as_tensor(np.asarray(f2[name]), device=dev)
        zero_launches()
        t0 = time.perf_counter()
        with RouteLog(moe, replay=routes) as log, ReduceClock(dev) as clock:
            loss, grads = step.loss_and_grads(params, tokens)
            _sync(dev)
        rec = {"grad_s": time.perf_counter() - t0, "reduce_s": clock.s,
               "launches": read_launches(), "loss": float(loss),
               "route_flips": log.flips,
               "routed": sum(int(t.numel()) for t in routes)}
        t0 = time.perf_counter()
        rec["grad_rel_l2"] = compare_slices(
            os.path.join(job["tmp"], f"f2_{name}"), grads, step.specs, mesh)
        rec["compare_s"] = time.perf_counter() - t0
        training._sgd_update(params, grads, TRAIN_LR)
        rec["finite"] = all(bool(torch.isfinite(t).all())
                            for t in training.tree_leaves(params))
        rec["digests_equal"] = _digests_equal(training, params, step.specs,
                                              mesh)
        rec["memory"] = _memory(dev)
        out[name] = rec
        del params, grads
        _free(dev)
    return out


def _f3(job, dev, wl) -> dict:
    """F3 on this rank: Llama-3-8B's width at F3_LAYERS layers over
    sp=2 x tp=2 (ring attention) and pp=2 x tp=2 (1F1B), each a
    gradient against the twin and one SGD step."""
    from tpushare_torch.models import pipeline as pl
    from tpushare_torch.models import training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.parallel.sharding import shard_tree
    f3 = wl["f3"]
    cfg = f3["cfg"]
    out: Dict[str, object] = {}
    for name, sizes in (("sp", {"sp": 2, "tp": 2}), ("pp", {"pp": 2,
                                                             "tp": 2})):
        mesh = make_mesh(sizes)
        tokens = torch.as_tensor(np.asarray(f3[name]), device=dev)
        whole = tt.init_params(torch.Generator(device=dev).manual_seed(23),
                               cfg, device=dev)
        if name == "sp":
            step = training.make_spmd_train_step(cfg, mesh, lr=TRAIN_LR)
            specs = step.specs

            def grad_fn(p):
                return step.loss_and_grads(p, tokens)
        else:
            specs = pl.param_specs(cfg)

            def grad_fn(p):
                return pl.pp_loss_and_grads(p, tokens, cfg, mesh,
                                            schedule="1f1b",
                                            n_microbatches=F3_PP_M)
        params = shard_tree(whole, specs, mesh)
        del whole
        _free(dev)
        zero_launches()
        t0 = time.perf_counter()
        with ReduceClock(dev) as clock:
            loss, grads = grad_fn(params)
            _sync(dev)
        rec = {"grad_s": time.perf_counter() - t0, "reduce_s": clock.s,
               "launches": read_launches(), "loss": float(loss)}
        t0 = time.perf_counter()
        rec["grad_rel_l2"] = compare_slices(
            os.path.join(job["tmp"], f"f3_{name}"), grads, specs, mesh)
        rec["compare_s"] = time.perf_counter() - t0
        training._sgd_update(params, grads, TRAIN_LR)
        rec["finite"] = all(bool(torch.isfinite(t).all())
                            for t in training.tree_leaves(params))
        rec["memory"] = _memory(dev)
        out[name] = rec
        del params, grads
        _free(dev)
    return out


class ReduceClock:
    """The host seconds (device synced on both sides) of every call to
    the steps' gradient averaging over the data axes
    (``training._mesh_mean``) and the pipelines' (``pipeline
    .reduce_grads``), patched for the with-block: where the collectives
    of a step go, beside its tp collectives inside the backward."""

    def __init__(self, dev):
        self.dev, self.s = dev, 0.0

    def wrap(self, fn):
        def timed(*a, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(self.dev)
            self.s += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        from tpushare_torch.models import pipeline, training
        self.saved = [(training, "_mesh_mean", training._mesh_mean),
                      (pipeline, "reduce_grads", pipeline.reduce_grads)]
        for mod, name, fn in self.saved:
            setattr(mod, name, self.wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def train_rank_main(args) -> None:
    """One rank of a part F group, started before the twins run: imports,
    then waits for its group's go file (holding no memory of the card),
    joins the group's gloo mesh, runs its part and writes its record."""
    with open(args.job) as f:
        job = json.load(f)
    r = args.rank
    dev = torch.device("cpu")
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    import datetime
    from tpushare_torch.models import moe, pipeline, training  # noqa: F401
    from tpushare_torch.parallel.mesh import make_mesh
    go = os.path.join(job["tmp"], f"{job['part']}_go")
    while not os.path.exists(go):
        time.sleep(0.05)
    world = int(np.prod(list(job["mesh"].values())))
    torch.distributed.init_process_group(
        "gloo", init_method=job["dist_init"], rank=r, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    wl = train_workload(job["tiny"])
    t0 = time.perf_counter()
    if job["part"] == "f3":
        rec = _f3(job, dev, wl)
    else:
        mesh = make_mesh(job["mesh"])
        rec = (_f1 if job["part"] == "f1" else _f2)(job, mesh, dev, wl)
    rec["seconds"] = time.perf_counter() - t0
    with open(os.path.join(job["tmp"], f"{job['part']}_rank{r}.json"),
              "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _start_group(args, tmp: str, part: str, sizes: dict) -> List:
    """Start one part F group's rank processes; they wait for the
    group's go file (``_finish_group``)."""
    from tpushare_torch.tools.binpack import child_env, free_port
    world = int(np.prod(list(sizes.values())))
    job = {"device": args.device, "tiny": args.tiny, "part": part,
           "mesh": sizes, "tmp": tmp,
           "dist_init": f"tcp://127.0.0.1:{free_port()}"}
    path = os.path.join(tmp, f"{part}_job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = child_env()
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        with open(os.path.join(tmp, f"{part}_rank{r}.log"), "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpushare_torch.tools.multichip",
                 "--train-worker", "--job", path, "--rank", str(r)],
                env=env, stdout=lf, stderr=lf, text=True))
    return procs


def _finish_group(tmp: str, part: str, procs) -> List[dict]:
    """Let one started group go, wait for its ranks to end; their
    records."""
    with open(os.path.join(tmp, f"{part}_go"), "w"):
        pass
    try:
        for p in procs:
            p.wait(INIT_TIMEOUT_S)
    finally:
        _stop(procs)
    recs = []
    for r in range(len(procs)):
        fp = os.path.join(tmp, f"{part}_rank{r}.json")
        if not os.path.exists(fp):
            with open(os.path.join(tmp, f"{part}_rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"part {part} rank {r} wrote no record (rc "
                               f"{[p.returncode for p in procs]}): {tail}")
        with open(fp) as f:
            recs.append(json.load(f))
    return recs


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _grad_gate(failures, what, rel: Dict[str, float]) -> float:
    worst = max(rel.values())
    if not worst <= GRAD_REL_L2_TOL:
        bad = {k: v for k, v in rel.items() if not v <= GRAD_REL_L2_TOL}
        failures.append(f"{what}: gradient slices vs the twin's {bad}")
    return worst


def train_gates(twin: dict, f1: List[dict], f2: List[dict], f3: List[dict],
                cuda: bool) -> dict:
    """Part F's readings and failures. ``cuda``: the launch gates (on
    the CPU no kernel runs)."""
    failures: List[str] = []
    out: Dict[str, object] = {}
    # F1
    worst = max(_grad_gate(failures, f"F1 rank {i}", rk["grad_rel_l2"])
                for i, rk in enumerate(f1))
    want = [twin["f1"]["loss"], twin["f1"]["loss_after_step"]]
    for i, rk in enumerate(f1):
        if any(not abs(a - b) <= F_LOSS_TOL for a, b in zip(rk["losses"],
                                                            want)):
            failures.append(f"F1 rank {i}: losses {rk['losses']} vs the "
                            f"twin's {want}")
        if not rk["digests_equal"]:
            failures.append(f"F1 rank {i}: replicated leaves differ across "
                            f"tp")
        ad = rk["adamw"]
        if not (all(math.isfinite(x) for x in ad["losses"])
                and ad["losses"][-1] < ad["losses"][0]):
            failures.append(f"F1 rank {i}: AdamW losses {ad['losses']} did "
                            f"not fall")
        if ad["moment_bytes"] != 2 * 4 * ad["slice_params"]:
            failures.append(f"F1 rank {i}: moments of {ad['moment_bytes']} "
                            f"bytes are not two f32 copies of its "
                            f"{ad['slice_params']} sliced params")
        ck = ad["ckpt"]
        # The whole state: the params, two f32 moments, the count and
        # the step, and the header (under 1 MiB).
        whole = ad["whole_param_bytes"] + ad["whole_params"] * 2 * 4 + 8
        if i == 0 and not 0 < ck.get("file_bytes", 0) - whole < 1 << 20:
            failures.append(f"F1: the AdamW checkpoint holds "
                            f"{ck.get('file_bytes')} bytes, not the whole "
                            f"state's {whole}")
        # A save gathers one leaf at a time: its parts and their
        # concatenation, two whole leaves at the most.
        if cuda and not ck["peak_over_state"] <= 2 * ck["whole_leaf_max"]:
            failures.append(f"F1 rank {i}: the checkpoint took "
                            f"{ck['peak_over_state']} bytes of the card "
                            f"beyond the state, over two whole leaves "
                            f"({ck['whole_leaf_max']} bytes each)")
    out["f1"] = {"grad_rel_l2_max": worst, "twin_losses": want,
                 "losses": [rk["losses"] for rk in f1]}
    # F2
    for name in ("psum", "a2a"):
        worst = max(_grad_gate(failures, f"F2 {name} rank {i}",
                               rk[name]["grad_rel_l2"])
                    for i, rk in enumerate(f2))
        for i, rk in enumerate(f2):
            if not (rk[name]["finite"] and rk[name]["digests_equal"]):
                failures.append(f"F2 {name} rank {i}: a step left non-finite "
                                f"or unequal replicated leaves")
        losses = [rk[name]["loss"] for rk in f2]
        if not abs(losses[0] - twin[f"f2_{name}"]["loss"]) <= F_LOSS_TOL:
            failures.append(f"F2 {name}: loss {losses} vs the twin's "
                            f"{twin[f'f2_{name}']['loss']}")
        out[f"f2_{name}"] = {"grad_rel_l2_max": worst, "losses": losses,
                             "route_flips": [rk[name]["route_flips"]
                                             for rk in f2],
                             "routed": f2[0][name]["routed"]}
    # F3
    for name in ("sp", "pp"):
        worst = max(_grad_gate(failures, f"F3 {name} rank {i}",
                               rk[name]["grad_rel_l2"])
                    for i, rk in enumerate(f3))
        losses = [rk[name]["loss"] for rk in f3]
        if not abs(losses[0] - twin[f"f3_{name}"]["loss"]) <= F_LOSS_TOL:
            failures.append(f"F3 {name}: loss {losses} vs the twin's "
                            f"{twin[f'f3_{name}']['loss']}")
        if not all(rk[name]["finite"] for rk in f3):
            failures.append(f"F3 {name}: the SGD step left non-finite params")
        out[f"f3_{name}"] = {"grad_rel_l2_max": worst, "losses": losses}
    launches = {"f1": _sum([rk["launches"] for rk in f1]),
                **{f"f2_{n}": _sum([rk[n]["launches"] for rk in f2])
                   for n in ("psum", "a2a")},
                **{f"f3_{n}": _sum([rk[n]["launches"] for rk in f3])
                   for n in ("sp", "pp")}}
    if cuda:
        for part, names in TRAIN_NEEDS.items():
            for n in names:
                if launches[part].get(n, 0) <= 0:
                    failures.append(f"F {part}: {n} was not launched on its "
                                    f"ranks ({launches[part]})")
    out["launches"] = launches
    out["failures"] = failures
    return out


# The kernels each part F group must launch on its ranks. The SPMD
# steps attend through ring attention over sp at every sp size, one hop
# at sp 1, as the reference's do (a ParallelCtx naming sp); the
# pipeline's stages take the prefill kernel at sp 1.
TRAIN_NEEDS = {"f1": ("flash_attention_partial", "flash_attention_bwd"),
               "f2_psum": ("flash_attention_partial", "flash_attention_bwd"),
               "f2_a2a": ("flash_attention_partial", "flash_attention_bwd"),
               "f3_sp": ("flash_attention_partial", "flash_attention_bwd"),
               "f3_pp": ("flash_attention", "flash_attention_bwd")}


def run_train(args, log=print) -> dict:
    """Part F: the one-card twins, then each rank group in turn; the
    record, with every gate's failures and each stage's seconds."""
    t_all = time.perf_counter()
    wl = train_workload(args.tiny)
    rec: Dict[str, object] = {}
    with tempfile.TemporaryDirectory(prefix="multichip-train-") as tmp:
        # Every group's ranks start now and wait: their imports and the
        # card's contexts overlap the twins.
        started = {part: _start_group(args, tmp, part, sizes)
                   for part, sizes in F_GROUPS}
        try:
            t0 = time.perf_counter()
            twin = train_twins(args, tmp, wl)
            rec["twin_s"] = time.perf_counter() - t0
            groups = {}
            for part, _ in F_GROUPS:
                t0 = time.perf_counter()
                groups[part] = _finish_group(tmp, part, started[part])
                rec[f"{part}_s"] = time.perf_counter() - t0
        finally:
            for procs in started.values():
                _stop(procs)
    g = train_gates(twin, groups["f1"], groups["f2"], groups["f3"],
                    args.device == "cuda")
    rec.update(g, twin=twin, ranks={k: [{kk: vv for kk, vv in rk.items()
                                         if "grad_rel_l2" not in kk}
                                        for rk in v]
                                    for k, v in groups.items()},
               grad_rel_l2={k: [rk.get("grad_rel_l2") or {
                   n: rk[n]["grad_rel_l2"] for n in rk
                   if isinstance(rk[n], dict) and "grad_rel_l2" in rk[n]}
                   for rk in v] for k, v in groups.items()},
               seconds=time.perf_counter() - t_all)
    log(json.dumps({"part": "F", **{k: v for k, v in rec.items()
                                    if k != "grad_rel_l2"}}, default=str))
    return rec


def run(args, log=print, before_kill=None) -> dict:
    """Parts A to E and D; the record, with every gate's failures.
    ``before_kill`` (optional) is called once B and C's rank processes
    are gone, just before E's process case starts (a caller starts
    work there that fits beside it on the card)."""
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
        if before_kill is not None:
            before_kill()
        record["E_kill"] = elastic_kill(args, tmp, llama, twin)
        log(json.dumps({"part": "E_kill", **record["E_kill"]}))
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
    record["failures"] = [f"{p}: {f}" for p in ("A", "BC", "E_kill", "D")
                          for f in record[p]["failures"]]
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--part", choices=("serve", "train"), default="serve",
                    help="serve: parts A-E and D (BASELINE row 5); train: "
                         "part F")
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-worker", action="store_true",
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
    if args.train_worker:
        train_rank_main(args)
        return 0
    if args.small_tenant:
        small_main(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multichip: no CUDA card (pass --device cpu for the host "
              "run)", file=sys.stderr)
        return 2
    if args.part == "train":
        record = run_train(args)
    else:
        record = run(args)
        print(json.dumps(record, default=str))
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
