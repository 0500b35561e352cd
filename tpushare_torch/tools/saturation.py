"""BASELINE.md's saturation row on the port: four ResNet-50 eval pods of
4 GiB each. The counterpart of ``demo/e2e_saturation.py``. Run from the
repository root:

    python -m tpushare_torch.tools.saturation                 # on the card
    python -m tpushare_torch.tools.saturation --device cpu --tiny

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Prints one JSON line per part, then the record;
exits 1 when a gate fails.

- A. Placement, hardware-free as the reference's: a fake host of four
  16 GiB cards (``FakeBackend``), the port's device plugin serving it on
  a unix socket to a kubelet simulator, an apiserver stub and the
  extender's bind verb (``tools/binpack.py``'s pieces, in this process).
  Four eval pods ask for 4 units each with the ``spread`` placement
  annotation (``plugin/const.py``'s ``ANN_PLACEMENT_POLICY``), so each
  lands on its own card; ``Allocate`` names that card in each pod's
  env. ``hbm_binpack_pct`` = allocated / advertised units, overall and
  per card, as the demo prints it. Gates: one pod per card, 4 units on
  each, the envs cover the four cards.
- B. The tenants on the one card. The node is NVML's (``--device cpu``:
  ``tools/colocate.py``'s one-card fake of 128 MiB granted in MiB);
  each pod's env is the single-card Allocate's for a 4-unit grant.
  A tenant (a new interpreter) calls ``apply_tenant_limits()`` before
  any CUDA use, builds ResNet-50 in bf16 from seed 0 (``--tiny``: the
  f32 tiny config), and runs blocked forwards of one 64 x 224 x 224 x 3
  batch (``--tiny``: 2 x 64 x 64 x 3) through a timed window. It
  reports images/s, its peak ``memory_reserved`` against its grant, its
  guard's breaches, and its logits' distance from an f32 twin of the
  same weights and batch (run after the window, 8 images at a time).
  One tenant solo, then all four at once; ``four_over_solo`` = the four
  tenants' summed images/s over the solo rate, and the card's bin-pack
  % over the units its daemon would advertise (one per GiB). Gates:
  every tenant's logits finite and within ``LOGIT_REL_TOL`` of its f32
  twin, peak reserved within the grant, no guard breach.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import torch

from tpushare_torch.models import resnet
from tpushare_torch.tools.binpack import (NAMESPACE, NODE, Apiserver,
                                          KubeletSim, child_env,
                                          write_kubeconfig)
from tpushare_torch.tools.colocate import (INIT_TIMEOUT_S, _barrier,
                                           _expect, _memory, _pin_cpus,
                                           _send, _sync, _window, node,
                                           plugin_env)
from tpushare_torch.utils.tenant import (apply_tenant_limits,
                                         get_enforcing_guard, tenant_device)

RESULT_TAG = "SATURATION_RESULT "
PODS = 4
POD_UNITS = 4                        # 4 GiB each (BASELINE row 4)
FAKE_CARDS, FAKE_CARD_GIB = 4, 16    # the reference's v5e-4 host shape
TWIN_CHUNK = 8                       # images per f32-twin forward
#: max |bf16 logits - f32 logits| / max |f32 logits| of one batch: 53
#: bf16 convolutions (f32 sums, bf16 out) with folded BN of scale 1, the
#: activations growing through the residual stream. The full model's
#: forward on the host (PyTorch's bf16 CPU convolutions) reads ~0.01 at
#: 2 x 224 x 224; the limit is 5x that.
LOGIT_REL_TOL = 5e-2


def _geometry(tiny: bool):
    """(config, batch, image side)."""
    return (resnet.tiny(), 2, 64) if tiny else (resnet.resnet50(), 64, 224)


# -- A: placement on a fake four-card host ----------------------------------

def place(tmp: str) -> dict:
    """Part A: returns its record (``failures`` listed in it)."""
    from tpushare_torch.extender.server import ExtenderService
    from tpushare_torch.k8s.client import KubeClient, load_config
    from tpushare_torch.plugin import const
    from tpushare_torch.plugin.allocate import Allocator
    from tpushare_torch.plugin.backend import FakeBackend
    from tpushare_torch.plugin.capacity import chip_free, node_total_mem
    from tpushare_torch.plugin.devices import expand_devices
    from tpushare_torch.plugin.podmanager import PodManager
    from tpushare_torch.plugin.server import TpuDevicePlugin

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
    try:
        plugin.serve()
        devices = kubelet.watch()
        with api.lock:           # the daemon publishes the card count
            for key in ("capacity", "allocatable"):
                api.nodes[NODE]["status"][key][const.RESOURCE_COUNT] = \
                    FAKE_CARDS
        names = [f"eval-{i}" for i in range(PODS)]
        for n in names:
            pod = api.add_pod(n, "resnet50", POD_UNITS)
            pod["metadata"]["annotations"][const.ANN_PLACEMENT_POLICY] = \
                const.PLACEMENT_SPREAD
        ext = ExtenderService(kube)
        binds = {n: ext.bind({"PodName": n, "PodNamespace": NAMESPACE,
                              "Node": NODE})["Error"] for n in names}
        with api.lock:
            cards = {n: api.pod(NAMESPACE, n)["metadata"]["annotations"].get(
                const.ANN_RESOURCE_INDEX) for n in names}
        envs = {}
        for i, n in enumerate(names):
            resp, _ = kubelet.allocate(devices[i * POD_UNITS:
                                               (i + 1) * POD_UNITS])
            envs[n] = dict(resp.envs)
        node_obj = kube.get_node(NODE)
        free = chip_free(node_obj, kube.list_pods())
        total = node_total_mem(node_obj)
        used = total - sum(free.values())
        per_card = {i: FAKE_CARD_GIB - f for i, f in sorted(free.items())}
    finally:
        plugin.stop()
        kubelet.close()
        api.close()
    visible = sorted(e.get(const.ENV_NVIDIA_VISIBLE_DEVICES, "")
                     for e in envs.values())
    if any(binds.values()):
        failures.append(f"bind errors {binds}")
    if sorted(map(str, cards.values())) != [str(i)
                                            for i in range(FAKE_CARDS)]:
        failures.append(f"pods not one per card: {cards}")
    if used != PODS * POD_UNITS or \
            any(u != POD_UNITS for u in per_card.values()):
        failures.append(f"units per card {per_card}, want {POD_UNITS} each")
    if visible != [str(i) for i in range(FAKE_CARDS)]:
        failures.append(f"tenant envs name cards {visible}")
    return {"advertised_devices": len(devices), "cards": cards,
            "visible_devices": visible, "units_used": used,
            "units_total": total, "units_per_card": per_card,
            "hbm_binpack_pct": 100.0 * used / total,
            "hbm_limit_bytes": sorted({e.get("TPUSHARE_HBM_LIMIT_BYTES")
                                       for e in envs.values()}),
            "failures": failures}


# -- B: a tenant process ------------------------------------------------------

def tenant_main(args) -> None:
    """One eval pod: the injected env first, then a window of blocked
    forwards around the parent's T0, then the f32 twin."""
    cores = _pin_cpus(args.stream)
    spec = apply_tenant_limits()                     # before any CUDA use
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = tenant_device() if args.device == "cuda" else torch.device("cpu")
    cfg, batch, side = _geometry(args.tiny)
    params = resnet.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    images = torch.randn((batch, side, side, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    @torch.inference_mode()
    def serve():
        resnet.forward(params, images, cfg)
        _sync(dev)

    serve()
    t0 = _barrier(serve)
    calls, secs = _window(serve, t0, args.seconds)
    guard = get_enforcing_guard()
    memory = _memory(dev, spec)            # the serving footprint
    with torch.inference_mode():
        logits = resnet.forward(params, images, cfg)
        cfg32 = resnet.ResNetConfig(cfg.stages, cfg.n_classes,
                                    cfg.stem_channels, torch.float32)
        p32 = _to_f32(params)
        want = torch.cat([resnet.forward(p32, images[i:i + TWIN_CHUNK],
                                         cfg32)
                          for i in range(0, batch, TWIN_CHUNK)])
    result = {
        "stream": args.stream, "cores": cores,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "batch": batch, "image": [side, side, 3], "calls": calls,
        "seconds": secs, "images_per_sec": calls * batch / secs,
        "hbm_breaches": guard.breaches if guard else 0,
        "hbm_limit_bytes": spec.hbm_limit_bytes,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "logit_rel_err": ((logits - want).abs().max()
                          / want.abs().max()).item(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        **memory,
    }
    print(RESULT_TAG + json.dumps(result), flush=True)


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


# -- B: the parent ----------------------------------------------------------------

def _spawn(env: dict, args, stream: int) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "tpushare_torch.tools.saturation",
           "--tenant", "--device", args.device, "--seconds",
           str(args.seconds), "--stream", str(stream)]
    if args.tiny:
        cmd.append("--tiny")
    return subprocess.Popen(cmd, env=child_env(env), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)


def _result(p: subprocess.Popen, timeout: float) -> dict:
    out, _ = p.communicate(timeout=timeout)
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"tenant exited rc={p.returncode} without a "
                           f"result: {out[-400:]!r}")
    return json.loads(lines[-1][len(RESULT_TAG):])


def run_tenants(envs: List[dict], args) -> List[dict]:
    """Start one tenant per env, hold them at one barrier, open their
    windows at one T0; their results."""
    procs = [_spawn(e, args, i) for i, e in enumerate(envs)]
    try:
        deadline = time.time() + INIT_TIMEOUT_S
        for p in procs:
            _expect(p, "READY", deadline)
        for p in procs:
            _send(p, "GO")
        for p in procs:
            _expect(p, "WARM", deadline)
        t0 = time.time() + 0.5
        for p in procs:
            _send(p, f"T0 {t0}")
        return [_result(p, INIT_TIMEOUT_S + args.seconds) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def tenants(args) -> dict:
    """Part B: solo, then four at once."""
    from tpushare_torch.plugin import const
    from tpushare_torch.plugin.devices import expand_devices
    topo, unit = node(args.device)
    advertised = sum(expand_devices(topo, unit).units_per_chip.values())
    envs = [plugin_env(topo, unit, POD_UNITS) for _ in range(PODS)]
    grant = int(envs[0][const.ENV_HBM_LIMIT_BYTES])
    solo = run_tenants(envs[:1], args)[0]
    four = run_tenants(envs, args)
    failures = []
    for name, r in [("solo", solo)] + [(f"tenant {i}", r)
                                        for i, r in enumerate(four)]:
        if not (r["logits_finite"] and r["logit_rel_err"] <= LOGIT_REL_TOL):
            failures.append(f"{name}: logits finite {r['logits_finite']}, "
                            f"rel err {r['logit_rel_err']} vs f32 twin "
                            f"(limit {LOGIT_REL_TOL})")
        if r["hbm_breaches"]:
            failures.append(f"{name}: {r['hbm_breaches']} guard breaches")
        peak = r.get("max_memory_reserved")
        if peak is not None and peak > grant:
            failures.append(f"{name}: peak reserved {peak} B over the "
                            f"grant {grant} B")
    total = sum(r["images_per_sec"] for r in four)
    return {"grant_bytes": grant, "units_advertised": advertised,
            "hbm_binpack_pct": 100.0 * PODS * POD_UNITS / advertised,
            "solo": solo, "four": four,
            "solo_images_per_sec": solo["images_per_sec"],
            "four_images_per_sec": [r["images_per_sec"] for r in four],
            "four_total_images_per_sec": total,
            "four_over_solo": total / solo["images_per_sec"],
            "failures": failures}


def run(args, log=print) -> dict:
    """Parts A and B; the record, with every gate's failures."""
    record: Dict[str, object] = {"device": args.device, "tiny": args.tiny}
    with tempfile.TemporaryDirectory(prefix="sat-") as tmp:
        record["A"] = place(tmp)
    log(json.dumps({"part": "A", **record["A"]}))
    record["B"] = tenants(args)
    log(json.dumps({"part": "B", **{k: v for k, v in record["B"].items()
                                    if k not in ("solo", "four")}}))
    record["failures"] = ([f"A: {f}" for f in record["A"]["failures"]]
                          + [f"B: {f}" for f in record["B"]["failures"]])
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--tenant", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--stream", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tenant:
        tenant_main(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("saturation: no CUDA card (pass --device cpu for the host "
              "run)", file=sys.stderr)
        return 2
    record = run(args)
    print(json.dumps(record))
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
