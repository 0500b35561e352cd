"""The LoRA tenant lifecycle on one card: fine-tune, checkpoint, preempt
and resume, then serve every tenant from one engine. The port's
counterpart of ``demo/e2e_finetune_serve.py``. Run from the repository
root:

    python -m tpushare_torch.tools.finetune_serve            # Gemma-2B, card
    python -m tpushare_torch.tools.finetune_serve --device cpu --tiny

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Prints one JSON line per stage, then the record.

1. Each of two tenants fine-tunes rank-``--rank`` adapters on ``wq`` and
   ``wv`` of one frozen base through ``lora.make_lora_fit_step`` and
   ``trainer.fit``. Its data is ``utils/data.py``'s ``token_batches``
   over a seeded token file: blocks of one random token followed by
   seven of the tenant's target, so the adapter learns "after anything,
   the target".
2. Tenant B is preempted halfway: its run checkpoints at step
   ``steps // 2``, its state is dropped, and it resumes from
   ``latest_checkpoint`` with the stream positioned at the saved step.
   The result must equal an uninterrupted run leaf for leaf, bit for
   bit (``torch.equal``).
3. Both tenants' final adapters are read back from disk
   (``trainer.load_state``), stacked into a bank, and served with the
   base from one ``ServeEngine`` over HTTP, each prompted with the
   first block of its corpus and the next random token: each tenant's
   completion must hold its target at least 3 times in 4 tokens, and
   the base's (prompted as tenant A) must not.

``--tiny`` is the demo's config (``transformer.tiny()``, rank 4, 40
steps of 4 x 10 tokens at lr 0.3); without it, Gemma-2B at full width
and depth (rank 16, 20 steps of 4 x 1024 tokens at lr 0.3).
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from tpushare_torch.cli import serve as serve_mod
from tpushare_torch.models import lora, trainer
from tpushare_torch.models import transformer as tt
from tpushare_torch.models.training import tree_leaves, tree_map
from tpushare_torch.utils import data as dpipe

# name -> (target token, seed), as in the demo.
TENANTS = {"a": (7, 11), "b": (42, 13)}
SERVE_TOKENS = 4
TARGET_MIN = 3                     # of SERVE_TOKENS, the demo's gate
TOKEN_DTYPE = np.uint32            # Gemma's vocabulary passes uint16's
CORPUS_WINDOWS = 64
BASE_SEED = 0                      # the base weights' generator
BLOCK = 8                          # corpus tokens per random head


def write_corpus(path: str, cfg, target: int, seed: int, seq: int) -> int:
    """A token file of blocks of BLOCK tokens, each a seeded random token
    followed by ``target``, enough for CORPUS_WINDOWS windows of seq + 1
    tokens. A random token precedes the target at every BLOCK-th
    position, so no window can be fitted by "the target follows the
    target" alone: the adapter must learn "after anything, the target".
    Returns the served prompt: the corpus's first BLOCK + 1 tokens, one
    block and the next random head (a random head at position 0 has no
    context, and a full-length window holds one such position in
    ``seq``, too few to learn from)."""
    rng = np.random.default_rng(seed)
    n = CORPUS_WINDOWS * seq + 1
    blocks = np.full((-(-n // BLOCK), BLOCK), target, TOKEN_DTYPE)
    blocks[:, 0] = rng.integers(0, cfg.vocab_size, blocks.shape[0])
    flat = blocks.reshape(-1)[:n]
    flat.tofile(path)
    return [int(t) for t in flat[:BLOCK + 1]]


def device_batches(tokens, dev, **kw) -> Iterator[torch.Tensor]:
    """``token_batches`` moved to ``dev`` one batch at a time."""
    for b in dpipe.token_batches(tokens, **kw):
        yield torch.from_numpy(b).to(dev)


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """A fit step that records each call's wall ms (device synced)."""

    def __init__(self, step, dev):
        self.step, self.dev, self.ms = step, dev, []

    def __call__(self, adapters, opt_state, tokens):
        t0 = time.perf_counter()
        out = self.step(adapters, opt_state, tokens)
        _sync(self.dev)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _post(port: int, body: Dict[str, Any]) -> Dict[str, Any]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        if resp.status != 200:
            raise RuntimeError(f"completion answered {resp.status}: {out}")
        return out
    finally:
        conn.close()


def config(tiny: bool):
    """(model config, fit settings) of the run."""
    if tiny:
        return tt.tiny(remat=False), dict(rank=4, steps=40, batch=4, seq=10,
                                          lr=0.3)
    return tt.gemma_2b(), dict(rank=16, steps=20, batch=4, seq=1024, lr=0.3)


def train(base, cfg, fit_kw: Dict[str, Any], workdir: str, dev,
          log=print) -> Dict[str, Any]:
    """Stages 1 and 2: both tenants' fits, B's preemption and resume.
    Returns the record: losses, step ms, the checkpoint's bytes and its
    save / restore seconds, resume equality, and each tenant's final
    checkpoint and prompt."""
    steps, half = fit_kw["steps"], fit_kw["steps"] // 2
    batch, seq = fit_kw["batch"], fit_kw["seq"]
    step_fn = lora.make_lora_fit_step(base, cfg, lr=fit_kw["lr"])
    rec: Dict[str, Any] = {"tenants": {}}
    for name, (target, seed) in TENANTS.items():
        corpus_path = os.path.join(workdir, f"corpus_{name}.bin")
        prompt = write_corpus(corpus_path, cfg, target, seed, seq)
        tokens = dpipe.load_tokens(corpus_path, dtype=TOKEN_DTYPE)
        data_kw = dict(batch_size=batch, seq_len=seq, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        adapters0 = lora.init_lora(gen, cfg, fit_kw["rank"])
        ckpt = os.path.join(workdir, name)
        timer = StepTimer(step_fn, dev)
        t = {"target": target, "prompt": prompt, "ckpt_dir": ckpt}
        if name == "a":
            _, _, losses = trainer.fit(
                timer, clone(adapters0), {},
                device_batches(tokens, dev, **data_kw), steps=steps,
                ckpt_dir=ckpt, ckpt_every=steps, log_every=0)
        else:
            # Uninterrupted, then the preemption drill from the same
            # initial adapters (the steps update them in place).
            want, _, losses = trainer.fit(
                timer, clone(adapters0), {},
                device_batches(tokens, dev, **data_kw), steps=steps,
                log_every=0)
            part, _, first = trainer.fit(
                timer, clone(adapters0), {},
                device_batches(tokens, dev, **data_kw), steps=half,
                ckpt_dir=ckpt, ckpt_every=half, log_every=0)
            # The save alone, timed: the same state into a second file.
            _sync(dev)
            t0 = time.perf_counter()
            nbytes = trainer.save_state(os.path.join(workdir, "b_timed"),
                                        part, {}, half)
            t["ckpt_save_s"] = time.perf_counter() - t0
            t["ckpt_bytes"] = nbytes
            del part, first
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            path = trainer.latest_checkpoint(ckpt)
            t0 = time.perf_counter()
            resumed, _, start = trainer.load_state(
                path, like_params=adapters0, like_opt={})
            _sync(dev)
            t["ckpt_restore_s"] = time.perf_counter() - t0
            t["preempted_at"] = start
            log(json.dumps({"stage": "preempted", "tenant": name,
                            "checkpoint": os.path.basename(path),
                            "step": start}))
            got, _, _ = trainer.fit(
                timer, resumed, {},
                device_batches(tokens, dev, start_step=start, **data_kw),
                steps=steps, start_step=start, ckpt_dir=ckpt,
                ckpt_every=steps, log_every=0)
            t["resume_equal"] = all(
                torch.equal(x, y) for x, y in zip(tree_leaves(got),
                                                   tree_leaves(want)))
            del want, got, resumed
        t["losses"] = [float(x) for x in losses]
        t["step_ms"] = timer.ms
        t["final_ckpt"] = os.path.join(ckpt, f"step_{steps}")
        rec["tenants"][name] = t
        log(json.dumps({"stage": "trained", "tenant": name,
                        "loss_first": t["losses"][0],
                        "loss_last": t["losses"][-1],
                        **({"resume_equal": t["resume_equal"]}
                           if "resume_equal" in t else {})}))
    ms = sorted(m for t in rec["tenants"].values() for m in t["step_ms"][1:])
    rec["step_ms_median"] = ms[len(ms) // 2]
    rec["train_tok_s"] = batch * seq / (rec["step_ms_median"] / 1e3)
    return rec


def serve_tenants(base, cfg, rec: Dict[str, Any], fit_kw: Dict[str, Any],
                  dev, tiny: bool, log=print) -> Dict[str, Any]:
    """Stage 3: the bank from disk, one engine over HTTP, a completion
    per tenant (its adapter) and one of the base."""
    gen = torch.Generator(device=dev).manual_seed(0)
    like = lora.init_lora(gen, cfg, fit_kw["rank"])
    tenants = rec["tenants"]
    bank = lora.stack_adapters([
        trainer.load_state(tenants[n]["final_ckpt"], like_params=like,
                           like_opt={})[0] for n in ("a", "b")])
    kw = (dict(n_blocks=32, block_size=8, max_blocks_per_slot=4) if tiny
          else dict(n_blocks=64, block_size=16, max_blocks_per_slot=4))
    engine = serve_mod.ServeEngine(base, cfg, n_slots=3, multi_lora=bank,
                                   idle_sleep_s=0.001, device=dev, **kw)
    httpd = serve_mod.serve(engine, host="127.0.0.1", port=0,
                            timeout_s=600.0)
    port = httpd.server_address[1]
    out: Dict[str, Any] = {}
    try:
        w0 = engine.stats()["work_ticks"]
        t0 = time.perf_counter()
        for key, prompt, adapter in (
                ("a", tenants["a"]["prompt"], 0),
                ("b", tenants["b"]["prompt"], 1),
                ("base", tenants["a"]["prompt"], None)):
            body = {"prompt": prompt, "max_tokens": SERVE_TOKENS}
            if adapter is not None:
                body["adapter"] = adapter
            out[key] = _post(port, body)["tokens"]
        wall = time.perf_counter() - t0
        ticks = engine.stats()["work_ticks"] - w0
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    served = {"tokens": out, "ticks": ticks,
              "ms_per_tick": wall / max(ticks, 1) * 1e3}
    log(json.dumps({"stage": "served", **served}))
    return served


def check(rec: Dict[str, Any]) -> List[str]:
    """The demo's assertions, as a list of failures (empty: all held)."""
    bad = []
    tenants, toks = rec["tenants"], rec["served"]["tokens"]
    for name, (target, _) in TENANTS.items():
        if toks[name].count(target) < TARGET_MIN:
            bad.append(f"tenant {name}'s completion {toks[name]} holds its "
                       f"target {target} fewer than {TARGET_MIN} times")
        if toks["base"].count(target) >= TARGET_MIN:
            bad.append(f"the base's completion {toks['base']} follows "
                       f"tenant {name}'s adapter")
        losses = tenants[name]["losses"]
        if not losses[-1] < losses[0]:
            bad.append(f"tenant {name}'s loss did not fall: {losses}")
    if not tenants["b"].get("resume_equal"):
        bad.append("tenant b's resumed adapters differ from the "
                   "uninterrupted run's")
    return bad


def run(args, log=print) -> Dict[str, Any]:
    """The whole lifecycle; the record holds every reading and
    ``failures`` (the gates that did not hold)."""
    dev = torch.device(args.device)
    cfg, fit_kw = config(args.tiny)
    gen = torch.Generator(device=dev).manual_seed(BASE_SEED)
    base = tt.init_params(gen, cfg, device=dev)
    workdir = args.workdir or tempfile.mkdtemp(prefix="tpushare-lora-")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"model": "tiny" if args.tiny else "gemma_2b", **fit_kw,
           "workdir": workdir}
    rec.update(train(base, cfg, fit_kw, workdir, dev, log))
    if dev.type == "cuda":
        rec["train_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    rec["served"] = serve_tenants(base, cfg, rec, fit_kw, dev, args.tiny,
                                  log)
    rec["failures"] = check(rec)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the demo's tiny f32 config (CPU runs)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and corpora (default: a new "
                         "temporary directory)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("finetune_serve: no CUDA card; run on an NVIDIA GPU or pass "
              "--device cpu", file=sys.stderr)
        return 2
    rec = run(args, log=lambda s: print(s, flush=True))
    print(json.dumps(rec), flush=True)
    for f in rec["failures"]:
        print(f"finetune_serve: {f}", file=sys.stderr)
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
