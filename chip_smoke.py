#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port
(tpushare_torch) still starts and serves on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each, each with its own seconds:

  env     torch/CUDA versions, the card's name and power limit.
  build   compiles every kernel of the main paths from tpushare_torch/csrc
          (one nvcc per source, started together: flash_prefill with its
          partial mode, flash_bwd, paged_decode, paged_verify,
          flash_decode, q8_expert) and times it.
  kernels each kernel against its plain PyTorch version on the card, at
          the shapes the two slices below launch: prefill at every
          admission shape (derived from the admission's padding rule,
          paged.admission_len) of both slices; decode, bf16 and int8
          pages, at the slices' positions; verify, bf16 and int8 pages,
          at the Llama slice's speculative round (Sq 5) and fused ticks
          (Sq = each chunk width), at Gemma-2B's GQA 8 / head_dim 256,
          and with a Gemma-2 window + softcap; prefill and the gradient
          at the fine-tuning and generation paths' shapes (batch
          included): generate's and speculation's S = 1 steps and
          gamma + 1 blocks at every scalar offset of their dense
          caches, their prefills and moe.generate's, the lifecycle's
          admission, the LoRA and Mixtral training forwards with their
          lse, and the gradient at the LoRA step's 4 x 1024 and the
          Mixtral step's 1 x 4096. Each case reports the
          kernel's time, the plain version's, the least time the card
          could take (bound) and a library route's (SDPA for prefill;
          for the paged kernels: gather the live pages into a dense
          view, dequantize int8, then SDPA with the boolean mask,
          timed together; where the case has a softcap, which SDPA
          lacks: flex_attention under torch.compile, timed in the flex
          phase below, and for flash_decode SDPA at the same shape
          without the softcap beside it, a stated proxy; the same for
          slice_train's global layer below). Planted
          faults must fail the same check: an off-by-one causal edge
          (prefill, verify), a dropped page (decode), two heads' scale
          pages swapped (int8). Beside each: the bf16 outputs the kernel
          rounded the other way from the plain version (flips); q8's
          two passes' device time. Decode cases must give equal bits on
          two launches, and add their split count, the device time of
          the split and merge kernels and a call's host time. Every
          kernel time is device time only: the stream is held in a
          device spin until the timed loop is enqueued (time_ms).
  slice   Gemma-2B at full width (random bf16 weights from a seeded
          generator) served by PagedSlotServer over the paged KV pool:
          8 prompts of 16..2048 tokens, 32 greedy decode ticks (then 4
          more under torch.profiler, CUDA activity only: device time by
          kernel and the card's idle share in that window), evict, then
          a second wave whose prompts hit the prefix cache, 8 ticks. A
          short untimed pass of the same workload on the plain path
          warms cuBLAS and the allocator first. A second server on the
          same weights with attn_impl="reference" checks the logits of
          every admission (both waves) and of each wave's first tick.
  slice_engine
          the serving engine (tpushare_torch/cli/serve.py) built by
          build_engine(build_parser().parse_args(argv)), the argv a pod
          runs, at Gemma-2B's full width and depth (8 slots), serving on
          127.0.0.1:0 over real HTTP; two engines in turn, each stopped
          and freed before the next. (A) greedy, overlapped tick: 8
          concurrent completions of 16..2048 tokens, 32 tokens each; two
          stream, an attached reader on one (same Idempotency-Key)
          drops after 8 events and resumes with ?from=8 (an owner's
          drop would cancel by contract); one is retried with its key;
          two share a 1024-token prefix. Each stream is held against a
          PagedSlotServer on the engine's weights driven directly: where
          two part, the direct run's top-two logit gap there must be
          within LOGIT_REL_TOL of its largest |logit| (a counted flip).
          /stats must show a prefix hit and one fetch per tick. (B)
          sampled speculation (int8-self, gamma 4, temperature 0.8,
          top-k 64, top-p 0.95, seed 0): the same 8 prompts enqueued in
          one fixed order before the engine starts, twice, on two
          engines: identical streams, every token in the vocabulary,
          an accept rate in (0, 1], one fetch per round. Each engine:
          ms per tick (round) with every slot decoding and a profiled
          16-tick window on the running engine, TTFT per request, the
          direct server's ms per tick beside A's, the sampler's device
          ms (greedy and sampled pick, a round's stochastic cores).
          Then the sampler's law: 2^16 draws per row of one seeded
          [8, 256128] logits tensor against softmax(filter_logits) on
          the CPU, by TV; a planted fault (no top-p mask) must fail.
          Every engine is stopped through stop_engine: the next one is
          built only when ServeEngine.live_threads() is empty. (C)
          multi-LoRA: engine A's argv, the engine given a bank of 4
          rank-16 adapters on wq and wv (A as lora.init_lora draws it,
          B drawn non-zero, one seeded generator); the 8 prompts posted
          at once with adapters [-1, 0, 1, 2, 3, -1, 0, 1]. Each stream
          is held against a PagedSlotServer over merge_lora(base,
          adapter) (the base for -1) by the A rule; the bank served
          directly keeps its logits within LOGIT_REL_TOL of each twin's
          largest |logit| up to where their streams part; one fetch per
          tick. Then engine A's window (8 fresh 64-token prompts, each
          with its adapter): ms per tick and a profile beside A's.
  slice_kv_economy
          the host KV tier, cross-replica migration and the router, at
          Gemma-2B's full width and depth (8 slots, 256 blocks of 16,
          --host-kv-bytes 2 GiB), engines built by build_engine(argv).
          (A) one tiered engine serves a 1124-token warm-up twice (cold,
          then a prefix hit: A's admission shapes), A (1124 tokens,
          recomputed), four 1480-token fillers whose admissions demote
          A's chain to the host tier, A again (promoted from host
          memory), four more fillers, a prefetch of A's chain (the
          overlapped tick's side-stream upload, called on the engine
          thread) and A a third time (promoted from the staged copy); an
          engine on the same argv without the tier (it never evicts)
          serves the warm-up twice and A three times (device prefix
          hits). One request at a time: the three A streams must equal
          the oracle's bit for bit, demotions and promotions > 0, each
          promoted admission reuses >= 1024 tokens, the prefetch's
          blocks are all taken, one fetch per tick; again with
          --kv-quant (int8 pages and their scale pages). (B)
          two tiered engines share the card behind the port's router on
          127.0.0.1:0; replica 0 serves 8 warm prompts sharing a
          1024-token prefix, drains, and 8 follow-ups on the prefix storm
          the router, which instructs replica 1 to pull the chain (POST
          /kv/migrate from replica 0's GET /kv/blocks): every answer a
          200 equal to an untiered engine that served the same warm
          prompts and follow-ups, or a clean 503; the router's
          migrations and migrated blocks > 0, replica 1's migrations_in
          and promotions > 0, its fetches per tick <= 1; then the pull
          the router would instruct for a second chain replica 0 holds,
          posted to replica 1 once its rates are measured (its decision
          is printed, not gated). Printed: bytes
          per channel (d2h, h2d, net), the crossover estimator's
          measured rates and decisions, the TTFT of the promoted and the
          recomputed admission, nvidia-smi's memory with both replicas
          up, and the launch counts.
  slice_colocate
          the plugin's NVIDIA half and BASELINE's co-location run
          (tpushare_torch/tools/colocate.py). (A) NvmlBackend's topology
          through ChainBackend's cross-check against TorchBackend, held
          to nvidia-smi (uuid, name, total) and to floor(total / GiB)
          fake devices. (B) the port's Allocator on its single-card fast
          path through Allocator.allocate for grants of the whole card,
          16 + 16 and 8 GiB: NVIDIA_VISIBLE_DEVICES names the card,
          TPUSHARE_HBM_LIMIT_BYTES = units x 2^30, the _DEV env the
          card's units, the card's device nodes; then an assumed pod
          naming a card the node lacks gets the no-gpu-has- poison, which
          read_tenant_env refuses. (C) A-B-A: BERT-base (bf16, 8 x 128,
          random weights from seed 0) in tenant processes under those
          envs, solo (the whole card), two of 16 GiB, solo again, 6 s
          serve and sat windows each: colocated_pct, the solo variance,
          credible, sat per stream, breaches, memory, the solo serve
          window's idle share; gates: 0 breaches, one pooled output bit
          for bit across every tenant, the solo pooled output within
          POOLED_BF16_TOL of the f32 forward through mha_reference. (D)
          a HOG (8 GiB) walks 256 MiB steps past its grant beside a
          STEADY tenant (16 GiB): it must stop by its grant plus a step,
          and the planted HOG (enforcement off, isolation disabled) must
          walk past it. No speed is gated. BERT's attention (head_dim
          64, non-causal) takes mha_reference: no kernel of ours runs
          here. C, D then slice_saturation, and slice_plugin run side
          by side, while the main process compiles the flex phase's
          calls: their speeds are read beside each other's load.
  slice_plugin
          BASELINE.md's demo/binpack-1 dry-run on the card through the
          port's control plane (tpushare_torch/tools/binpack.py): (A)
          the daemon (python -m tpushare_torch.plugin.daemon
          --health-check --metrics-port, no fake env) discovers the card
          through NVML, registers with a kubelet simulator, lists
          floor(total / GiB) Healthy devices, patches the node, answers
          /healthz and /metrics; (B) the manifest's 3 x 2 GiB pods and
          two 16 GiB Gemma-2B pods through the extender's /filter and
          /bind and Allocate over gRPC: all on the card, the envs, the
          device nodes, ASSIGNED, inspect at 38 of 79 GiB; (C) the
          manifest's command under each binpack pod's env; each serving
          pod calls apply_tenant_limits() and runs the port's engine
          (--preset gemma_2b --seed 0) in its own process, 4 greedy
          completions of the slice prompts (16, 511, 1024, 2048 tokens)
          each: streams equal across the two, peak memory_reserved
          within 16 GiB, no OutOfMemoryError, exit 0, flash_attention
          and paged_flash_decode launched in each (their counts, read
          in the tenant at exit, are this path's launches); (D) health
          churn through TPUSHARE_HEALTH_ERRFILES and tenant 0's /drain:
          a quiet control window, then a bumped counter, every device
          Unhealthy within two 5 s polls, 503 with /healthz 200,
          Healthy again, /undrain, the 16-token prompt served equal to
          before; (E) the health sources the daemon logged (AER, NVML's
          XID events) and any XID seen.
  slice_llama
          Llama-3-8B at full width (random bf16 weights, no cut in depth
          or width) through two servers, each against an
          attn_impl="reference" twin on the same weights: (a) int8-self
          speculative decoding (the draft is quant.quantize_params of
          the target, served through quant.dequant_hook; gamma 4) over
          bf16 pools, (b) int8 KV pools (kv_quant). Both admit 4
          prompts of 100..2048 tokens whole, then 4 of 700..3000 tokens
          in 512-token chunks, each chunk a fused tick
          (step(prefill_work=slot)) beside the decode rows; then (a)
          runs 16 speculative rounds, (b) 16 decode ticks. Logits of
          every admission, of the first fused tick, of (a)'s first
          verify and (b)'s first decode tick are held against the twin;
          every fused tick and round must make exactly one
          device-to-host fetch.
  slice_moe
          Mixtral-8x7B at full width and depth, its config built by
          convert.moe_config_from_hf from the published config.json
          values; random weights made one layer at a time and quantized
          as made (int8 attention and experts, bf16 router, norms and
          embeddings: no bf16 expert tree ever exists). Two servers, one
          after the other, each over quant.fused_expert_hook, so every
          MoE layer runs the q8_expert_ffn kernel: (a) MoESlotServer over
          dense KV rows (max_len 4096), (b) PagedSlotServer(forward_fn=
          moe.paged_forward). Each admits 3 prompts whole, 2 in
          256-token chunks by fused ticks, a 4th whole, runs 16 decode
          ticks (+2 profiled), evicts, and admits a prompt that reuses
          560 tokens of the 4th's prefix. A twin on the same int8 tree
          (quant.dequant_hook, attn_impl="reference"), replaying the
          server's expert choices, holds the logits of every admission,
          the first fused tick and the first decode tick; beside each
          reading, the share of real (token, layer) pairs where the twin
          alone would have chosen another expert set.
  slice_moe_spec
          MoE int8-self speculation at Mixtral-8x7B's full width, depth
          cut to 6 of 32 layers (12 until PR 15's time cut; a bf16
          target and its int8 draft take
          ~2.9 + 1.45 GB a layer; 32 would be ~139 GB): random bf16
          weights from a seeded generator, the draft quantize_params of
          them served through fused_expert_hook. ServeEngine(
          model_family="moe", kv="paged", speculative_draft=...) over
          HTTP: 4 concurrent greedy completions (64..1000 tokens, 32
          new each, gamma 4), each stream held against a plain paged MoE
          server on the same weights by the A rule at
          MOE_LOGIT_REL_TOL; then the same at temperature 0.8. Gates:
          flash_attention, paged_flash_decode, paged_flash_verify and
          q8_expert_ffn launched, one fetch per round, an accept rate in
          (0, 1]. Records: ms per round beside the plain server's ms per
          tick, accept rate, peak memory_reserved. Then the routings
          dropless, expert_choice and a2a (capacity 1.25, one card)
          through a direct paged server on the int8 tree: 4 admissions,
          8 ticks under the fetch spy (one fetch each), 2 profiled
          (device ms per layer); the inputs layer 0 gave the expert
          products at the first admission and the first tick are held
          per element against the plain version (q8_expert_ffn against
          its reference; dropless's grouped GEMM against one matmul per
          expert).
  slice_rows
          Gemma-2-2B at full width and depth over dense rows
          (serving.SlotServer, 8 slots, max_len 8192): 5 prompts of
          200..6000 tokens (the longest in prefill_chunk pieces, two past
          the 4096 window), one admission finished by a fused tick, 16
          decode ticks (+2 profiled) through flash_decode, evict; logits
          held against an attn_impl="reference" twin.
  slice_train
          Gemma-2-2B at full width and depth (bf16, remat on) trained on
          one batch of 1 x 8192 (+1) seeded tokens over a one-rank NCCL
          group and make_mesh({"dp": 1, "sp": 1}). First the gradient
          twins, before any optimizer state: the gradients of xent_loss
          through the ring (partial kernel + gradient kernel) and through
          the single-device path (prefill kernel + gradient kernel), each
          leaf against autograd through mha_reference (attn_impl
          "reference") by relative L2. Then one sgd_train_step without a
          mesh, and trainer.fit of make_adamw_spmd_train_step for 4 steps
          (the loss must fall), one more step under torch.profiler.
          The kernels phase adds, for these two kernels: (a) the slice's
          attention layer (S 8192, 8/4 heads, head_dim 256, softcap 50,
          window 4096 and global) and (b) a 4-hop ring in Llama-3-8B
          geometry (4 shards of 2048), partial passes merged by the
          ring's merge and gradients summed over hops, against their plain
          versions (faults: k_offset + 1, a zero dsum).
  slice_finetune
          the LoRA tenant lifecycle of tpushare_torch/tools/
          finetune_serve.py at Gemma-2B's full width and depth (remat
          on): two tenants train rank-16 adapters on wq and wv, 20 SGD
          steps of 4 x 1024 tokens each through lora.make_lora_fit_step
          and trainer.fit, their batches from utils/data.py's
          token_batches over a seeded token file; tenant B is
          checkpointed at step 10 (one safetensors file), its state
          dropped, restored from latest_checkpoint and trained on, and
          must equal an uninterrupted run leaf for leaf (torch.equal);
          both adapters are read back from disk into a bank and served
          with the base by one ServeEngine over HTTP: each tenant's 4
          tokens hold its target at least 3 times, the base's do not.
          Then a gradient twin of one LoRA step (tenant A's trained
          adapters on its first batch) against mha_reference, per leaf
          within GRAD_REL_L2_TOL. Training launches exactly 2 x 18
          flash_attention (forward and remat recompute) and 18
          flash_attention_bwd per step; serving 18 flash_attention per
          admission and whole layers of paged_flash_decode. Printed:
          step ms, training tokens/s, the checkpoint's bytes, save and
          restore seconds, peak memory_allocated, ms per engine tick
          with the bank.
  slice_moe_train
          Mixtral-8x7B's width (d 4096, 32/8 heads, F 14336, 8 experts
          top-2), depth cut to 2 of 32 layers so that AdamW's state fits
          (~3.17 B params: 6.3 GB bf16, 6.3 GB of gradients, 25.4 GB of
          f32 moments), random bf16 weights, one sequence of 4096
          tokens. Gradient twins of moe.lm_loss under psum with capacity
          1.25, dropless (torch._grouped_mm forward and backward) and
          expert_choice, each against attn_impl="reference" replaying
          the kernel run's routes (Routes), per leaf within
          GRAD_REL_L2_TOL; dropless's twin also runs the per-expert
          products (moe._per_expert_products), the grouped GEMM's plain
          version; one sgd_train_step; 4 AdamW steps through
          trainer.fit of moe.make_adamw_spmd_train_step over a one-rank
          NCCL group and make_mesh({"dp": 1, "sp": 1}) (the ring's
          partial kernel, one hop) whose loss must fall; the AdamW
          state's first layer (every "layers" leaf of the params and
          both moments cut to layer 0, and the experts' leaves to its
          expert 0, the rest whole: ~4.8 GB, to hold the phase's disk
          time) saved (trainer.save_state) and restored equal.
  slice_generate
          Gemma-2B's generate, greedy, 4 prompts of 512 tokens + 64 new:
          the dense scalar-offset branch (flash_attention at every step,
          flash_decode never: the counts say), equal to a direct
          PagedSlotServer's greedy streams or parted at a near-tie
          within LOGIT_REL_TOL; speculative_generate with the int8-self
          draft (quantize_params + dequant_hook, gamma 4) equal to
          generate bit for bit, with its accept rate and ms per token
          beside generate's; moe.generate on slice_moe_train's trained
          2-layer Mixtral, 32 new tokens, its prefill logits within
          MOE_LOGIT_REL_TOL of the replaying reference twin.
  slice_fsdp
          Gemma-2B at full width and depth, remat on, 4 x 1024 tokens
          from utils/data.py (batch_at over a seeded token array), a
          one-rank NCCL group and make_mesh({"fsdp": 1}): two steps each
          of make_fsdp_train_step, make_fsdp_stream_train_step and
          make_fsdp_stream_adamw_step from the same params as two steps
          of make_spmd_train_step / make_adamw_spmd_train_step (dp1 x
          sp1): equal losses, each leaf's update within GRAD_REL_L2_TOL
          of the SPMD step's by relative L2, and whether the trees are
          bit-equal; the streaming SGD run's flat params through a
          checkpoint (trainer.save_state of fsdp_gather_flat) and back
          through load_state(shardings=fsdp_shardings(...)), equal.
          Each step launches the partial kernel twice a layer (the
          one-hop ring's forward and its remat recompute) and the
          gradient once. Printed: step ms, peak memory, the checkpoint's
          bytes and seconds.
  slice_pipeline
          the same model and batch at make_mesh({"pp": 1}), M = 4
          microbatches: pipeline.pp_loss_and_grads under GPipe, 1F1B and
          interleaved (2 chunks, to_interleaved_storage), each against
          the whole batch's plain gradient (training.value_and_grad of
          xent_loss) by relative L2 and loss, then one 1F1B AdamW step
          (make_pp_adamw_train_step). Exact launch counts: GPipe 2 x 18
          x 4 forward (remat) and 18 x 4 gradient; 1F1B 18 x 4 of each
          (the forward runs only inside the backward's recompute);
          interleaved (9 x 2 + 9) x 4 forward. Printed: ms per schedule
          (the second call; the first is a warm-up), peak memory.
  slice_moe_train's pp step
          on its 2-layer Mixtral after the checkpoint: moe_pipeline.
          moe_pp_loss_and_grads at pp 1, M 2, 2 x 2048 tokens, under psum
          (capacity 1.25) and dropless, each against the per-microbatch
          objective (the mean of moe.lm_loss over the microbatches)
          through the same kernels, then one make_moe_pp_train_step.
  slice_saturation
          tools/saturation.py: the four 4 GiB eval pods placed one per
          card of a fake four-card host (A), then four ResNet-50 tenant
          processes (bf16, 64 x 224 x 224 x 3) on this card under
          Allocate's envs and the guard, one solo then four at once (B):
          images/s, the four's total over solo, peak memory_reserved
          within the grant, no breach, logits within LOGIT_REL_TOL of an
          f32 twin; no attention kernel (cuDNN convolutions).
          The kernels phase adds prefill with its lse (fault: the causal
          edge) at slice_pipeline's microbatch (1 x 1024) and the MoE pp
          step's (Mixtral 1 x 2048), and the partial pass and the
          gradient (faults: k_offset + 1, a zero dsum) at slice_fsdp's
          4 x 1024 and at both microbatches.
  slice_mesh
          tools/multichip.py, BASELINE row 5 (mixed bin-pack): (A) a
          fake four-card host places a 32-unit serving pod on two cards
          (GetPreferredAllocation spans two, Allocate's env is
          gpu_env_for_cards') and bin-packs two 8-unit pods onto one
          shared card. (B) Llama-3-8B at full width and depth over
          tp=2: two rank processes of tpushare-torch-serve --mesh tp=2
          (rank 0 serves HTTP, rank 1 follows its broadcast calls), on
          this one card over the gloo transport (the collectives stage
          through the host: not a tp measurement); 8 prompts of
          16..2048 tokens with chunked admission (512), then a direct
          sharded PagedSlotServer on the engine's slices (whole
          admissions, 8 timed ticks) and greedy speculative rounds (the
          model drafting for itself, gamma 4). Held to a one-card twin
          run in this process first: streams equal or parting at a
          counted flip, admission logits within LOGIT_REL_TOL of the
          twin's largest |logit|, every rank's streams and call digest
          equal to rank 0's, one fetch per tick. (C) Mixtral-8x7B's
          width, 4 of its 32 layers, int8 experts through
          fused_expert_hook, over ep=2 on the same ranks: the psum and
          a2a routings (a2a: each rank routes its share of the tokens
          at capacity E / top_k, so nothing drops), each against its
          one-card twin at MOE_LOGIT_REL_TOL. (D) two small pods, one
          BERT-base forward each. The kernels phase adds the per-rank
          shapes: prefill at 16/4 heads for every direct admission
          (fault: the causal edge); paged decode at the direct
          server's B 8 and the engine's B 4 (fault: a dropped page);
          verify at 16/4 heads at Sq 5 and at each fused width of the
          engine's chunked admissions, B 4 (engine_schedule; fault:
          the causal edge); q8_expert_ffn at 4 local experts (shared
          blocks of 4 and 1024 rows, a2a queues; fault: two experts'
          scales swapped). (E) elastic serving on B's engine (each
          rank keeps a host copy of the whole tree, or a checkpoint
          read back by slice where the host's MemAvailable is short):
          a wave of B's 8 prompts with POST /mesh/chip marking rank 1's
          card unhealthy once the first tokens are out (the engine
          reshards to tp=1 on rank 0 and replays), the card healthy
          again (grow-back to tp=2 at an idle tick), a wave of 4 on the
          regrown mesh: streams against the twin as in B, every mesh
          generation's digest equal on both ranks, and per rank and
          generation the kernels launched (tp=1: prefill, verify and
          paged decode at 32/8 heads) and the peak memory. Then the
          process case, E_KILL_LAYERS of Llama's 32 layers (the twin
          cut alike): two rank processes of the serve CLI with
          --process-view 2 and the gang liaison, rank 1's process
          SIGKILLed mid-wave, the liaison's verdict, the reshard within
          the heartbeat timeout + 10 s, rank 1 restarted, its rejoin and
          the grow-back; detection, reshard and grow-back seconds.
  slice_smokes
          the three CI storm smokes as processes at their card presets,
          in f32: chaos (Gemma-2B dense; Mixtral's width at 2 layers,
          int8 experts through the fused expert kernel, over the paged
          pool) and durable (a Gemma-2B serve process behind the
          router, SIGKILLed between waves and restarted on its journal)
          run beside slice_mesh's process case; then slo (a Gemma-2B
          mixed-tier storm) alone, its gate being latency deadlines.
          Each one's record; a smoke that exits non-zero fails the run.
  flex    the softcapped cases' library call, flex_attention under
          torch.compile with the softcap as its score_mod and the mask
          as its block mask, on the kernels phase's inputs; each case
          compiles beside the side-by-side phases and is timed after
          the slices, alone. Each case's time, distance from the plain
          version and compile seconds (also on the seconds line) fill
          its kernels row's library columns.

The slices and the training runs set the launch counters to 0 just
before their run and read them just after; every kernel variant its
path runs must have launched. Then the card's name and power limit,
the ``{"kernels": [...]}`` line (one entry per kernel and page type)
and last ``{"ok": true, "device": {...}}``. Any failed check raises (non-zero exit, no
result line). Without CUDA it exits 2 at once.
"""

import dataclasses
import faulthandler
import functools
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
from unittest import mock

# Tolerances, with their reasons.
# Kernel vs plain, bf16 in and out: both sides do all arithmetic in f32
# (they differ by f32 summation order, ~1e-6 relative) and round the
# output to bf16, so an element may differ by the one bf16 step its
# rounding flipped: at most 2^-7 of the element's own magnitude. The
# check is per element and relative, so it keeps its power on long
# rows, whose outputs are small (~0.03): |got - want| <= 2^-7 |want| +
# 1e-5 (the floor covers elements near 0, where the f32 difference
# itself shows). "ulp_ratio" is the worst element's share of its limit.
ULP_REL = 2.0 ** -7
ULP_FLOOR = 1e-5
# The partial pass's unnormalized accumulator and the attention gradient
# are f32 sums over up to 8192 rows or hops whose terms cancel: an
# element far below its tensor's scale carries summation-order noise of
# ~sqrt(n) 2^-24 of the summed magnitudes (~5e-6 at n = 8192; the first
# full run read 2.5e-6 on the partial's accumulator, 21x the absolute
# floor), which no fixed floor suits. Their floor is this share of the
# tensor's largest |element|; the 2^-7 relative term stays, and a planted
# fault moves elements by the tensor's own scale.
F32_SUM_FLOOR = 1e-4
# Served logits, kernel server vs reference server, relative to the
# largest |logit|: attention outputs round to bf16 in both and a
# rounding flip in one of 18 layers propagates through the bf16
# residual stream. Sound runs read ~5e-3; the limit is 4x that.
LOGIT_REL_TOL = 2e-2
# slice_moe's server vs its twin differ in more than rounding order: the
# server's expert products are the int8 kernel's (scale after each f32
# dot, outputs rounded once), the twin's dequant_hook rounds W * s to
# bf16 first and runs bf16 products. Where the two land on different
# sides of a top-2 routing boundary a token's FFN output changes
# outright, and over 32 layers of random weights such flips cascade: a
# twin routing on its own read up to 0.32 of the largest |logit|, with
# 3-9% of an admission's (token, layer) pairs routed to another expert
# set. So the twin replays the server's routes (``Routes``); beside
# each reading, the share of pairs where the twin alone would have
# routed otherwise. What is left is rounding, from two sources where the
# dense slices have one (attention's, and the twin's bf16 expert
# products on bf16-rounded weights): replayed, the readings ran
# 0.014-0.0199 at Mixtral's 32 layers (Llama-3-8B's, one source, ran
# 0.0126-0.0179), so the limit is 1.5x the worst of them.
MOE_LOGIT_REL_TOL = 3e-2

# slice_train's gradients against its attn_impl="reference" twin, per
# leaf, ||got - want|| / ||want||: both run the same bf16 model and round
# each attention output to bf16 once; they differ in the attention's f32
# summation order and in the gradient's form (the hand-derived kernel
# gradient vs autograd through mha_reference), and a rounding flip in one
# of 26 layers propagates through the bf16 residual stream. The first
# full run on an H100 read 0.0073-0.0254 over the leaves of both paths
# (ring and single device, wq the worst); the limit is 2x the worst.
GRAD_REL_L2_TOL = 5e-2
TRAIN_SEQ = 8192              # slice_train's sequence (past the 4096 window)
TRAIN_LR = 3e-4

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM)
H100_HBM_BYTES_S = 3.35e12    # HBM3 rate (H100 SXM)


def mean(xs):
    return sum(xs) / len(xs)


def median(xs):
    return sorted(xs)[len(xs) // 2]


_EMIT_LOCK = threading.Lock()


def emit(obj):
    """One JSON line on stdout, written whole: the side-by-side phases
    emit from threads of their own."""
    line = memoryview((json.dumps(obj) + "\n").encode())
    with _EMIT_LOCK:
        sys.stdout.flush()
        while line:
            line = line[os.write(sys.stdout.fileno(), line):]


def side_by_side(*fns):
    """Call each function of no arguments, the first in this thread and
    each other in a thread of its own; wait for all of them and raise
    the first error any of them raised. Returns their results."""
    results, errors = [None] * len(fns), [None] * len(fns)

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as e:
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(1, len(fns))]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """[kernel, registers, spill store bytes, spill load bytes] for each
    entry function of an nvcc ``-Xptxas -v`` log; the kernel is its
    mangled name from the namespace on, without the parameter list."""
    out, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = re.sub(r"^.*?_cu_[0-9a-f]+", "", m.group(1))
            name = re.split(r"E+v", name)[0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append([name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    return out


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    alone with CUDA events after the 50 MB L2 is overwritten (a
    serving tick finds each layer's KV cold).

    The stream first spins on the device (torch.cuda._sleep) until the
    host has enqueued every iteration, so each event pair brackets
    device work only. Without it the device idles between the start
    event and the kernel while the host runs the wrapper's checks and
    its ctypes call, which can take longer than a 10-30 us kernel. The
    spin is sized from one iteration's host time and lengthened (at
    most twice) until an event recorded after it is still pending once
    the loop is enqueued."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.zero_()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(iters * host_s * 4e9) + 2 ** 20
    for _ in range(3):
        pairs = []
        torch.cuda._sleep(cycles)
        gate = torch.cuda.Event()
        gate.record()
        for _ in range(iters):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        covered = not gate.query()
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 4
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_us(fn):
    """Host microseconds one call of ``fn`` takes to return (the
    wrapper's checks, allocations and launches; the device runs on),
    the mean of 20 calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / 20 * 1e6


def kernel_ms(fn, *names):
    """Device ms a call of ``fn`` spends in each kernel whose name holds
    one of ``names`` (torch.profiler, mean of 10 calls)."""
    fn()
    with DeviceProfile(10) as prof:
        for _ in range(10):
            fn()
    return {k: v for k, v in prof.stats["top_kernels_ms_per_tick"].items()
            if any(n in k for n in names)}


@functools.lru_cache(maxsize=None)
def flex_fn(torch):
    """torch.compile of torch.nn.attention.flex_attention: the one
    PyTorch call that computes a softcapped, masked attention (timed as
    a yardstick; the port never calls it). Each new shape, mask or
    score function compiles once; the caller times that apart. The
    recompile limit is raised so that no case falls back to eager
    unnoticed."""
    from torch.nn.attention.flex_attention import flex_attention
    torch._dynamo.config.cache_size_limit = 64
    return torch.compile(flex_attention, dynamic=False)


def flex_library(torch, dev, flush, name, q, k, v, softcap, mask_mod, Sq,
                 want, iters, *, lse=False, grad=None, prep=None):
    """Time flex_attention under torch.compile on q [B, Sq, H, D] and
    k, v [B, Sk, Hkv, D] (``prep``: a function of no arguments timed
    with the call that returns k, v, e.g. a page gather), with the
    softcap as its score_mod and ``mask_mod`` as its block mask.
    ``lse``: forward with the log-sum-exp; ``grad`` = (do, (dq, dk,
    dv)): time the backward from do instead. Compiles (the first call)
    and returns a function of no arguments that times the compiled
    call, apart, and returns (library_ms, its max |distance| from
    ``want`` (or from the plain gradients), compile seconds, error text
    or None)."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask
        fn = flex_fn(torch)
        B, Sk = k.shape[0], k.shape[1]
        bm = create_block_mask(mask_mod, B, None, Sq, Sk, device=dev)
        cap = float(softcap)

        def score_mod(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        qt = q.transpose(1, 2)
        if grad is not None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            do = grad[0].transpose(1, 2)
        t0 = time.perf_counter()
        if grad is None:
            def call():
                kk, vv = prep() if prep else (k, v)
                return fn(qt, kk.transpose(1, 2), vv.transpose(1, 2),
                          score_mod=score_mod, block_mask=bm,
                          enable_gqa=True, return_lse=lse)
            out = call()
            out = (out[0] if lse else out).transpose(1, 2)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
        else:
            o = fn(qt, kt, vt, score_mod=score_mod, block_mask=bm,
                   enable_gqa=True)

            def call():
                return torch.autograd.grad(o, (qt, kt, vt), do,
                                           retain_graph=True)
            got = call()
            torch.cuda.synchronize()
            err = max((a.transpose(1, 2).float() - b.float()).abs().max()
                      .item() for a, b in zip(got, grad[1]))
        compile_s = time.perf_counter() - t0
        return lambda: (time_ms(call, iters, flush), err, compile_s, None)
    except Exception as e:  # a yardstick only: record why, gate nothing
        msg = f"{name}: {type(e).__name__}: {e}"[:600]
        return lambda: (None, None, None, msg)


# flex_library calls held until after the slices: [row, call, timer].
FLEX_LATER = []


def flex_later(row, *args, **kw):
    """Queue ``flex_library(*args, **kw)`` for the flex phase, which
    fills ``row``'s library columns."""
    FLEX_LATER.append([row, functools.partial(flex_library, *args, **kw),
                       None])


def compile_flex_later():
    """Compile every queued flex_library call (its first call), leaving
    its timing to the flex phase: this runs beside the side-by-side
    phases, whose processes time nothing of the main process's."""
    for item in FLEX_LATER:
        if item[2] is None:
            item[2] = item[1]()


def run_flex_later():
    """The flex phase: time every queued flex_library call in order
    (compiling those not compiled yet), fill its row and emit one line
    per case."""
    while FLEX_LATER:
        row, call, timer = FLEX_LATER.pop(0)
        (row["library_ms"], row["library_err"], row["flex_compile_s"],
         row["library_error"]) = (timer or call())()
        emit({"phase": "flex", "kernel": row["kernel"], "case": row["case"],
              **{k: row[k] for k in ("library_ms", "library_err",
                                     "library_error", "flex_compile_s")}})


def compare(got, want, floor_of_max=None):
    """Kernel output vs its plain version under the bf16 rule above; with
    ``floor_of_max`` the floor is that share of max |want| (the f32-sum
    rule)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    floor = ULP_FLOOR if floor_of_max is None else floor_of_max * w.max()
    return {"max_abs_err": d.max().item(),
            "ulp_ratio": (d / (ULP_REL * w + floor)).max().item(),
            "rel_to_max": (d.max() / w.max()).item()}


def causal_pairs(Sq, Sk, q_offset, window):
    """(query, key) pairs the causal/window mask keeps: the work the
    kernel must do on these inputs."""
    import numpy as np
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    return int(np.maximum(0, hi - lo + 1).sum())


def bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefill_case(fa, attn, F, torch, dev, flush, name, Sq, Sk, H, Hkv, D,
                 q_offset, window=None, softcap=None, seed=0, fault=False,
                 B=1, more_offsets=(), lse=False):
    """One prefill shape: check, time, bound. With ``fault``, also run
    the kernel one position off at the causal edge (q_offset + 1, as an
    off-by-one kernel would) and require the same check to reject it.
    ``more_offsets``: further q_offsets checked on the same inputs (a
    decode loop's steps over one cache); the row's check columns are
    the worst over them, its times and bound q_offset's. ``lse``: the
    launch a training forward makes (with its f32 log-sum-exp, which
    the gradient reads) is checked too: its output by the same rule,
    its lse by the f32-sum rule against the plain partial pass's
    m + log(l)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(bf)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(bf)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(bf)
    kw = dict(q_offset=q_offset, window=window, attn_softcap=softcap)
    want = attn.mha_reference(q, k, v, **kw)
    cmp = None
    for off in (q_offset, *more_offsets):
        kwo = dict(kw, q_offset=off)
        c = compare(fa.flash_attention(q, k, v, **kwo),
                    want if off == q_offset else
                    attn.mha_reference(q, k, v, **kwo))
        if not (c["ulp_ratio"] <= 1.0):
            raise AssertionError(f"flash_attention {name} at q_offset "
                                 f"{off}: {c}")
        cmp = c if cmp is None else {key: max(cmp[key], c[key])
                                     for key in c}
    lse_cmp = None
    if lse:
        out_l, lse_k = fa._flash_launch(q, k, v, scale=None, with_lse=True,
                                        **kw)
        acc, m, l_ = fa.flash_attention_partial_plain(q, k, v, k_offset=0,
                                                      **kw)
        out_cmp = compare(out_l, want)
        lse_cmp = compare(lse_k, m + torch.log(l_), F32_SUM_FLOOR)
        del out_l, lse_k, acc, m, l_
        if not (max(out_cmp["ulp_ratio"], lse_cmp["ulp_ratio"]) <= 1.0):
            raise AssertionError(f"flash_attention {name} with its lse: "
                                 f"out {out_cmp}, lse {lse_cmp}")
        cmp = {key: max(cmp[key], out_cmp[key]) for key in cmp}
    torch.cuda.synchronize()
    fault_ratio = None
    if fault:
        bad = fa.flash_attention(q, k, v, **dict(kw, q_offset=q_offset + 1))
        fault_ratio = compare(bad, want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"flash_attention {name}: the check missed "
                                 f"an off-by-one causal edge ({fault_ratio})")
    iters = 10 if Sq >= 1024 else 30
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters, flush)
    plain_ms = time_ms(lambda: attn.mha_reference(q, k, v, **kw), iters,
                       flush)
    library_ms = library_err = None
    if softcap is None:
        # One PyTorch call computing the same function: SDPA with the
        # causal/window mask (timed as a yardstick, never used by the
        # port; it has no softcap).
        qp = q_offset + torch.arange(Sq, device=dev)[:, None]
        kp = torch.arange(Sk, device=dev)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib = sdpa().transpose(1, 2)
        library_err = (lib.float() - want.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters, flush)
    pairs = causal_pairs(Sq, Sk, q_offset, window)
    flops = 4 * D * H * pairs * B
    nbytes = 2 * B * (2 * Sq * H * D + 2 * Sk * Hkv * D)
    bms, by = bound(flops, nbytes)
    row = {"phase": "kernels", "kernel": "flash_attention", "case": name,
           "B": B, "Sq": Sq, "Sk": Sk, "H": H, "Hkv": Hkv, "D": D,
           "q_offset": q_offset, "window": window, "softcap": softcap,
           "offsets_checked": 1 + len(more_offsets),
           "lse_ulp_ratio": lse_cmp and lse_cmp["ulp_ratio"],
           **cmp, "fault_ulp_ratio": fault_ratio, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_err": library_err, "bound_ms": bms, "bound_by": by,
           "tflops": flops / ms / 1e9}
    emit(row)
    return row


def paged_case(fa, F, torch, np, dev, flush, kernel, name, pos, pages, Sq,
               H, Hkv, D, *, bs=16, nb=1024, mb=None, int8=False,
               window=None, softcap=None, share=None, seed=1, fault=None):
    """One paged-kernel case (``kernel`` is "paged_flash_decode" or
    "paged_flash_verify") over a pool laid out as the server lays it
    out: slot b has ``pages[b]`` pool blocks drawn from a shuffled free
    list, -1 after them; ``share`` = (b0, b1) gives slot b1 slot b0's
    first page (a prefix hit). Slot b's Sq query rows sit at pos[b] ..
    pos[b] + Sq - 1. ``int8``: int8 pages with f32 scale pages, as a
    kv_quant pool holds them. ``fault``: "page" drops one live page of
    the longest slot, "causal" runs the kernel one position late (row s
    attends pos + s + 1), "scale" swaps two heads' scale pages on the
    longest slot's pages; the same check must reject each. Decode cases
    add the split count, the device time of the split and merge
    kernels, the host time of a call, and require two launches to give
    equal bits."""
    from tpushare_torch.models.quant import kv_quantize, scales_to_pool_layout
    B, mb = len(pos), mb or nb
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    k = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    v = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    scl = {}
    if int8:
        (pool_k, ks), (pool_v, vs) = kv_quantize(k), kv_quantize(v)
        scl = {"k_scale": scales_to_pool_layout(ks),
               "v_scale": scales_to_pool_layout(vs)}
    else:
        pool_k, pool_v = k.to(bf), v.to(bf)
    del k, v
    pos = np.asarray(pos, np.int32)
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        table[b, :pages[b]] = [ids.pop() for _ in range(pages[b])]
    if share:
        table[share[1], 0] = table[share[0], 0]
    table_t = torch.as_tensor(table, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(bf)
    kern = getattr(fa, kernel)
    plain = getattr(fa, kernel + "_plain")
    kw = dict(window=window, attn_softcap=softcap, **scl)
    got = kern(q, pool_k, pool_v, table_t, pos_t, **kw)
    want = plain(q, pool_k, pool_v, table_t, pos_t, **kw)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"{kernel} {name}: {cmp}")
    # bf16 outputs the kernel rounded the other way from the plain
    # version: int8 KV pages downstream carry such flips further.
    flips = int((got != want).sum())
    fault_ratio = None
    if fault:
        b = int(pos.argmax())
        bad_table, bad_pos, bad_kw = table_t, pos_t, kw
        if fault == "page":
            dropped = table.copy()
            dropped[b, int(pos[b]) // bs // 2] = -1
            bad_table = torch.as_tensor(dropped, device=dev)
        elif fault == "causal":
            bad_pos = pos_t + 1
        elif fault == "scale":
            blk = table_t[b, :pages[b]].long()
            bad_kw = dict(kw)
            for key in ("k_scale", "v_scale"):
                sw = kw[key].clone()
                sw[blk, 0], sw[blk, 1] = kw[key][blk, 1], kw[key][blk, 0]
                bad_kw[key] = sw
        bad = kern(q, pool_k, pool_v, bad_table, bad_pos, **bad_kw)
        fault_ratio = compare(bad, want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"{kernel} {name}: the check missed the "
                                 f"planted {fault} fault ({fault_ratio})")
    decode = kernel == "paged_flash_decode"

    def run():
        return kern(q, pool_k, pool_v, table_t, pos_t, **kw)
    extra = {}
    if decode:
        if not torch.equal(run(), got):
            raise AssertionError(f"{kernel} {name}: two launches on the "
                                 f"same inputs differ")
        extra = {"splits": fa.decode_splits(
                     B, H, Hkv, mb * bs, torch.cuda.get_device_properties(
                         dev).multi_processor_count),
                 "bit_equal": True,
                 "kernel_ms": kernel_ms(run, "split_kernel", "merge_kernel"),
                 "host_us": host_us(run)}
    big = Sq * H >= 1024
    ms = time_ms(run, 10 if big else 50, flush)
    plain_ms = time_ms(lambda: plain(q, pool_k, pool_v, table_t, pos_t, **kw),
                       5 if big else 10, flush)
    # The work these inputs need: (row, key) pairs the mask keeps, and
    # the key positions any row of the slot reads.
    kp = np.arange(mb * bs)
    alloc = np.repeat(table >= 0, bs, axis=1)[:, None, :]
    qpos = (pos[:, None] + np.arange(Sq))[..., None]
    keep = (kp <= qpos) & alloc
    if window:
        keep &= kp > qpos - window
    pairs = int(keep.sum())
    live_rows = int(keep.any(axis=1).sum())
    elt = 1 if int8 else 2
    nbytes = (2 * B * Sq * H * D * 2 + 2 * live_rows * Hkv * D * elt
              + (2 * live_rows * Hkv * 4 if int8 else 0) + B * mb * 4 + B * 4)
    flops = 4 * D * H * pairs
    bms, by = bound(flops, nbytes)
    library_ms = library_err = None
    # The library route: gather the live pages into a dense view (int8
    # pages dequantized), then one SDPA with the boolean mask; with a
    # softcap, which SDPA lacks, flex_attention with the softcap as its
    # score_mod and the same mask as its block mask.
    n = int(max(pages))
    tbl = table_t[:, :n].clamp(min=0).long()
    alloc = (table_t[:, :n] >= 0).repeat_interleave(bs, dim=1)  # [B, K]

    def gather():
        kd, vd = pool_k[tbl], pool_v[tbl]           # [B, n, bs, Hkv, D]
        if int8:
            kd = (kd.float() * scl["k_scale"][tbl].transpose(-1, -2)
                  [..., None]).to(bf)
            vd = (vd.float() * scl["v_scale"][tbl].transpose(-1, -2)
                  [..., None]).to(bf)
        return (kd.reshape(B, n * bs, Hkv, D), vd.reshape(B, n * bs, Hkv, D))

    rows = torch.as_tensor(keep.any(axis=2), device=dev)  # [B, Sq]
    if softcap is None:
        kpos = torch.arange(n * bs, device=dev)
        qp = pos_t.long()[:, None, None] + torch.arange(Sq, device=dev)[:, None]
        mask = (kpos <= qp) & alloc[:, None, :]
        if window:
            mask &= kpos > qp - window
        mask = mask[:, None]                            # [B, 1, Sq, K]

        def library():
            kd, vd = gather()
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                attn_mask=mask, enable_gqa=True).transpose(1, 2)

        lib = library()
        library_err = (lib.float() - want.float()).abs()[rows].max().item()
        library_ms = time_ms(library, 5 if big else 10, flush)
        library_calls = ("gather, dequantize, SDPA" if int8
                         else "gather, SDPA")
    else:
        pl = pos_t.long()

        def mask_mod(b, h, q_idx, kv_idx):
            keep_ = (kv_idx <= pl[b] + q_idx) & alloc[b, kv_idx]
            if window:
                keep_ = keep_ & (kv_idx > pl[b] + q_idx - window)
            return keep_

        library_calls = ("gather, " + ("dequantize, " if int8 else "")
                         + "flex_attention (torch.compile; softcap "
                         "score_mod, block mask)")
    row = {"phase": "kernels", "kernel": kernel, "case": name,
           "pages": "int8" if int8 else "bf16", "B": B, "Sq": Sq, "H": H,
           "Hkv": Hkv, "D": D, "bs": bs, "max_pos": int(pos.max()),
           "live_rows": live_rows, "window": window, "softcap": softcap,
           **cmp, "flips": flips, "elements": got.numel(), "fault": fault,
           "fault_ulp_ratio": fault_ratio, "ms": ms, **extra,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_calls": library_calls, "library_err": library_err,
           "library_error": None, "flex_compile_s": None,
           "bound_ms": bms, "bound_by": by, "gb_s": nbytes / ms / 1e6}
    if softcap is not None:
        kd, vd = gather()
        flex_later(row, torch, dev, flush, f"{kernel} {name}", q, kd, vd,
                   softcap, mask_mod, Sq, want, 5 if big else 10,
                   prep=gather)
    emit(row)
    return row


class RecordingSampler:
    """Wraps a server's sampler to keep the logits of the picks made
    while ``record`` is set (the check compares them across two
    servers)."""

    def __init__(self, inner):
        self.inner, self.record, self.seen = inner, False, []

    def pick(self, logits):
        if self.record:
            self.seen.append(logits.detach().float().clone())
        return self.inner.pick(logits)


class DeviceProfile:
    """Device time by kernel name over a window of ``n`` steps, and the
    share of that same window's wall time the card sat idle
    (torch.profiler over CUPTI, CUDA activity only: no host-op tracing,
    so the host runs close to its unprofiled pace; ``wall_ms_per_tick``
    beside the unprofiled ticks' shows what the profiler still
    costs)."""

    def __init__(self, n):
        self.n, self.stats = n, None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop(*exc)
        if exc[0] is None:
            self.summarize()

    def stop(self, *exc):
        """Close the window: drain the card, stop the trace (cheap; the
        events are parsed later, in ``summarize``)."""
        import torch
        torch.cuda.synchronize()
        self.wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(*(exc or (None, None, None)))

    def summarize(self):
        import torch
        n, wall_ms, by_name = self.n, self.wall_ms, {}
        for evt in self.prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            by_name[evt.key[:90]] = evt.self_device_time_total / 1e3 / n
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.stats = {"ticks": n, "wall_ms_per_tick": wall_ms / n,
                      "device_ms_per_tick": busy,
                      "idle_share": 1.0 - busy * n / wall_ms,
                      "top_kernels_ms_per_tick": dict(top)}


def profile_ticks(srv, n):
    """``DeviceProfile`` of ``n`` decode ticks of ``srv``."""
    with DeviceProfile(n) as prof:
        for _ in range(n):
            srv.step()
    return prof.stats


def serve(paged, cfg, params, prompts, wave2, attn_impl, ticks,
          profile=0):
    """Drive one server through the main path; returns what it served,
    the recorded logits, the decode timing and, with ``profile`` > 0,
    a device-time breakdown of that many further decode ticks."""
    import torch
    srv = paged.PagedSlotServer(params, cfg, n_slots=8, n_blocks=1024,
                                block_size=16, prefix_cache=True,
                                attn_impl=attn_impl)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    first, streams = {}, {}
    torch.cuda.synchronize()
    rec.record = True               # wave-1 admissions and first tick
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        slot = srv.admit_start(p)
        first[i] = srv.admit_step(slot)
        streams[slot] = [first[i]]
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    tick_ms = []
    for t in range(ticks):
        t0 = time.perf_counter()
        out = srv.step()                        # ends in the tick's fetch
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        for s, tok in out.items():
            streams[s].append(tok)
        if t == 0:
            rec.record = False
            active = [sorted(out)]
    decode_s = sum(tick_ms) / 1e3
    prof = profile_ticks(srv, profile) if profile else None
    for s in list(streams):
        srv.evict(s)
    hits = []
    rec.record = True               # wave-2 admissions and first tick
    for p in wave2:
        slot = srv.admit_start(p)
        hits.append(srv.last_cached_len)
        streams[100 + slot] = [srv.admit_step(slot)]
    for t in range(8):
        out = srv.step()
        for s, tok in out.items():
            streams[100 + s].append(tok)
        if t == 0:
            rec.record = False
            active.append(sorted(out))
    torch.cuda.synchronize()
    # Rows to compare in each recorded pick: an admission's one row;
    # a tick's active slots (an idle slot's row is junk in both servers
    # and differs between them: the kernel gives a slot with no live
    # page 0, the reference's gathered view reads the trash block).
    n1 = len(prompts)
    rows = [[0]] * n1 + [active[0]] + [[0]] * len(wave2) + [active[1]]
    return {"first": first, "streams": streams, "logits": rec.seen,
            "rows": rows,
            "hits": hits, "admit_s": admit_s, "decode_s": decode_s,
            "tick_ms_median": median(tick_ms),
            "fetches": srv.device_fetches, "profile": prof}


class FetchSpy:
    """Counts every way a tensor's value reaches the host (.item,
    .tolist, .cpu, .numpy and the scalar conversions) while active."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __init__(self, torch):
        self.torch, self.count = torch, 0

    def __enter__(self):
        T = self.torch.Tensor
        self.orig = {n: getattr(T, n) for n in self.NAMES}

        def spy(fn):
            def wrapped(t, *a, **kw):
                self.count += 1
                return fn(t, *a, **kw)
            return wrapped

        for n, fn in self.orig.items():
            setattr(T, n, spy(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.torch.Tensor, n, fn)


def llama_schedule(serving, paged, wave_a, wave_b, chunk, bs, h):
    """The Llama slice's launch shapes, from the server's own rules
    (serving.fused_chunk_span, paged.blocks_needed) on the host: each
    fused tick's (width, pos [8], pages [8]) with slots 0-3 decoding and
    the admitting slot at its chunk start, and each slot's length when
    the fused admissions end (the first speculative round's base and the
    kv_quant server's first decode position)."""
    lengths = {s: n for s, n in enumerate(wave_a)}
    ticks = []
    for i, S in enumerate(wave_b):
        slot, done = len(wave_a) + i, 0
        while done < S:
            end, width = serving.fused_chunk_span(done, S, chunk, None,
                                                  gran=bs)
            pos = [lengths.get(s, 0) for s in range(8)]
            pages = [lengths[s] // bs + 1 if s in lengths else 0
                     for s in range(8)]
            pos[slot], pages[slot] = done, paged.blocks_needed(S + 1, bs)
            ticks.append((width, pos, pages))
            for s in lengths:
                lengths[s] += 1
            done = end
        lengths[slot] = S
    base = [lengths[s] for s in range(8)]
    return ticks, base, [(n + h) // bs + 1 for n in base]


def engine_schedule(serving, paged, lens, n_slots, chunk, bs, max_tokens):
    """slice_mesh's engine (``n_slots`` slots, ``chunk``-token chunked
    admission, ``max_tokens`` a request) at its launch shapes, from the
    server's own rules on the host: every prompt longer than ``chunk``
    admitted by one fused tick a chunk (serving.fused_chunk_span, the
    admitting row at its chunk start), beside n_slots - 1 rows decoding
    at the longest other prompts' last positions (the most context such
    a tick can carry); and the decode tick of the n_slots longest
    prompts at their last positions. Returns each fused tick's (width,
    pos, pages) and the decode tick's (pos, pages)."""
    ticks = []
    for i, S in enumerate(lens):
        if S <= chunk:                  # admitted whole
            continue
        others = sorted((n for j, n in enumerate(lens) if j != i),
                        reverse=True)[:n_slots - 1]
        dpos = [n + max_tokens - 2 for n in others]
        done = 0
        while done < S:
            end, width = serving.fused_chunk_span(done, S, chunk, None,
                                                  gran=bs)
            ticks.append((width, [done] + dpos,
                          [paged.blocks_needed(S + 1, bs)]
                          + [p // bs + 1 for p in dpos]))
            done = end
    last = [n + max_tokens - 2 for n in sorted(lens, reverse=True)[:n_slots]]
    return ticks, (last, [p // bs + 1 for p in last])


def serve_llama(paged, quant, cfg, params, qparams, wave_a, wave_b, *,
                mode, attn_impl, rounds, n_blocks, chunk):
    """Drive one Llama-3-8B server through the slice: 4 whole
    admissions, 4 admissions by fused ticks, then ``rounds``
    speculative rounds (mode "spec") or decode ticks (mode "kvq").
    Returns streams, recorded logits (admissions, the first fused
    tick's decode rows, the first verify or decode tick), timings,
    fetch counts per fused tick and round, and peak memory."""
    import torch
    kw = dict(n_slots=8, n_blocks=n_blocks, block_size=16,
              max_blocks_per_slot=256, prefix_cache=True,
              attn_impl=attn_impl)
    if mode == "spec":
        kw.update(speculative_draft=(qparams, cfg), gamma=4,
                  draft_layers_hook=quant.dequant_hook(cfg))
    else:
        kw.update(kv_quant=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = paged.PagedSlotServer(params, cfg, **kw)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    streams, inputs = {}, {}
    torch.cuda.synchronize()
    rec.record = True
    t0 = time.perf_counter()
    for p in wave_a:
        slot = srv.admit_start(p)
        streams[slot] = [srv.admit_step(slot)]
    admit_s = time.perf_counter() - t0
    n_adm_a = len(rec.seen)
    fused_ms, fused_fetch, first_tick = [], [], None
    t_fused = time.perf_counter()
    for i, p in enumerate(wave_b):
        slot = srv.admit_start(p, chunk_tokens=chunk)
        if i == len(wave_b) - 1:
            # The last admission's fused ticks run under the profiler;
            # their times stay out of the unprofiled mean.
            n_plain = len(fused_ms)
            prof_fused = DeviceProfile(
                -(-len(p) // chunk)).__enter__()
        while slot in srv._admissions:
            before = {s: v[-1] for s, v in streams.items()}
            f0 = srv.device_fetches
            t0 = time.perf_counter()
            with FetchSpy(torch) as spy:
                out = srv.step(prefill_work=slot)      # ends in its fetch
            fused_ms.append((time.perf_counter() - t0) * 1e3)
            fused_fetch.append((spy.count, srv.device_fetches - f0))
            if first_tick is None:
                first_tick = len(rec.seen) - 1   # the decode rows' pick
                inputs["fused"] = before
            for s, t in out.items():
                streams.setdefault(s, []).append(t)
    prof_fused.__exit__(None, None, None)
    fused_s = time.perf_counter() - t_fused
    # Picks kept: every admission's [1, V] row, and the first fused
    # tick's decode rows; the later fused ticks' picks are dropped.
    adm = [i for i, x in enumerate(rec.seen) if x.shape[0] == 1]
    keep = sorted(set(adm) | {first_tick})
    logits = [rec.seen[i] for i in keep]
    rec.record, rec.seen = False, []
    verify = {}
    if mode == "spec":
        inner = srv._spec_verify

        def spec_verify(block, base):
            tl = inner(block, base)
            if not verify:
                verify.update(block=block.clone(), tl=tl.float().clone())
            return tl
        srv._spec_verify = spec_verify
    round_ms, round_fetch, emitted = [], [], 0
    inputs["step"] = {s: v[-1] for s, v in streams.items()}
    for r in range(rounds):
        if r == 0 and mode == "kvq":
            rec.record = True
        f0 = srv.device_fetches
        t0 = time.perf_counter()
        with FetchSpy(torch) as spy:
            out = srv.step()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        round_fetch.append((spy.count, srv.device_fetches - f0))
        rec.record = False
        for s, t in out.items():
            t = t if isinstance(t, list) else [t]
            streams[s].extend(t)
            emitted += len(t)
    # Two more rounds (ticks) under the profiler, outside the timed ones.
    with DeviceProfile(2) as prof_step:
        for _ in range(2):
            for s, t in srv.step().items():
                streams[s].extend(t if isinstance(t, list) else [t])
    torch.cuda.synchronize()
    res = {"streams": streams, "logits": logits, "inputs": inputs,
           "first_tick_rows": sorted(inputs["fused"]),
           "verify": verify, "step_logits": rec.seen,
           "admit_s": admit_s, "fused_s": fused_s, "fused_ms": fused_ms,
           "fused_fetch": fused_fetch, "fused_ms_unprofiled":
           fused_ms[:n_plain], "fused_profile": prof_fused.stats,
           "step_profile": prof_step.stats, "round_ms": round_ms,
           "round_fetch": round_fetch, "emitted": emitted,
           "accept_rate": (srv.spec_accept_rate() if mode == "spec"
                           else None),
           "fetches": srv.device_fetches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "lengths": srv.cache.host_lengths().tolist()}
    # The verify wrapper above closes over the server: break the cycle
    # so its pools are freed now, before the next server allocates.
    srv.__dict__.pop("_spec_verify", None)
    del srv, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


def llama_logit_checks(torch, run, ref, mode):
    """Largest |run - ref| / max |ref| of each compared logits row:
    every admission, the first fused tick's decode rows, and (a) the
    first verify's positions whose block prefix both servers share or
    (b) the first decode tick's rows whose input token both share."""
    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("served logits are not finite")
        return ((a - b).abs().max() / b.abs().max()).item()

    if len(run["logits"]) != len(ref["logits"]):
        raise AssertionError("the two servers recorded different picks")
    out = {"admissions": [], "first_fused_tick": [], "first_step": []}
    for a, b in zip(run["logits"], ref["logits"]):
        if a.shape != b.shape:
            raise AssertionError("served logits are not shaped alike")
        if a.shape[0] == 1:
            out["admissions"].append(rel(a, b))
        else:
            for s in run["first_tick_rows"]:
                if run["inputs"]["fused"][s] == ref["inputs"]["fused"][s]:
                    out["first_fused_tick"].append(rel(a[s], b[s]))
    if mode == "spec":
        ba, bb = run["verify"]["block"], ref["verify"]["block"]
        for s in range(ba.shape[0]):
            for j in range(ba.shape[1]):
                if not torch.equal(ba[s, :j + 1], bb[s, :j + 1]):
                    break
                out["first_step"].append(rel(run["verify"]["tl"][s, j],
                                             ref["verify"]["tl"][s, j]))
    else:
        a, b = run["step_logits"][0], ref["step_logits"][0]
        for s, t in run["inputs"]["step"].items():
            if t == ref["inputs"]["step"][s]:
                out["first_step"].append(rel(a[s], b[s]))
    if len(out["admissions"]) != 8 or not out["first_fused_tick"] \
            or not out["first_step"]:
        raise AssertionError(f"too few logits rows compared: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    return out


def q8_case(q8, F, torch, dev, flush, name, w, C, shared, act="silu",
            seed=5, fault=False):
    """One q8_expert_ffn case at Mixtral width: ``w`` is one layer's
    int8 expert leaves (wg, sg, wu, su, wd, sd); x [C, Dm] bf16 (one
    block every expert runs, dense dispatch) or [E, C, Dm] (per-expert
    queues). With ``fault``, two experts' down-projection scales are
    swapped and the same check must reject the kernel's output."""
    wg, sg, wu, su, wd, sd = w
    E, Dm, Fd = wg.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (C, Dm) if shared else (E, C, Dm)
    x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    got = q8.q8_expert_ffn(x, *w, act=act)
    want = q8.q8_expert_ffn_reference(x, *w, act=act)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"q8_expert_ffn {name}: {cmp}")
    flips = int((got != want).sum())   # bf16 outputs rounded the other way
    fault_ratio = None
    if fault:
        bad = sd.clone()
        bad[[0, 1]] = sd[[1, 0]]
        fault_ratio = compare(q8.q8_expert_ffn(x, wg, sg, wu, su, wd, bad,
                                               act=act), want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"q8_expert_ffn {name}: the check missed "
                                 f"two swapped expert scales ({fault_ratio})")
    del got, want
    iters = 3 if C >= 512 else 10
    ms = time_ms(lambda: q8.q8_expert_ffn(x, *w, act=act), iters, flush)
    plain_ms = time_ms(lambda: q8.q8_expert_ffn_reference(x, *w, act=act),
                       3, flush)
    act_fn = functools.partial(q8._apply_act, act)

    def library():
        # dequant_hook's widening, then cuBLAS for the three products.
        bf = torch.bfloat16
        wgb, wub, wdb = ((a.float() * s).to(bf) for a, s in
                         ((wg, sg), (wu, su), (wd, sd)))
        return torch.matmul(act_fn(torch.matmul(x, wgb))
                            * torch.matmul(x, wub), wdb)

    library_ms = time_ms(library, 3, flush)
    # Device time of each of the kernel's two passes (one profiled call).
    with DeviceProfile(1) as prof:
        q8.q8_expert_ffn(x, *w, act=act)
    pass_ms = {k: v for k, v in prof.stats["top_kernels_ms_per_tick"].items()
               if "q8_pass" in k}
    tokens = C * (1 if shared else E)          # rows each expert runs
    flops = 2 * 3 * Dm * Fd * (C * E if shared else tokens)
    nbytes = (x.numel() * 2 + 3 * E * Dm * Fd + 4 * E * (2 * Fd + Dm)
              + E * C * Dm * 2)
    bms, by = bound(flops, nbytes)
    row = {"phase": "kernels", "kernel": "q8_expert_ffn", "case": name,
           "E": E, "C": C, "x": "shared" if shared else "per_expert",
           "Dm": Dm, "F": Fd, "act": act, **cmp,
           "flips": flips, "elements": E * C * Dm,
           "fault_ulp_ratio": fault_ratio, "ms": ms, "pass_ms": pass_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_calls": "widen (dequant_hook math), 3 torch.matmul",
           "bound_ms": bms, "bound_by": by, "tflops": flops / ms / 1e9,
           "gb_s": nbytes / ms / 1e6}
    emit(row)
    return row


def flash_decode_case(fa, F, torch, np, dev, flush, name, pos, M, H, Hkv, D,
                      window=None, softcap=None, seed=6, fault=False):
    """One flash_decode case over contiguous rows [B, M, Hkv, D] at the
    given positions. ``fault``: the kernel attends pos + 1 (one position
    too many); the same check must reject it. Two launches must give
    equal bits; the row adds the split count, the split and merge
    kernels' device time and a call's host time."""
    B = len(pos)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    k = torch.randn(B, M, Hkv, D, generator=g, device=dev).to(bf)
    v = torch.randn(B, M, Hkv, D, generator=g, device=dev).to(bf)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(bf)
    pos_t = torch.as_tensor(np.asarray(pos, np.int32), device=dev)
    kw = dict(window=window, attn_softcap=softcap)
    got = fa.flash_decode(q, k, v, pos_t, **kw)
    want = fa.flash_decode_plain(q, k, v, pos_t, **kw)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"flash_decode {name}: {cmp}")
    fault_ratio = None
    if fault:
        fault_ratio = compare(fa.flash_decode(q, k, v, pos_t + 1, **kw),
                              want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"flash_decode {name}: the check missed a "
                                 f"row attending pos + 1 ({fault_ratio})")

    def run():
        return fa.flash_decode(q, k, v, pos_t, **kw)
    if not torch.equal(run(), got):
        raise AssertionError(f"flash_decode {name}: two launches on the "
                             f"same inputs differ")
    splits = fa.decode_splits(B, H, Hkv, M, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    split_ms = kernel_ms(run, "split_kernel", "merge_kernel")
    call_us = host_us(run)
    ms = time_ms(run, 30, flush)
    plain_ms = time_ms(lambda: fa.flash_decode_plain(q, k, v, pos_t, **kw),
                       10, flush)
    # The one PyTorch call: flex_attention with the softcap as its
    # score_mod and the row's live range as its block mask.
    pl = pos_t.long()

    def mask_mod(b, h, q_idx, kv_idx):
        keep = kv_idx <= pl[b]
        if window:
            keep = keep & (kv_idx > pl[b] - window)
        return keep

    # Beside it, SDPA at the same shape and mask without the softcap (a
    # stated proxy).
    kpos = torch.arange(M, device=dev)
    mask = kpos <= pl[:, None]
    if window:
        mask &= kpos > pl[:, None] - window
    mask = mask[:, None, None]                          # [B, 1, 1, M]
    kt, vt, qt = k.transpose(1, 2), v.transpose(1, 2), q.transpose(1, 2)
    proxy_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 30, flush)
    p = np.asarray(pos, np.int64)
    lo = np.maximum(0, p - window + 1) if window else np.zeros_like(p)
    live = int((np.minimum(p + 1, M) - lo).sum())
    nbytes = 2 * live * Hkv * D * 2 + 2 * B * H * D * 2 + B * 4
    flops = 4 * live * H * D
    bms, by = bound(flops, nbytes)
    row = {"phase": "kernels", "kernel": "flash_decode", "case": name,
           "B": B, "M": M, "H": H, "Hkv": Hkv, "D": D, "max_pos": int(p.max()),
           "live_rows": live, "window": window, "softcap": softcap, **cmp,
           "fault_ulp_ratio": fault_ratio, "ms": ms, "splits": splits,
           "bit_equal": True, "kernel_ms": split_ms, "host_us": call_us,
           "plain_ms": plain_ms,
           "library_ms": None,
           "library_calls": "flex_attention (torch.compile; softcap "
                            "score_mod, block mask)",
           "library_err": None, "library_error": None,
           "flex_compile_s": None,
           "library_ms_no_softcap": proxy_ms,
           "library_no_softcap_calls": "SDPA, same mask, no softcap (proxy)",
           "bound_ms": bms, "bound_by": by,
           "gb_s": nbytes / ms / 1e6}
    flex_later(row, torch, dev, flush, f"flash_decode {name}", q, k, v,
               softcap, mask_mod, 1, want, 30)
    emit(row)
    return row


def compare_parts(got, want):
    """``compare`` under the f32-sum rule over tuples of outputs: the
    worst of each column."""
    rows = [compare(a, b, F32_SUM_FLOOR) for a, b in zip(got, want)]
    return {k: max(r[k] for r in rows) for k in rows[0]}


def bf16_inputs(torch, dev, seed, shapes):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
            for s in shapes]


def check_case(failures, what, cmp, fault_cmp, fault_name):
    """The gate and its planted fault: the kernel must pass the
    per-element rule and the faulted run must fail the same rule. A
    breach is added to ``failures``: main raises on them before it
    prints a result, after every reading of the run is out."""
    if not (cmp["ulp_ratio"] <= 1.0):
        failures.append(f"{what}: {cmp}")
    if not (fault_cmp["ulp_ratio"] > 1.0):
        failures.append(f"{what}: the check missed {fault_name} "
                        f"({fault_cmp})")


def attention_layer_cases(fa, torch, dev, flush, failures, name, S, H, Hkv,
                          D, window, softcap, flex=False, B=1):
    """Case (a): a training step's attention layer on one card, B rows,
    q and K/V over the whole sequence (a one-rank ring is one hop at
    offsets 0).
    flash_attention_partial against its plain version (fault: k_offset
    + 1), then flash_attention_bwd from that pass's lse and dsum
    (fault: a zero dsum, the term a kernel could drop). Both have a
    softcap, which SDPA lacks; with ``flex`` (the global case) their
    library times are flex_attention's under torch.compile (forward
    with the lse; its backward), queued for the flex phase, else
    null."""
    q, k, v, do = bf16_inputs(torch, dev, 7, [(B, S, H, D), (B, S, Hkv, D),
                                               (B, S, Hkv, D), (B, S, H, D)])
    kw = dict(q_offset=0, k_offset=0, window=window, attn_softcap=softcap)
    got = fa.flash_attention_partial(q, k, v, **kw)
    want = fa.flash_attention_partial_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    cmp = compare_parts(got, want)
    fault = compare_parts(fa.flash_attention_partial(
        q, k, v, **dict(kw, k_offset=1)), want)
    check_case(failures, f"flash_attention_partial {name}", cmp, fault,
               "k_offset + 1")
    del got
    acc, m, l = want
    lse = m + torch.log(l)
    out = acc / l.transpose(1, 2)[..., None]
    dsum = fa.softmax_dsum(do, out)
    del want, acc, m, l
    gotb = fa.flash_attention_bwd(q, k, v, do, lse, dsum, **kw)
    wantb = fa.flash_attention_bwd_plain(q, k, v, do, lse, dsum, **kw)
    torch.cuda.synchronize()
    cmpb = compare_parts(gotb, wantb)
    faultb = compare_parts(fa.flash_attention_bwd(
        q, k, v, do, lse, torch.zeros_like(dsum), **kw), wantb)
    check_case(failures, f"flash_attention_bwd {name}", cmpb, faultb,
               "a zero dsum")
    del gotb
    pairs = B * H * causal_pairs(S, S, 0, window)
    rows = []
    for kernel, fn, plain, flops, nbytes, c, f in (
            ("flash_attention_partial",
             lambda: fa.flash_attention_partial(q, k, v, **kw),
             lambda: fa.flash_attention_partial_plain(q, k, v, **kw),
             4 * D * pairs,
             B * (2 * (S * H * D + 2 * S * Hkv * D)
                  + 4 * (S * H * D + 2 * H * S)),
             cmp, fault),
            ("flash_attention_bwd",
             lambda: fa.flash_attention_bwd(q, k, v, do, lse, dsum, **kw),
             lambda: fa.flash_attention_bwd_plain(q, k, v, do, lse, dsum,
                                                  **kw),
             # The five products a gradient needs: s, dp, dv, dq, dk.
             10 * D * pairs,
             B * (2 * (2 * S * H * D + 2 * S * Hkv * D) + 4 * 2 * H * S
                  + 4 * (S * H * D + 2 * S * Hkv * D)),
             cmpb, faultb)):
        bms, by = bound(flops, nbytes)
        ms = time_ms(fn, 5, flush)
        row = {"phase": "kernels", "kernel": kernel, "case": name, "B": B,
               "S": S, "H": H, "Hkv": Hkv, "D": D, "window": window,
               "softcap": softcap, **c, "fault_ulp_ratio": f["ulp_ratio"],
               "ms": ms, "plain_ms": time_ms(plain, 3, flush),
               "library_ms": None,
               "library_calls": "flex_attention (torch.compile; softcap "
                                "score_mod, causal block mask)"
                                + ("; forward with the lse"
                                   if kernel == "flash_attention_partial"
                                   else "; its backward") if flex else None,
               "library_err": None, "library_error": None,
               "flex_compile_s": None, "bound_ms": bms,
               "bound_by": by, "tflops": flops / ms / 1e9}
        rows.append(row)
    if flex:
        def mask_mod(b, h, q_idx, kv_idx):
            keep = kv_idx <= q_idx
            if window:
                keep = keep & (kv_idx > q_idx - window)
            return keep
        flex_later(rows[0], torch, dev, flush,
                   f"flash_attention_partial {name}", q, k, v, softcap,
                   mask_mod, S, out, 5, lse=True)
        flex_later(rows[1], torch, dev, flush, f"flash_attention_bwd {name}",
                   q, k, v, softcap, mask_mod, S, None, 5, grad=(do, wantb))
    del wantb, out
    for row in rows:
        emit(row)
    return rows


def ring_cases(fa, ring, F, torch, dev, flush, failures, n, Sc, H, Hkv,
               D):
    """Case (b): a ring of n hops on one card, Llama-3-8B geometry, n
    shards of Sc positions. Each shard's q runs against each K/V chunk
    at its offsets (the wholly-future chunks too), merged with the
    ring's own merge; the merged (acc, m, l) is held against the plain
    pass over the whole sequence (fault: every k_offset + 1). Then the
    ring's gradient: dq summed over a shard's hops, dk/dv summed over
    the shards per chunk, against the plain gradient summed the same way
    (fault: a zero dsum). Library: SDPA over the whole sequence, forward
    and (through autograd) backward — no softcap here."""
    S = n * Sc
    q, k, v, do = bf16_inputs(torch, dev, 8, [(1, S, H, D), (1, S, Hkv, D),
                                               (1, S, Hkv, D), (1, S, H, D)])
    cut = [slice(i * Sc, (i + 1) * Sc) for i in range(n)]
    qs, ks, vs, dos = ([x[:, c].contiguous() for c in cut]
                       for x in (q, k, v, do))

    def ring_fwd(fn, shift=0):
        out = []
        for i in range(n):
            st = ring.empty_state(qs[i])
            for j in range(n):
                st = ring.merge_partial(st, fn(qs[i], ks[j], vs[j],
                                               q_offset=i * Sc,
                                               k_offset=j * Sc + shift))
            out.append(st)
        return out

    whole = [fa.flash_attention_partial_plain(qs[i], k, v, q_offset=i * Sc)
             for i in range(n)]
    cmp = compare_parts([t for st in ring_fwd(fa.flash_attention_partial)
                         for t in st], [t for st in whole for t in st])
    fault = compare_parts([t for st in ring_fwd(fa.flash_attention_partial,
                                                shift=1) for t in st],
                          [t for st in whole for t in st])
    check_case(failures, "flash_attention_partial ring", cmp, fault,
               "k_offset + 1")
    lse, dsum = [], []
    for i, (acc, m, l) in enumerate(whole):
        lse.append(m + torch.log(l))
        dsum.append(fa.softmax_dsum(dos[i], acc / l.transpose(1, 2)[..., None]))
    del whole

    def ring_bwd(fn, zero_dsum=False):
        dq = [0.0] * n
        dk, dv = [0.0] * n, [0.0] * n
        for i in range(n):
            ds = torch.zeros_like(dsum[i]) if zero_dsum else dsum[i]
            for j in range(n):
                a, b, c = fn(qs[i], ks[j], vs[j], dos[i], lse[i], ds,
                             q_offset=i * Sc, k_offset=j * Sc)
                dq[i], dk[j], dv[j] = dq[i] + a, dk[j] + b, dv[j] + c
        return dq + dk + dv

    wantb = ring_bwd(fa.flash_attention_bwd_plain)
    cmpb = compare_parts(ring_bwd(fa.flash_attention_bwd), wantb)
    faultb = compare_parts(ring_bwd(fa.flash_attention_bwd, True), wantb)
    check_case(failures, "flash_attention_bwd ring", cmpb, faultb,
               "a zero dsum")
    del wantb

    def all_hops(fn):
        def run():
            for i in range(n):
                for j in range(n):
                    fn(i, j)
        return run

    part = all_hops(lambda i, j: fa.flash_attention_partial(
        qs[i], ks[j], vs[j], q_offset=i * Sc, k_offset=j * Sc))
    part_plain = all_hops(lambda i, j: fa.flash_attention_partial_plain(
        qs[i], ks[j], vs[j], q_offset=i * Sc, k_offset=j * Sc))
    bwd = all_hops(lambda i, j: fa.flash_attention_bwd(
        qs[i], ks[j], vs[j], dos[i], lse[i], dsum[i], q_offset=i * Sc,
        k_offset=j * Sc))
    bwd_plain = all_hops(lambda i, j: fa.flash_attention_bwd_plain(
        qs[i], ks[j], vs[j], dos[i], lse[i], dsum[i], q_offset=i * Sc,
        k_offset=j * Sc))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    out_t = sdpa()
    do_t = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), do_t, retain_graph=True), 5, flush)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 5, flush)
    pairs = H * causal_pairs(S, S, 0, None)
    rows = []
    for kernel, fn, plain, lib, flops, nbytes, c, f in (
            ("flash_attention_partial", part, part_plain, lib_fwd,
             4 * D * pairs,
             2 * (S * H * D + 2 * S * Hkv * D) + 4 * (S * H * D + 2 * H * S),
             cmp, fault),
            ("flash_attention_bwd", bwd, bwd_plain, lib_bwd, 10 * D * pairs,
             2 * (2 * S * H * D + 2 * S * Hkv * D) + 4 * 2 * H * S
             + 4 * (S * H * D + 2 * S * Hkv * D), cmpb, faultb)):
        bms, by = bound(flops, nbytes)
        ms = time_ms(fn, 5, flush)
        row = {"phase": "kernels", "kernel": kernel,
               "case": f"llama3_8b_ring{n}x{Sc}", "S": S, "H": H, "Hkv": Hkv,
               "D": D, "hops": n * n, **c, "fault_ulp_ratio": f["ulp_ratio"],
               "ms": ms, "plain_ms": time_ms(plain, 3, flush),
               "library_ms": lib, "library_calls": "SDPA causal, whole "
               "sequence" + (" (backward through autograd)"
                             if kernel == "flash_attention_bwd" else ""),
               "bound_ms": bms, "bound_by": by, "tflops": flops / ms / 1e9}
        emit(row)
        rows.append(row)
    return rows


class StepClock:
    """A train step wrapped to keep each call's host-clock ms, ended by a
    device sync (the step's work is done when the clock stops)."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *a, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def tree_keys(tree, prefix=""):
    """Leaf paths of a nested dict in ``training.tree_leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_keys(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k


def grad_rel_l2(training, got, want):
    """Per-leaf ||got - want|| / ||want|| (f32) over two gradient trees."""
    return {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
            for name, a, b in zip(tree_keys(want), training.tree_leaves(got),
                                  training.tree_leaves(want))}


def mixtral_int8_params(torch, quant, cfg, gen, dev):
    """Random Mixtral-width weights from ``gen``, made one layer (one
    expert) at a time and quantized as they are made, so no bf16 expert
    tree ever exists (``tools/multichip.py``'s ``moe_weights``):
    attention and expert leaves int8 + f32 scales, router, norms, embed
    and unembed bf16."""
    import importlib
    mc = importlib.import_module("tpushare_torch.tools.multichip")
    return mc.moe_weights(cfg, gen, dev)


def moe_widths(serving, paged, whole, chunked, prefix_hit, chunk, bs,
               max_len, mb):
    """Token-block sizes C the two slice_moe servers hand the q8 kernel
    (dense dispatch: every expert runs all B x S tokens of a forward),
    from the servers' own padding rules: whole admissions, fused ticks
    (8 rows x the chunk width), the prefix-hit admission and decode
    ticks (8 rows)."""
    rows, pg = {8}, {8}
    for S in whole:
        rows.add(min(serving.bucket_len(S), max_len))
        pg.add(paged.admission_len(S, 0, bs, mb)[1])
    for S in chunked:
        for gran, out in ((1, rows), (bs, pg)):
            done = 0
            while done < S:
                done, width = serving.fused_chunk_span(done, S, chunk, None,
                                                       gran=gran)
                out.add(8 * width)
    S, p = prefix_hit
    rows.add(serving.bucket_len(S - p))
    cached = p // bs * bs
    pg.add(paged.admission_len(S, cached, bs, mb)[1] - cached)
    return sorted(rows), sorted(pg)


class Routes:
    """The MoE router's top-k while it is patched (moe.top_k_lower_index,
    for the with-block): per forward, every layer's expert ids. A
    forward starts at each call of a function passed through ``wrap``:
    a server's forward, or one whole forward (and backward) of a
    gradient twin (remat off: one top-k per layer). Under a server
    (``srv`` set), also the batch rows that carry real tokens, each with
    its count of real columns (an active decode row 1, an admitting row
    its chunk's prompt tokens). With ``replay`` (another run's
    ``calls``), every layer routes its tokens to the experts that run
    chose (its tokens, under expert_choice), the weights renormalized
    from this run's own router probabilities; the ids recorded stay
    this run's own choice, so a replaying twin's record says where it
    alone would have routed otherwise."""

    def __init__(self, moe, replay=None):
        self.moe, self.replay, self.calls, self.rows = moe, replay, [], []
        self.srv = None

    def wrap(self, fn):
        def call(*a, **kw):
            self.calls.append([])
            srv = self.srv
            if srv is not None:
                import numpy as np
                real = {int(r): 1 for r in np.nonzero(srv.active)[0]}
                for r, st in srv._admissions.items():
                    real[r] = min(st["chunk"],
                                  len(st["prompt"]) - st["done"])
                self.rows.append(real)
            return fn(*a, **kw)
        return call

    def top_k(self, probs, k):
        import torch
        vals, idx = self.orig(probs, k)
        layers = self.calls[-1]
        layers.append(idx)
        if self.replay is None:
            return vals, idx
        want = self.replay[len(self.calls) - 1][len(layers) - 1]
        if want.shape != idx.shape:
            raise AssertionError("the replaying twin's forwards differ in "
                                 "shape from the recorded run's")
        return torch.gather(probs, -1, want), want

    def flips(self):
        """Share of routed entries where this run alone chose otherwise
        than the run it replays."""
        pairs = [(a, b) for got, want in zip(self.calls, self.replay)
                 for a, b in zip(got, want)]
        diff = sum(int((a.sort(-1).values != b.sort(-1).values).sum())
                   for a, b in pairs)
        return diff / sum(int(a.numel()) for a, _ in pairs)

    def __enter__(self):
        self.orig = self.moe.top_k_lower_index
        self.moe.top_k_lower_index = self.top_k
        return self

    def __exit__(self, *exc):
        self.moe.top_k_lower_index = self.orig


class ForwardRecorder(RecordingSampler):
    """RecordingSampler that also keeps, per recorded pick, the index of
    the forward that produced its logits."""

    def __init__(self, inner, routes):
        super().__init__(inner)
        self.routes, self.fwd = routes, []

    def pick(self, logits):
        if self.record:
            self.fwd.append(len(self.routes.calls) - 1)
        return super().pick(logits)


def serve_moe(torch, moe, paged, cfg, params, sched, *, kind, hook,
              attn_impl, replay=None):
    """Drive one Mixtral server through slice_moe: 3 whole admissions, 2
    admissions by fused ticks (256-token chunks beside the decode rows),
    a 4th whole admission, 16 decode ticks (+2 profiled), evict every
    slot, one admission that reuses >= 512 tokens of a cached prefix.
    ``kind`` "rows": MoESlotServer over dense KV rows; "paged":
    PagedSlotServer(forward_fn=moe.paged_forward). ``replay``: a run's
    routes to follow (``Routes``). Returns streams, the recorded logits
    with the forward of each, per-forward routes, timings, fetch counts
    and peak memory."""
    with Routes(moe, replay) as routes:
        return _serve_moe(torch, moe, paged, cfg, params, sched, routes,
                          kind=kind, hook=hook, attn_impl=attn_impl)


def _serve_moe(torch, moe, paged, cfg, params, sched, routes, *, kind, hook,
               attn_impl):
    import numpy as np
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    common = dict(prefix_cache=True, layers_hook=hook, attn_impl=attn_impl)
    if kind == "rows":
        srv = moe.MoESlotServer(params, cfg, n_slots=8,
                                max_len=sched["max_len"], **common)
        srv._fwd = routes.wrap(srv._fwd)
    else:
        srv = paged.PagedSlotServer(
            params, cfg, n_slots=8, n_blocks=8 * sched["mb"] + 1,
            block_size=16, max_blocks_per_slot=sched["mb"],
            forward_fn=routes.wrap(moe.paged_forward), **common)
    routes.srv = srv
    rec = ForwardRecorder(srv._sampler, routes)
    srv._sampler = rec
    streams, inputs, fetch = {}, {}, {"fused": [], "tick": []}

    def admit(p):
        slot = srv.admit(p)
        streams[slot] = [int(srv.last_token[slot, 0].item())]
        return slot

    torch.cuda.synchronize()
    rec.record = True
    t0 = time.perf_counter()
    for p in sched["whole"][:3]:
        admit(p)
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    fused_ms = []
    for p in sched["chunked"]:
        slot = srv.admit_start(p, chunk_tokens=sched["chunk"])
        while slot in srv._admissions:
            if fused_ms:
                rec.record = False
            else:
                inputs["fused"] = {s: v[-1] for s, v in streams.items()}
            f0 = srv.device_fetches
            t0 = time.perf_counter()
            with FetchSpy(torch) as spy:
                out = srv.step(prefill_work=slot)      # ends in its fetch
            fused_ms.append((time.perf_counter() - t0) * 1e3)
            fetch["fused"].append((spy.count, srv.device_fetches - f0))
            for s, t in out.items():
                streams.setdefault(s, []).append(t)
    rec.record = True
    t0 = time.perf_counter()
    admit(sched["whole"][3])
    torch.cuda.synchronize()
    admit_s += time.perf_counter() - t0
    tick_ms = []
    inputs["tick"] = {s: v[-1] for s, v in streams.items()}
    for t in range(sched["ticks"]):
        f0 = srv.device_fetches
        t0 = time.perf_counter()
        with FetchSpy(torch) as spy:
            out = srv.step()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        fetch["tick"].append((spy.count, srv.device_fetches - f0))
        rec.record = False
        for s, tok in out.items():
            streams[s].append(tok)
    with DeviceProfile(2) as prof:
        for _ in range(2):
            for s, tok in srv.step().items():
                streams[s].append(tok)
    for s in [int(x) for x in np.nonzero(srv.active)[0]]:
        srv.evict(s)
    rec.record = True
    t0 = time.perf_counter()
    slot = admit(sched["prefix_prompt"])
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t0
    rec.record = False
    res = {"streams": streams, "logits": rec.seen, "fwd": rec.fwd,
           "routes": routes.calls, "route_rows": routes.rows,
           "inputs": inputs,
           "prefix_cached_len": srv.last_cached_len,
           "admit_s": admit_s, "prefix_admit_s": prefix_s,
           "fused_ms": fused_ms, "tick_ms": tick_ms, "fetch": fetch,
           "profile": prof.stats, "forwards": len(routes.calls),
           "fetches": srv.device_fetches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del srv, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


def route_diff(a, b, real):
    """Share of one forward's real (token, layer) pairs whose top-k
    expert SET differs between two runs: a one-row forward (an
    admission) counts every position; a batch forward the real columns
    of its rows (``Routes``: the junk a padded or idle row computes
    differs between a kernel server and its reference twin, which read
    unwritten KV differently)."""
    n = bad = 0
    for x, y in zip(a, b):
        pairs = ([(x, y)] if x.shape[0] == 1 else
                 [(x[r, :c], y[r, :c]) for r, c in real.items()])
        for xs, ys in pairs:
            diff = (xs.sort(-1).values != ys.sort(-1).values).any(-1)
            n += diff.numel()
            bad += int(diff.sum().item())
    return bad / max(n, 1)


def served_logit_checks(torch, run, ref, tol, routes=False):
    """Largest |run - ref| / max |ref| of each recorded logits row: every
    admission ([1, V] picks) and the first fused and decode ticks' rows
    whose input token both servers share; with ``routes``, each reading
    carries the share of (token, layer) pairs whose expert set differs
    in the forward behind it. Returns (readings, the worst); the
    caller holds the worst to its limit."""
    if len(run["logits"]) != len(ref["logits"]):
        raise AssertionError("the two servers recorded different picks")
    out = {"admissions": [], "first_fused_tick": [], "first_tick": []}
    ticks = iter(("fused", "tick"))
    for i, (a, b) in enumerate(zip(run["logits"], ref["logits"])):
        if a.shape != b.shape:
            raise AssertionError("served logits are not shaped alike")
        if not torch.isfinite(a).all():
            raise AssertionError("served logits are not finite")
        f = run["fwd"][i] if routes else None
        diff = (route_diff(run["routes"][f], ref["routes"][ref["fwd"][i]],
                           run["route_rows"][f]) if routes else None)
        if a.shape[0] == 1:
            rels = [((a - b).abs().max() / b.abs().max()).item()]
            key = "admissions"
        else:
            which = next(ticks)
            key = "first_fused_tick" if which == "fused" else "first_tick"
            rels = [((a[s] - b[s]).abs().max() / b[s].abs().max()).item()
                    for s, t in run["inputs"][which].items()
                    if ref["inputs"][which].get(s) == t]
        out[key] += [{"rel": r, "route_diff_share": diff} for r in rels]
    if not all(out.values()):
        raise AssertionError(f"too few logits rows compared: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    worst = max(r["rel"] for v in out.values() for r in v)
    return out, worst


def serve_rows(torch, serving, cfg, params, sched, *, attn_impl):
    """Drive Gemma-2-2B through slice_rows on serving.SlotServer (8 slots
    over dense rows of max_len 8192): 5 whole admissions (the longest in
    ``prefill_chunk`` pieces), one admission finished by one fused tick,
    16 decode ticks (+2 profiled), evict."""
    import numpy as np
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = serving.SlotServer(params, cfg, n_slots=8,
                             max_len=sched["max_len"],
                             prefill_chunk=sched["prefill_chunk"],
                             attn_impl=attn_impl)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    streams, inputs, fetch = {}, {}, {"fused": [], "tick": []}
    torch.cuda.synchronize()
    rec.record = True
    t0 = time.perf_counter()
    for p in sched["whole"]:
        slot = srv.admit(p)
        streams[slot] = [int(srv.last_token[slot, 0].item())]
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    inputs["fused"] = {s: v[-1] for s, v in streams.items()}
    slot = srv.admit_start(sched["fused_prompt"],
                           chunk_tokens=sched["chunk"])
    f0 = srv.device_fetches
    t0 = time.perf_counter()
    with FetchSpy(torch) as spy:
        out = srv.step(prefill_work=slot)
    fused_ms = (time.perf_counter() - t0) * 1e3
    fetch["fused"].append((spy.count, srv.device_fetches - f0))
    if slot in srv._admissions:
        raise AssertionError("the fused tick did not finish its admission")
    for s, t in out.items():
        streams.setdefault(s, []).append(t)
    inputs["tick"] = {s: v[-1] for s, v in streams.items()}
    tick_ms = []
    for _ in range(sched["ticks"]):
        f0 = srv.device_fetches
        t0 = time.perf_counter()
        with FetchSpy(torch) as spy:
            out = srv.step()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        fetch["tick"].append((spy.count, srv.device_fetches - f0))
        rec.record = False
        for s, tok in out.items():
            streams[s].append(tok)
    with DeviceProfile(2) as prof:
        for _ in range(2):
            for s, tok in srv.step().items():
                streams[s].append(tok)
    lengths = srv._lengths_np.tolist()
    for s in [int(x) for x in np.nonzero(srv.active)[0]]:
        srv.evict(s)
    res = {"streams": streams, "logits": rec.seen, "inputs": inputs,
           "admit_s": admit_s, "fused_ms": fused_ms, "tick_ms": tick_ms,
           "fetch": fetch, "profile": prof.stats, "lengths": lengths,
           "fetches": srv.device_fetches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del srv, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- slice_engine: the serving engine over real HTTP ---------------------

# Engine A's streams against the directly driven server: where two part,
# the direct run's top-two logit gap at that position must lie within the
# served-logits gate (LOGIT_REL_TOL of the largest |logit|), the margin a
# rounding flip between two batch compositions can cross; counted as
# flips.
# The sampler's law on the card: 2^16 draws per row; the TV distance to
# the filtered softmax computed by the plain CPU path. The null TV of
# 2^16 draws over <= 64 tokens is ~0.012; the limit is 2.5x that. The
# planted fault (no top-p mask) at top_p 0.7 moves ~0.3 of the mass.
SAMPLER_DRAWS = 1 << 16
SAMPLER_TV_TOL = 0.03
ENGINE_ARGV = ["--preset", "gemma_2b", "--n-slots", "8", "--n-blocks",
               "1024", "--block-size", "16", "--port", "0", "--seed", "0"]
ENGINE_B_ARGV = ["--draft-preset", "int8-self", "--gamma", "4",
                 "--temperature", "0.8", "--top-k", "64", "--top-p", "0.95"]


class TickClock:
    """Wraps an engine's ``_tick``: the wall ms of every tick that ran a
    dispatch (work_ticks moved) with the count of active slots, and an
    event set once ``work_ticks`` reaches ``until``."""

    def __init__(self, eng):
        self.eng, self.ms, self.active = eng, [], []
        self.until, self.reached = None, threading.Event()
        inner = eng._tick

        def tick(gen=None):
            w0 = eng._stats["work_ticks"]
            t0 = time.perf_counter()
            inner(gen)
            if eng._stats["work_ticks"] > w0:
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.active.append(len(eng._active))
            if self.until is not None and \
                    eng._stats["work_ticks"] >= self.until:
                self.reached.set()
        eng._tick = tick

    def full_ms(self, n_slots):
        """Tick ms over the ticks that ran with every slot decoding."""
        return [m for m, a in zip(self.ms, self.active) if a >= n_slots]


def stop_engine(httpd, eng):
    """Shut the HTTP server, then the engine: ServeEngine.stop() joins
    every thread it started (within its bound), and the next engine is
    never built over one still running."""
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
    eng.stop()
    alive = eng.live_threads()
    if alive:
        raise AssertionError(f"engine threads still running after stop(): "
                             f"{alive}")


def http_post(port, body, idem=None, timeout=600):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    headers = {"Content-Type": "application/json"}
    if idem:
        headers["Idempotency-Key"] = idem
    conn.request("POST", "/v1/completions", json.dumps(body).encode(),
                 headers)
    return conn, conn.getresponse()


def http_json(port, method, path, body=None, idem=None, timeout=600):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        headers = {"Content-Type": "application/json"}
        if idem:
            headers["Idempotency-Key"] = idem
        conn.request(method, path,
                     None if body is None else json.dumps(body).encode(),
                     headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def sse_frames(resp, limit=None):
    """Token frames (raw bytes, the resume comparison surface) and
    events of an SSE response, reading up to ``limit`` token events."""
    frames, events, buf = [], [], b""
    while limit is None or len(frames) < limit:
        line = resp.readline()
        if not line:
            break
        buf += line
        if line == b"\n":
            raw = buf.strip()
            buf = b""
            for ln in raw.splitlines():
                if ln.startswith(b"data: "):
                    ev = json.loads(ln[len(b"data: "):])
                    events.append(ev)
                    if "token" in ev:
                        frames.append(raw + b"\n\n")
            if events and ("done" in events[-1] or "error" in events[-1]):
                break
    return frames, events


def engine_a_requests(port, prompts, max_tokens):
    """Engine A's traffic, all concurrent: 8 completions, #5 and #6
    streaming (#5 with an Idempotency-Key; an attached reader on its key
    drops after 8 events and resumes with ?from=8, and an attached
    reader never cancels), #7 posted once #5 streams (it shares #5's
    1024-token prefix), #2 retried with its key once done. Returns
    {index: tokens}, the ids, the resume frames and the retry check."""
    out, ids, frames, errors = {}, {}, {}, []
    started = threading.Event()

    def blocking(i, idem=None):
        st, body = http_json(port, "POST", "/v1/completions",
                             {"prompt": prompts[i].tolist(),
                              "max_tokens": max_tokens}, idem=idem)
        if st != 200:
            errors.append((i, st, body))
            return
        out[i], ids[i] = body["tokens"], body["id"]

    def streaming(i, idem=None):
        conn, resp = http_post(port, {"prompt": prompts[i].tolist(),
                                      "max_tokens": max_tokens,
                                      "stream": True}, idem=idem)
        ids[i] = resp.getheader("X-Request-Id")
        fr, ev = sse_frames(resp, limit=1)
        if i == 5:
            started.set()
        more, ev2 = sse_frames(resp)
        conn.close()
        fr += more
        ev += ev2
        if not ev or ev[-1].get("done") is not True:
            errors.append((i, "stream", ev[-1:] if ev else None))
        frames[i] = fr
        out[i] = [e["token"] for e in ev if "token" in e]

    threads = [threading.Thread(target=blocking, args=(i,),
                                kwargs={"idem": "a-2"} if i == 2 else {})
               for i in range(5)]
    threads += [threading.Thread(target=streaming, args=(5, "a-5")),
                threading.Thread(target=streaming, args=(6,))]
    for t in threads:
        t.start()
    if not started.wait(600):
        raise AssertionError("engine A: request 5 never streamed")
    # The attached reader: same key, same body; drops after 8 events.
    conn, resp = http_post(port, {"prompt": prompts[5].tolist(),
                                  "max_tokens": max_tokens, "stream": True},
                           idem="a-5")
    dropped, _ = sse_frames(resp, limit=8)
    drop_id = resp.getheader("X-Request-Id")
    conn.close()
    last = threading.Thread(target=blocking, args=(7,))
    last.start()
    for t in threads + [last]:
        t.join(600)
    if errors:
        raise AssertionError(f"engine A requests failed: {errors}")
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("GET", f"/v1/completions/{drop_id}?from=8")
    resp = conn.getresponse()
    resumed, _ = sse_frames(resp)
    conn.close()
    st, retry = http_json(port, "POST", "/v1/completions",
                          {"prompt": prompts[2].tolist(),
                           "max_tokens": max_tokens}, idem="a-2")
    return {"tokens": out, "ids": ids, "frames": frames,
            "dropped": dropped, "drop_id": drop_id, "resumed": resumed,
            "retry": (st, retry)}


def direct_run(torch, paged, cfg, params, prompts, order, n_tokens,
               n_blocks, bs, adapters=None, **srv_kw):
    """The engine's prompts through a PagedSlotServer on the same
    weights, driven directly in the engine's admission order: each
    stream's tokens and, per position, the logits row it was picked
    from, and the ms of each decode tick with every slot active.
    ``adapters``: {prompt index: bank index} for a ``multi_lora``
    server; ``srv_kw`` the server's other options (8 slots unless
    given)."""
    srv_kw.setdefault("n_slots", 8)
    srv = paged.PagedSlotServer(params, cfg, n_blocks=n_blocks,
                                block_size=bs, prefix_cache=True, **srv_kw)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    rec.record = True
    streams, rows, slot_of = {}, {}, {}
    for i in order:
        slot = srv.admit_start(prompts[i], **(
            {} if adapters is None else {"adapter": adapters[i]}))
        streams[i] = [srv.admit_step(slot)]
        rows[i] = [rec.seen[-1][0]]
        slot_of[slot] = i
    tick_ms = []
    for _ in range(n_tokens - 1):
        n0 = len(rec.seen)
        t0 = time.perf_counter()
        out = srv.step()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        logits = rec.seen[n0]
        for s, tok in out.items():
            streams[slot_of[s]].append(tok)
            rows[slot_of[s]].append(logits[s])
        del rec.seen[:]
    for s in list(slot_of):
        srv.evict(s)
    del srv, rec
    gc.collect()
    torch.cuda.empty_cache()
    return streams, rows, tick_ms


def stream_flips(got, want, rows, tol):
    """Compare two token streams; where they part, the want side's
    top-two logit gap at that position must be within ``tol`` of its
    largest |logit|. Returns the flip (position, gap share) or None;
    raises on a parting the gate does not cover."""
    for pos, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        row = rows[pos]
        top2 = row.topk(2).values
        share = float((top2[0] - top2[1]) / row.abs().max())
        if share > tol:
            raise AssertionError(f"stream parts at {pos} ({a} vs {b}) with "
                                 f"a top-two gap of {share:.4f} of the "
                                 f"largest |logit| (gate {tol})")
        return pos, share
    if len(got) != len(want):
        raise AssertionError(f"stream lengths {len(got)} vs {len(want)}")
    return None


def profile_engine_window(eng, clock, n):
    """``DeviceProfile`` of at least ``n`` dispatches of a running engine.
    The profiler is entered and left ON THE ENGINE THREAD, between ticks
    (``ServeEngine._engine_call``), so the thread that launches the
    window's kernels is the one that traces them: with the profiler
    entered on this thread while the engine thread launched, 3 of 20
    runs of slice_engine alone died of a segmentation fault inside
    engine B's launches (the faulthandler stacks of the crash hunt).
    The window's tick count is read on the engine thread at its end."""
    prof, start = DeviceProfile(n), {}

    def begin():
        prof.__enter__()
        start["ticks"] = eng._stats["work_ticks"]

    def end():
        prof.n = max(1, eng._stats["work_ticks"] - start["ticks"])
        prof.stop()

    eng._engine_call(begin, timeout_s=600)
    # The new bound first, then the clear: a tick between the two can no
    # longer set the event for the old bound.
    clock.until = start["ticks"] + n
    clock.reached.clear()
    if eng._stats["work_ticks"] >= clock.until:
        clock.reached.set()
    if not clock.reached.wait(600):
        raise AssertionError("engine made no progress in its window")
    eng._engine_call(end, timeout_s=600)
    clock.until = None
    prof.summarize()            # the events' parse, off the engine thread
    return prof.stats


def engine_window(serve_mod, eng, clock, prompts, max_tokens, n,
                  adapters=None):
    """The engine's own ms per tick with every slot decoding, then a
    profiled window of ``n`` ticks: 8 fresh requests submitted directly
    to the running engine (each with its bank index in ``adapters``)."""
    adapters = adapters or [-1] * len(prompts)
    reqs = [serve_mod._Request(p.tolist(), max_tokens, None, adapter=a)
            for p, a in zip(prompts, adapters)]
    clock.ms.clear()
    clock.active.clear()
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError("engine queue full")
    while len(eng._active) < len(reqs):
        if any(r.done.wait(0.01) for r in reqs):
            break
    # n timed ticks with every slot active, then n profiled ones.
    clock.until = eng._stats["work_ticks"] + n
    clock.reached.clear()
    clock.reached.wait(600)
    prof = profile_engine_window(eng, clock, n)
    for r in reqs:
        if not r.done.wait(600) or r.error:
            raise AssertionError(f"window request failed: {r.error}")
    return clock.full_ms(len(reqs))[:n], prof


def engine_b_run(serve_mod, argv, prompts, max_tokens):
    """Engine B over real HTTP in a fixed admission order: the handler
    threads enqueue the 8 requests one at a time (each waits until the
    previous sits in the queue) before the engine starts, so two engines
    built with one seed see the same schedule. Returns the engine (still
    running), its clock and {index: tokens}."""
    from http.server import ThreadingHTTPServer
    eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    clock = TickClock(eng)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve_mod.make_handler(eng, 600.0))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    out, errors = {}, []

    def post(i):
        st, body = http_json(port, "POST", "/v1/completions",
                             {"prompt": prompts[i].tolist(),
                              "max_tokens": max_tokens})
        if st != 200:
            errors.append((i, st, body))
        else:
            out[i] = (body["tokens"], body["id"])

    threads = []
    for i in range(len(prompts)):
        t = threading.Thread(target=post, args=(i,))
        t.start()
        threads.append(t)
        t_wait = time.perf_counter()
        while eng._pending.qsize() < i + 1:
            if time.perf_counter() - t_wait > 60:
                raise AssertionError("a request never reached the queue")
            time.sleep(0.001)
    t0 = time.perf_counter()
    eng.start()
    for t in threads:
        t.join(600)
    wall_s = time.perf_counter() - t0
    if errors or len(out) != len(prompts):
        raise AssertionError(f"engine B requests failed: {errors}")
    return eng, httpd, clock, out, wall_s


def sampler_law(torch, tgen, logits, configs, draws, chunk):
    """Draw ``draws`` samples per row of ``logits`` [R, V] (on the card)
    with ``tgen.sample_logits``, ``chunk`` copies of each row per call;
    per row, the TV distance of the draws from ``softmax(filter_logits)``
    computed by the plain CPU path. ``configs``: one (temperature, top_k,
    top_p, sample_top_p) per row (sample_top_p is what the sampler
    under test applies: the planted fault passes None)."""
    R, V = logits.shape
    tv = []
    for r, (temp, k, p, p_s) in enumerate(configs):
        want = torch.softmax(tgen.filter_logits(
            logits[r:r + 1].cpu(), temp, top_k=k, top_p=p).double(), -1)[0]
        counts = torch.zeros(V, dtype=torch.int64, device=logits.device)
        gen = torch.Generator(device=logits.device).manual_seed(100 + r)
        x = logits[r:r + 1].expand(chunk, V)
        ones = torch.ones(chunk, dtype=torch.int64, device=logits.device)
        for _ in range(draws // chunk):
            toks = tgen.sample_logits(x, gen, temperature=temp, top_k=k,
                                      top_p=p_s)
            counts.index_add_(0, toks, ones)
        hist = counts.double().cpu() / (draws // chunk * chunk)
        tv.append(0.5 * float((hist - want).abs().sum()))
    return tv


def sampler_costs(torch, serving, spec, flush, V, gamma):
    """Device ms of a tick's sampler on [8, V] f32 logits (greedy and
    engine B's sampled config) and of a speculative round's stochastic
    cores ([8, V] draft draws x gamma, [8, gamma + 1, V] acceptance)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    logits = torch.randn(8, V, generator=gen, device="cuda") * 2
    tl = torch.randn(8, gamma + 1, V, generator=gen, device="cuda") * 2
    kw = dict(temperature=0.8, top_k=64, top_p=0.95)
    greedy = serving.TokenSampler(device="cuda")
    sampled = serving.TokenSampler(seed=1, device="cuda", **kw)
    g2 = torch.Generator(device="cuda").manual_seed(2)
    base = torch.zeros(8, dtype=torch.int32, device="cuda")
    drafts, q = spec.draft_sample_core(logits, g2, **kw)
    qd = q[:, None].expand(8, gamma, V).contiguous()
    dr = drafts[:, None].expand(8, gamma).contiguous()

    def round_cores():
        for _ in range(gamma):
            spec.draft_sample_core(logits, g2, **kw)
        spec.spec_accept_core(tl, dr, qd, g2, base, cap=1 << 20, **kw)

    return {"greedy_pick_ms": time_ms(lambda: greedy.pick(logits), 20,
                                      flush),
            "sampled_pick_ms": time_ms(lambda: sampled.pick(logits), 20,
                                       flush),
            "spec_round_cores_ms": time_ms(round_cores, 5, flush)}


def engine_prompts(np, cfg):
    """slice_engine's 8 prompts (16..2048 tokens; #7 shares #5's first
    1024), their lengths, and the generator that drew them."""
    erng = np.random.default_rng(6)
    e_len = [16, 100, 255, 511, 700, 1100, 1500, 2048]
    e_prompts = [erng.integers(0, cfg.vocab_size, n) for n in e_len]
    e_prompts[7] = np.concatenate([e_prompts[5][:1024], erng.integers(
        0, cfg.vocab_size, e_len[7] - 1024)])      # shares #5's prefix
    return e_len, e_prompts, erng


def slice_engine(torch, np, paged, serving, cfg, dev, card, run_path,
                 failures):
    """The slice_engine phase (see the module docstring): returns the
    launch counts of engine A's and engine B's HTTP runs and engine A's
    ms per tick; gate breaches go to ``failures``."""
    import importlib
    V = cfg.vocab_size
    bs = 16
    serve_mod = importlib.import_module("tpushare_torch.cli.serve")
    tgen = importlib.import_module("tpushare_torch.models.generate")
    tspec = importlib.import_module("tpushare_torch.models.spec")
    e_len, e_prompts, erng = engine_prompts(np, cfg)
    e_tokens, e_window = 32, 16
    w_prompts = [erng.integers(0, cfg.vocab_size, 64) for _ in range(8)]

    def engine_a():
        eng = serve_mod.build_engine(
            serve_mod.build_parser().parse_args(ENGINE_ARGV))
        clock = TickClock(eng)
        httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
        t0 = time.perf_counter()
        res = engine_a_requests(httpd.server_address[1],
                                e_prompts, e_tokens)
        res["wall_s"] = time.perf_counter() - t0
        return eng, httpd, clock, res

    (eng, httpd, clock, a_res), a_launches = run_path(
        ("flash_attention", "paged_flash_decode"), engine_a)
    _, a_stats = http_json(httpd.server_address[1], "GET", "/stats")
    reqs = {i: eng.request_by_id(rid) for i, rid in a_res["ids"].items()}
    a_ttft = [(reqs[i].t_first - reqs[i].t_submit) * 1e3 for i in range(8)]
    order = sorted(reqs, key=lambda i: reqs[i].seq)
    a_win_ms, a_prof = engine_window(serve_mod, eng, clock, w_prompts,
                                     3 * e_window, e_window)
    e_params = eng.srv.params
    stop_engine(httpd, eng)
    del eng, httpd, clock, reqs
    gc.collect()
    torch.cuda.empty_cache()
    d_streams, d_rows, d_tick_ms = direct_run(
        torch, paged, cfg, e_params, e_prompts, order, e_tokens, 1024, bs)
    del e_params
    gc.collect()
    torch.cuda.empty_cache()
    a_flips = {}
    for i in range(8):
        got = a_res["tokens"][i]
        if len(got) != e_tokens or not all(0 <= t < V for t in got):
            failures.append(f"slice_engine A: stream {i} is {got}")
            continue
        try:
            flip = stream_flips(got, d_streams[i], d_rows[i], LOGIT_REL_TOL)
        except AssertionError as e:
            failures.append(f"slice_engine A: stream {i}: {e}")
            continue
        if flip is not None:
            a_flips[i] = flip
    del d_rows
    if a_res["dropped"] != a_res["frames"][5][:8] or \
            a_res["resumed"] != a_res["frames"][5][8:]:
        failures.append("slice_engine A: the resumed stream's events are "
                        "not the uninterrupted ones")
    st, retry = a_res["retry"]
    if st != 200 or retry.get("id") != a_res["ids"][2] or \
            retry.get("tokens") != a_res["tokens"][2]:
        failures.append(f"slice_engine A: the idempotent retry answered "
                        f"{st} {retry}")
    if not a_stats["prefix_hit_tokens"] > 0:
        failures.append("slice_engine A: no prefix hit")
    if a_stats["device_fetches"] != a_stats["work_ticks"]:
        failures.append(f"slice_engine A: {a_stats['device_fetches']} "
                        f"fetches in {a_stats['work_ticks']} ticks")
    emit({"phase": "slice_engine", "engine": "A", "argv": ENGINE_ARGV,
          "prompt_lengths": e_len, "max_tokens": e_tokens,
          "launches": a_launches, "flips": a_flips,
          "streams_equal": 8 - len(a_flips),
          "resumed_frames": len(a_res["resumed"]),
          "ttft_ms": a_ttft, "http_wall_s": a_res["wall_s"],
          "tok_s": 8 * e_tokens / a_res["wall_s"],
          "ms_per_tick": mean(a_win_ms),
          "ms_per_tick_median": median(a_win_ms), "tick_ms": a_win_ms,
          "decode_tok_s": 8 / (mean(a_win_ms) / 1e3),
          "direct_ms_per_tick": mean(d_tick_ms),
          "direct_ms_per_tick_median": median(d_tick_ms),
          "direct_tick_ms": d_tick_ms,
          "host_cost_ms_per_tick": mean(a_win_ms) - mean(d_tick_ms),
          "host_cost_ms_per_tick_median": median(a_win_ms)
          - median(d_tick_ms),
          "profile": a_prof, "prefix_hit_tokens":
          a_stats["prefix_hit_tokens"],
          "fetches_per_tick": a_stats["fetches_per_tick"],
          "work_ticks": a_stats["work_ticks"],
          "host_gap_ms": a_stats["host_gap_ms"], "card": card})

    b_argv = ENGINE_ARGV + ENGINE_B_ARGV
    b_runs = []
    for rep in range(2):
        if rep == 0:
            (eng, httpd, clock, b_out, b_wall), b_launches = run_path(
                ("flash_attention", "paged_flash_decode",
                 "paged_flash_verify"), engine_b_run, serve_mod, b_argv,
                e_prompts, e_tokens)
        else:
            eng, httpd, clock, b_out, b_wall = engine_b_run(
                serve_mod, b_argv, e_prompts, e_tokens)
        b_stats = eng.stats()
        run_b = {"tokens": [b_out[i][0] for i in range(8)],
                 "wall_s": b_wall, "stats": b_stats}
        if rep == 0:
            reqs = {i: eng.request_by_id(b_out[i][1]) for i in range(8)}
            run_b["ttft_ms"] = [(reqs[i].t_first - reqs[i].t_submit) * 1e3
                                for i in range(8)]
            run_b["win_ms"], run_b["profile"] = engine_window(
                serve_mod, eng, clock, w_prompts, 12 * e_window, e_window)
            run_b["window_spec"] = eng.stats()["speculative"]
            del reqs
        b_runs.append(run_b)
        stop_engine(httpd, eng)
        del eng, httpd, clock
        gc.collect()
        torch.cuda.empty_cache()
    b1, b2 = b_runs
    b_toks = [t for s in b1["tokens"] + b2["tokens"] for t in s]
    rate = b1["stats"]["speculative"]["spec_accept_rate"]
    if b1["tokens"] != b2["tokens"]:
        failures.append("slice_engine B: two engines on one seed served "
                        "different streams")
    if not all(0 <= t < V for t in b_toks) or \
            any(len(s) != e_tokens for s in b1["tokens"]):
        failures.append("slice_engine B: a token outside [0, V) or a "
                        "short stream")
    if rate is None or not 0 < rate <= 1:
        failures.append(f"slice_engine B: spec_accept_rate {rate}")
    for b in b_runs:
        if b["stats"]["device_fetches"] != b["stats"]["work_ticks"]:
            failures.append(f"slice_engine B: {b['stats']['device_fetches']}"
                            f" fetches in {b['stats']['work_ticks']} rounds")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    costs = sampler_costs(torch, serving, tspec, flush, V, 4)
    del flush
    emit({"phase": "slice_engine", "engine": "B", "argv": b_argv,
          "launches": b_launches, "reproduced": b1["tokens"] == b2["tokens"],
          "spec_accept_rate": rate,
          "spec_rounds": b1["stats"]["speculative"]["spec_rounds"],
          "after_window": b1["window_spec"],
          "mean_tokens_per_round":
              b1["stats"]["speculative"]["mean_tokens_per_round"],
          "ttft_ms": b1["ttft_ms"], "http_wall_s": [b1["wall_s"],
                                                    b2["wall_s"]],
          "tok_s": 8 * e_tokens / b1["wall_s"],
          "ms_per_round": mean(b1["win_ms"]),
          "ms_per_round_median": median(b1["win_ms"]),
          "round_ms": b1["win_ms"],
          "profile": b1["profile"],
          "fetches_per_round": [b["stats"]["fetches_per_tick"]
                                for b in b_runs],
          "sampler": costs, "card": card})

    # The sampler's law on the card: 2^16 draws per row of one seeded
    # [8, V] f32 logits tensor, rows 0-3 at engine B's filters, rows 4-7
    # at top_p 0.7; the fault skips the top-p mask on rows 4-7.
    t_s = time.perf_counter()
    s_logits = torch.randn(8, V, device=dev, generator=torch.Generator(
        device=dev).manual_seed(8))
    served, tight = (0.8, 64, 0.95, 0.95), (0.8, 64, 0.7, 0.7)
    law_tv = sampler_law(torch, tgen, s_logits, [served] * 4 + [tight] * 4,
                         SAMPLER_DRAWS, 512)
    fault_tv = sampler_law(torch, tgen, s_logits[4:],
                           [tight[:3] + (None,)] * 4, SAMPLER_DRAWS, 512)
    del s_logits
    torch.cuda.empty_cache()
    if not max(law_tv) <= SAMPLER_TV_TOL:
        failures.append(f"slice_engine sampler law: TV {law_tv}")
    if not min(fault_tv) > SAMPLER_TV_TOL:
        failures.append(f"slice_engine sampler law: the planted fault "
                        f"passed, TV {fault_tv}")
    emit({"phase": "slice_engine_sampler", "draws_per_row": SAMPLER_DRAWS,
          "filters": [list(c[:3]) for c in [served] * 4 + [tight] * 4],
          "tv": law_tv, "tv_tol": SAMPLER_TV_TOL, "fault_tv": fault_tv,
          "seconds": time.perf_counter() - t_s, "card": card})
    return a_launches, b_launches, mean(a_win_ms)


# -- slice_engine C: multi-LoRA over Gemma-2B ----------------------------

LORA_ADAPTERS = [-1, 0, 1, 2, 3, -1, 0, 1]   # per engine prompt
LORA_RANK = 16


def lora_bank(torch, lora, cfg, dev, n=4, seed=9):
    """``n`` rank-16 adapters on wq and wv from one seeded generator: A
    as ``init_lora`` draws it, B drawn too (N(0, 1/4r)), so each adapter
    moves the logits; and their stacked bank."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ads = []
    for _ in range(n):
        ad = lora.init_lora(gen, cfg, LORA_RANK, ("wq", "wv"))
        for ab in ad.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=dev) \
                * (0.5 / math.sqrt(LORA_RANK))
        ads.append(ad)
    return ads, lora.stack_adapters(ads)


def post_all(port, bodies):
    """POST every body at once (one thread each); returns {index: (status,
    answer)}."""
    out = {}

    def post(i):
        out[i] = http_json(port, "POST", "/v1/completions", bodies[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out


def slice_engine_lora(torch, np, paged, cfg, dev, card, run_path, failures,
                      a_ms_per_tick):
    """slice_engine part C (see the module docstring): engine A's argv
    with a bank of 4 adapters; returns the launch counts of its run."""
    import importlib
    serve_mod = importlib.import_module("tpushare_torch.cli.serve")
    lora = importlib.import_module("tpushare_torch.models.lora")
    V, e_tokens, e_window = cfg.vocab_size, 32, 16
    _, e_prompts, erng = engine_prompts(np, cfg)
    w_prompts = [erng.integers(0, cfg.vocab_size, 64) for _ in range(8)]
    ads, bank = lora_bank(torch, lora, cfg, dev)

    def engine_c():
        # Engine A's argv through build_engine, the engine given the
        # bank (the CLI has no adapter flag; the reference's neither).
        eng = serve_mod.build_engine(
            serve_mod.build_parser().parse_args(ENGINE_ARGV),
            multi_lora=bank)
        clock = TickClock(eng)
        httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
        t0 = time.perf_counter()
        ans = post_all(httpd.server_address[1], [
            {"prompt": p.tolist(), "max_tokens": e_tokens, "adapter": a}
            for p, a in zip(e_prompts, LORA_ADAPTERS)])
        wall = time.perf_counter() - t0
        bad = {i: a for i, a in ans.items() if a[0] != 200}
        if bad:
            stop_engine(httpd, eng)
            raise AssertionError(f"slice_engine C requests failed: {bad}")
        reqs = {i: eng.request_by_id(a[1]["id"]) for i, a in ans.items()}
        res = {"tokens": {i: a[1]["tokens"] for i, a in ans.items()},
               "order": sorted(reqs, key=lambda i: reqs[i].seq),
               "ttft_ms": [(reqs[i].t_first - reqs[i].t_submit) * 1e3
                           for i in range(8)],
               "stats": eng.stats(), "http_tick_ms": clock.full_ms(8),
               "wall_s": wall}
        # Engine A's window (the same 8 fresh 64-token prompts), each
        # request with its adapter: ms per tick like A's, and a profile.
        res["tick_ms"], res["profile"] = engine_window(
            serve_mod, eng, clock, w_prompts, 3 * e_window, e_window,
            LORA_ADAPTERS)
        res["params"] = {**eng.srv.params, "layers": {
            k: v for k, v in eng.srv.params["layers"].items()
            if k != "_mlora"}}
        del reqs
        stop_engine(httpd, eng)
        return res

    res, c_launches = run_path(("flash_attention", "paged_flash_decode"),
                               engine_c)
    base = res.pop("params")
    gc.collect()
    torch.cuda.empty_cache()
    order = res["order"]
    # The bank served directly (same admission order): the logits the
    # engine's streams were picked from, beside each adapter's twin.
    b_streams, b_rows, b_tick_ms = direct_run(
        torch, paged, cfg, base, e_prompts, order, e_tokens, 1024, 16,
        adapters=dict(enumerate(LORA_ADAPTERS)), multi_lora=bank)
    flips, rels = {}, {}
    for a in sorted(set(LORA_ADAPTERS)):
        idx = [i for i in order if LORA_ADAPTERS[i] == a]
        twin = base if a < 0 else lora.merge_lora(base, ads[a])
        d_streams, d_rows, _ = direct_run(torch, paged, cfg, twin, e_prompts,
                                          idx, e_tokens, 1024, 16)
        del twin
        for i in idx:
            got = res["tokens"][i]
            if len(got) != e_tokens or not all(0 <= t < V for t in got):
                failures.append(f"slice_engine C: stream {i} is {got}")
                continue
            try:
                flip = stream_flips(got, d_streams[i], d_rows[i],
                                    LOGIT_REL_TOL)
            except AssertionError as e:
                failures.append(f"slice_engine C: stream {i} (adapter {a}):"
                                f" {e}")
                continue
            if flip is not None:
                flips[i] = flip
            # The bank's logits against the twin's, up to where the two
            # direct streams part (the same inputs before it).
            n = next((k for k, (x, y) in enumerate(zip(b_streams[i],
                                                       d_streams[i]))
                      if x != y), e_tokens)
            rels[i] = max(float((b_rows[i][k] - d_rows[i][k]).abs().max()
                                / d_rows[i][k].abs().max())
                          for k in range(max(n, 1)))
        del d_rows
        gc.collect()
    del b_rows
    torch.cuda.empty_cache()
    worst = max(rels.values()) if rels else None
    if worst is None or not worst <= LOGIT_REL_TOL:
        failures.append(f"slice_engine C: bank logits vs the merged twins "
                        f"{rels}")
    st = res["stats"]
    if st["device_fetches"] != st["work_ticks"]:
        failures.append(f"slice_engine C: {st['device_fetches']} fetches in "
                        f"{st['work_ticks']} ticks")
    emit({"phase": "slice_engine", "engine": "C", "argv": ENGINE_ARGV,
          "bank": {"adapters": len(ads), "rank": LORA_RANK,
                   "targets": ["wq", "wv"]},
          "adapters": LORA_ADAPTERS, "launches": c_launches,
          "flips": flips, "streams_equal": 8 - len(flips),
          "logit_rel_err": rels, "logit_rel_err_max": worst,
          "logit_rel_tol": LOGIT_REL_TOL,
          "ttft_ms": res["ttft_ms"], "http_wall_s": res["wall_s"],
          "ms_per_tick": mean(res["tick_ms"]),
          "ms_per_tick_median": median(res["tick_ms"]),
          "tick_ms": res["tick_ms"], "profile": res["profile"],
          "http_ms_per_tick": (mean(res["http_tick_ms"])
                               if res["http_tick_ms"] else None),
          "engine_a_ms_per_tick": a_ms_per_tick,
          "direct_bank_ms_per_tick": mean(b_tick_ms),
          "fetches_per_tick": st["fetches_per_tick"],
          "work_ticks": st["work_ticks"], "card": card})
    return c_launches


# -- slice_moe_spec: MoE int8-self speculation at Mixtral width -----------

MS_LAYERS = 6                    # of Mixtral-8x7B's 32: the depth cut
MS_LENGTHS = [64, 300, 700, 1000]
MS_TOKENS, MS_GAMMA, MS_SLOTS = 32, 4, 4


def moe_spec_schedule(paged):
    """The slice's pool: blocks per slot for its longest prompt, its
    tokens and a round's block, and the pool that holds every slot."""
    mb = paged.blocks_needed(max(MS_LENGTHS) + MS_TOKENS + MS_GAMMA + 2, 16)
    return mb, MS_SLOTS * mb + 1


def mixtral_bf16_params(torch, cfg, gen, dev):
    """Random bf16 weights at Mixtral width from ``gen``, one (layer,
    expert) at a time into stacked leaves (no f32 copy of a stack)."""
    bf = torch.bfloat16
    L, Dm, Fd, E, V = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts,
                       cfg.vocab_size)
    shapes = {"wq": (Dm, cfg.q_dim), "wk": (Dm, cfg.kv_dim),
              "wv": (Dm, cfg.kv_dim), "wo": (cfg.q_dim, Dm),
              "router": (Dm, E), "w_gate": (E, Dm, Fd),
              "w_up": (E, Dm, Fd), "w_down": (E, Fd, Dm)}
    layers = {k: torch.empty((L, *shp), dtype=bf, device=dev)
              for k, shp in shapes.items()}
    for li in range(L):
        for k, shp in shapes.items():
            for e in range(E if len(shp) == 3 else 1):
                idx = (li, e) if len(shp) == 3 else (li,)
                layers[k][idx] = (torch.randn(*shp[-2:], generator=gen,
                                              device=dev)
                                  / math.sqrt(shp[-2])).to(bf)
    layers.update(ln1=torch.ones((L, Dm), dtype=bf, device=dev),
                  ln2=torch.ones((L, Dm), dtype=bf, device=dev))

    def dense(shape):
        return (torch.randn(*shape, generator=gen, device=dev)
                / math.sqrt(Dm)).to(bf)

    return {"embed": dense((V, Dm)), "layers": layers,
            "final_norm": torch.ones((Dm,), dtype=bf, device=dev),
            "unembed": dense((Dm, V))}


def moe_spec_engine(torch, serve_mod, paged, quant, params, qparams, cfg,
                    dev, prompts, temperature):
    """One MoE int8-self speculative engine (paged) over HTTP: the 4
    prompts posted at once, 32 tokens each."""
    mb, nb = moe_spec_schedule(paged)
    torch.cuda.reset_peak_memory_stats()
    eng = serve_mod.ServeEngine(
        params, cfg, model_family="moe", kv="paged", n_slots=MS_SLOTS,
        n_blocks=nb, block_size=16, max_blocks_per_slot=mb,
        speculative_draft=(qparams, cfg),
        draft_layers_hook=quant.fused_expert_hook(cfg), gamma=MS_GAMMA,
        temperature=temperature, seed=0, device=dev)
    clock = TickClock(eng)
    httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
    t0 = time.perf_counter()
    ans = post_all(httpd.server_address[1], [
        {"prompt": p.tolist(), "max_tokens": MS_TOKENS} for p in prompts])
    wall = time.perf_counter() - t0
    bad = {i: a for i, a in ans.items() if a[0] != 200}
    if bad:
        stop_engine(httpd, eng)
        raise AssertionError(f"slice_moe_spec requests failed: {bad}")
    reqs = {i: eng.request_by_id(a[1]["id"]) for i, a in ans.items()}
    res = {"tokens": {i: a[1]["tokens"] for i, a in ans.items()},
           "order": sorted(reqs, key=lambda i: reqs[i].seq),
           "ttft_ms": [(reqs[i].t_first - reqs[i].t_submit) * 1e3
                       for i in range(len(prompts))],
           "stats": eng.stats(), "round_ms": clock.full_ms(MS_SLOTS),
           "wall_s": wall,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    del reqs
    stop_engine(httpd, eng)
    return res


def moe_routing_run(torch, moe, paged, quant, q8, cfg, qparams, prompts,
                    routing, run_path, failures, card):
    """One routing through a direct paged server at the slice's width on
    the int8 tree (fused_expert_hook): 4 whole admissions, 8 ticks
    under the fetch spy, 2 profiled. The queue-shaped routings launch
    q8_expert_ffn on [E, C, Dm] queues; dropless widens (the reference's
    warning) and runs grouped products. The kernel (or grouped GEMM) is
    held against its plain version per element on the inputs the first
    admission's and the first tick's layer 0 gave it."""
    import warnings
    cfg_r = dataclasses.replace(cfg, routing=routing, capacity_factor=(
        1.25 if routing == "a2a" else None))
    mb, nb = moe_spec_schedule(paged)
    seen, capture = [], [False]
    orig_q8, orig_grp = moe._q8_expert_mlps, moe._grouped_products

    def q8_spy(x_e, layer, c):
        if capture[0]:
            seen.append(("q8", x_e, {k: layer[k] for k in layer
                                     if k.startswith("w_")}))
            capture[0] = False
        return orig_q8(x_e, layer, c)

    def grp_spy(x, w, offs, e_s):
        if capture[0]:
            seen.append(("grouped", x, w, offs, e_s))
            capture[0] = False
        return orig_grp(x, w, offs, e_s)

    def run():
        srv = paged.PagedSlotServer(
            qparams, cfg_r, n_slots=MS_SLOTS, n_blocks=nb, block_size=16,
            max_blocks_per_slot=mb, prefix_cache=True,
            forward_fn=moe.paged_forward,
            layers_hook=quant.fused_expert_hook(cfg_r))
        fetch, tick_ms = [], []
        for i, p in enumerate(prompts):
            capture[0] = i == 0
            srv.admit(p)
        for t in range(8):
            capture[0] = t == 0
            t0 = time.perf_counter()
            with FetchSpy(torch) as spy:
                out = srv.step()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            fetch.append(spy.count)
            if not all(0 <= tok < cfg.vocab_size for tok in out.values()):
                raise AssertionError(f"{routing}: a token outside [0, V)")
        with DeviceProfile(2) as prof:
            for _ in range(2):
                srv.step()
        del srv
        return fetch, tick_ms, prof.stats

    moe._q8_expert_mlps, moe._grouped_products = q8_spy, grp_spy
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            needed = ("flash_attention", "paged_flash_decode") + (
                () if routing == "dropless" else ("q8_expert_ffn",))
            (fetch, tick_ms, prof), launches = run_path(needed, run)
    finally:
        moe._q8_expert_mlps, moe._grouped_products = orig_q8, orig_grp
    checks = []
    for item in seen:
        if item[0] == "q8":
            _, x_e, w = item
            leaves = [w[f"{k}#{s}"] for k in ("w_gate", "w_up", "w_down")
                      for s in ("q8", "scale")]
            got = q8.q8_expert_ffn(x_e, *leaves, act=cfg.act)
            want = q8.q8_expert_ffn_reference(x_e, *leaves, act=cfg.act)
            what = f"q8_expert_ffn {tuple(x_e.shape)}"
        else:
            _, x, w, offs, e_s = item
            got = orig_grp(x, w, offs, e_s)
            want = moe._per_expert_products(x, w, e_s)
            route = ("_grouped_mm" if moe._grouped_mm_fits(x, w)
                     else "per expert")
            what = f"grouped {route} {tuple(x.shape)}x{tuple(w.shape)}"
        torch.cuda.synchronize()
        cmp = compare(got, want)
        checks.append({"what": what, **cmp})
        if not cmp["ulp_ratio"] <= 1.0:
            failures.append(f"slice_moe_spec {routing}: {what} vs its plain "
                            f"version: {cmp}")
    del seen
    if len(checks) != 2:
        failures.append(f"slice_moe_spec {routing}: {len(checks)} "
                        f"kernel inputs captured, expected 2")
    if any(f != 1 for f in fetch):
        failures.append(f"slice_moe_spec {routing}: fetches per tick "
                        f"{fetch}")
    dropless_warned = any("dropless" in str(w.message) for w in warned)
    if routing == "dropless" and not dropless_warned:
        failures.append("slice_moe_spec dropless: the int8 widening did "
                        "not warn")
    emit({"phase": "slice_moe_spec", "routing": routing,
          "capacity_factor": cfg_r.capacity_factor, "layers": cfg.n_layers,
          "launches": launches, "checks": checks,
          "fetches_per_tick": sorted(set(fetch)),
          "ms_per_tick": mean(tick_ms),
          "device_ms_per_layer": prof["device_ms_per_tick"] / cfg.n_layers,
          "profile": prof, "widen_warning": dropless_warned, "card": card})
    return launches


def slice_moe_spec(torch, np, moe, paged, quant, q8, mcfg, dev, card,
                   run_path, failures):
    """The slice_moe_spec phase (see the module docstring): returns the
    launch counts of each run."""
    import importlib
    serve_mod = importlib.import_module("tpushare_torch.cli.serve")
    cfg = dataclasses.replace(mcfg, n_layers=MS_LAYERS)
    V = cfg.vocab_size
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, V, n) for n in MS_LENGTHS]
    mb, nb = moe_spec_schedule(paged)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = mixtral_bf16_params(torch, cfg, gen, dev)
    qparams = quant.quantize_params(params, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = {name: sum(t.numel() * t.element_size() for t in
                              [tree["embed"], tree["unembed"],
                               *tree["layers"].values()])
                    for name, tree in (("target", params),
                                       ("draft", qparams))}
    launches = {}
    greedy, launches["greedy"] = run_path(
        ("flash_attention", "paged_flash_decode", "paged_flash_verify",
         "q8_expert_ffn"), moe_spec_engine, torch, serve_mod, paged, quant,
        params, qparams, cfg, dev, prompts, 0.0)
    gc.collect()
    torch.cuda.empty_cache()
    d_streams, d_rows, d_tick_ms = direct_run(
        torch, paged, cfg, params, prompts, greedy["order"], MS_TOKENS, nb,
        16, forward_fn=moe.paged_forward, n_slots=MS_SLOTS,
        max_blocks_per_slot=mb)
    flips = {}
    for i in range(len(prompts)):
        got = greedy["tokens"][i]
        if len(got) != MS_TOKENS or not all(0 <= t < V for t in got):
            failures.append(f"slice_moe_spec: stream {i} is {got}")
            continue
        try:
            flip = stream_flips(got, d_streams[i], d_rows[i],
                                MOE_LOGIT_REL_TOL)
        except AssertionError as e:
            failures.append(f"slice_moe_spec: greedy stream {i}: {e}")
            continue
        if flip is not None:
            flips[i] = flip
    del d_rows
    sampled = moe_spec_engine(torch, serve_mod, paged, quant, params,
                              qparams, cfg, dev, prompts, 0.8)
    for name, r in (("greedy", greedy), ("sampled", sampled)):
        st = r["stats"]
        rate = st["speculative"]["spec_accept_rate"]
        if st["device_fetches"] != st["work_ticks"]:
            failures.append(f"slice_moe_spec {name}: {st['device_fetches']} "
                            f"fetches in {st['work_ticks']} rounds")
        if rate is None or not 0 < rate <= 1:
            failures.append(f"slice_moe_spec {name}: accept rate {rate}")
    s_toks = [t for v in sampled["tokens"].values() for t in v]
    if not all(0 <= t < V for t in s_toks) or any(
            len(v) != MS_TOKENS for v in sampled["tokens"].values()):
        failures.append("slice_moe_spec sampled: a token outside [0, V) or "
                        "a short stream")
    for name, r in (("greedy", greedy), ("sampled", sampled)):
        spec = r["stats"]["speculative"]
        emit({"phase": "slice_moe_spec", "engine": name,
              "model": "mixtral_8x7b", "layers": cfg.n_layers,
              "reduced": {"n_layers": [32, MS_LAYERS]},
              "weight_bytes": weight_bytes, "init_s": init_s,
              "prompt_lengths": MS_LENGTHS, "max_tokens": MS_TOKENS,
              "gamma": MS_GAMMA, "temperature": 0.0 if name == "greedy"
              else 0.8, "launches": launches.get(name),
              "flips": flips if name == "greedy" else None,
              "streams_equal": (len(prompts) - len(flips)
                                if name == "greedy" else None),
              "spec_accept_rate": spec["spec_accept_rate"],
              "spec_rounds": spec["spec_rounds"],
              "mean_tokens_per_round": spec["mean_tokens_per_round"],
              "ttft_ms": r["ttft_ms"], "http_wall_s": r["wall_s"],
              "ms_per_round": mean(r["round_ms"]) if r["round_ms"] else None,
              "round_ms": r["round_ms"],
              "plain_ms_per_tick": mean(d_tick_ms),
              "fetches_per_round": r["stats"]["fetches_per_tick"],
              "peak_memory_reserved": r["peak_reserved_bytes"],
              "card": card})
    del sampled, greedy
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for routing in ("dropless", "expert_choice", "a2a"):
        launches[routing] = moe_routing_run(
            torch, moe, paged, quant, q8, cfg, qparams, prompts, routing,
            run_path, failures, card)
        gc.collect()
        torch.cuda.empty_cache()
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# slice_finetune, slice_moe_train, slice_generate (see the module
# docstring).
MT_LAYERS = 2                    # of Mixtral-8x7B's 32: the depth cut
MT_SEQ = 4096
MT_ROUTINGS = [("psum_capacity", "psum", 1.25), ("dropless", "dropless", None),
               ("expert_choice", "expert_choice", None)]
MT_ADAMW_STEPS = 4
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW, GEN_GAMMA = 4, 512, 64, 4
MOE_GEN_NEW = 32


def slice_finetune(torch, np, cfg, dev, card, run_path, no_launch, failures):
    """slice_finetune (see the module docstring): the LoRA lifecycle of
    tools/finetune_serve.py at Gemma-2B's full width and depth, then a
    gradient twin of one LoRA step. Returns the launch counts of its
    training and its serving."""
    import importlib
    fs = importlib.import_module("tpushare_torch.tools.finetune_serve")
    lora = importlib.import_module("tpushare_torch.models.lora")
    trainer = importlib.import_module("tpushare_torch.models.trainer")
    training = importlib.import_module("tpushare_torch.models.training")
    tt = importlib.import_module("tpushare_torch.models.transformer")
    fcfg, fit_kw = fs.config(tiny=False)
    L, steps = fcfg.n_layers, fit_kw["steps"]
    gen = torch.Generator(device=dev).manual_seed(fs.BASE_SEED)
    base = tt.init_params(gen, fcfg, device=dev)
    lines = []
    with tempfile.TemporaryDirectory() as work:
        torch.cuda.reset_peak_memory_stats()
        rec, train_l = run_path(("flash_attention", "flash_attention_bwd"),
                                fs.train, base, fcfg, fit_kw, work, dev,
                                lines.append)
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        served, serve_l = run_path(("flash_attention", "paged_flash_decode"),
                                   fs.serve_tenants, base, fcfg, rec, fit_kw,
                                   dev, False, lines.append)
        rec["served"] = served
        # The gradient twin: tenant A's trained adapters (both factors
        # non-zero) on its first batch, kernels against mha_reference.
        like = lora.init_lora(torch.Generator(device=dev).manual_seed(0),
                              fcfg, fit_kw["rank"])
        ads = trainer.load_state(rec["tenants"]["a"]["final_ckpt"],
                                 like_params=like, like_opt={})[0]
        corpus = fs.dpipe.load_tokens(os.path.join(work, "corpus_a.bin"),
                                      dtype=fs.TOKEN_DTYPE)
        tokens = torch.from_numpy(fs.dpipe.batch_at(
            corpus, 0, batch_size=fit_kw["batch"], seq_len=fit_kw["seq"],
            seed=fs.TENANTS["a"][1])).to(dev)

        def grads(impl):
            return training.value_and_grad(
                lambda a: lora.lora_loss(base, a, tokens, fcfg,
                                         attn_impl=impl), ads)
        ref_loss, ref_g = no_launch(grads, "reference")
        (k_loss, k_g), twin_l = run_path(
            ("flash_attention", "flash_attention_bwd"), grads, "auto")
        rel = grad_rel_l2(training, k_g, ref_g)
    rec["failures"] = fs.check(rec)
    failures += [f"slice_finetune: {f}" for f in rec["failures"]]
    n_steps = steps + steps + steps // 2 + (steps - steps // 2)
    want_train = {"flash_attention": 2 * L * n_steps,
                  "flash_attention_bwd": L * n_steps,
                  "flash_attention_partial": 0, "flash_decode": 0}
    if any(train_l[k] != n for k, n in want_train.items()):
        failures.append(f"slice_finetune: training launches {train_l}, "
                        f"expected {want_train}")
    if serve_l["flash_attention"] != 3 * L or \
            serve_l["paged_flash_decode"] % L or \
            serve_l["flash_attention_bwd"]:
        failures.append(f"slice_finetune: serving launches {serve_l}: "
                        f"expected {3 * L} flash_attention (one admission "
                        f"per request) and whole layers of decode")
    worst = max(rel.values())
    if not (worst <= GRAD_REL_L2_TOL):
        failures.append(f"slice_finetune: LoRA gradients vs the reference "
                        f"twin: {rel}")
    b = rec["tenants"]["b"]
    emit({"phase": "slice_finetune", "model": "gemma_2b",
          "params": fcfg.num_params(), "remat": fcfg.remat, **fit_kw,
          "targets": ["wq", "wv"], "n_steps": n_steps,
          "losses": {n: t["losses"] for n, t in rec["tenants"].items()},
          "step_ms_median": rec["step_ms_median"],
          "step_ms": {n: t["step_ms"] for n, t in rec["tenants"].items()},
          "train_tok_s": rec["train_tok_s"],
          "ckpt_bytes": b["ckpt_bytes"], "ckpt_save_s": b["ckpt_save_s"],
          "ckpt_restore_s": b["ckpt_restore_s"],
          "preempted_at": b["preempted_at"],
          "resume_equal": b["resume_equal"], "served": served["tokens"],
          "serve_ticks": served["ticks"],
          "ms_per_tick_bank": served["ms_per_tick"],
          "twin": {"loss": float(k_loss), "ref_loss": float(ref_loss),
                   "grad_rel_l2": rel, "grad_rel_l2_max": worst,
                   "launches": twin_l},
          "grad_rel_l2_tol": GRAD_REL_L2_TOL, "train_launches": train_l,
          "serve_launches": serve_l, "train_peak_gib": train_peak,
          "stages": lines, "card": card})
    del base, ads, k_g, ref_g
    gc.collect()
    torch.cuda.empty_cache()
    return {"slice_finetune_train": train_l, "slice_finetune_serve": serve_l,
            "slice_finetune_twin": twin_l}


def slice_moe_train(torch, np, moe, mcfg, dev, card, run_path, no_launch,
                    failures):
    """slice_moe_train (see the module docstring): Mixtral-8x7B's width at
    MT_LAYERS of 32 layers on one 4096-token sequence. Returns (launch counts by
    path, the trained params, their config)."""
    import importlib
    dist = importlib.import_module("torch.distributed")
    trainer = importlib.import_module("tpushare_torch.models.trainer")
    training = importlib.import_module("tpushare_torch.models.training")
    pmesh = importlib.import_module("tpushare_torch.parallel.mesh")
    cfg = dataclasses.replace(mcfg, n_layers=MT_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    params = moe.init_params(gen, cfg, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, MT_SEQ + 1)), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in training.tree_leaves(params))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    twins, launches = {}, {}
    for name, routing, factor in MT_ROUTINGS:
        rcfg = dataclasses.replace(cfg, routing=routing,
                                   capacity_factor=factor, remat=False)
        t0 = time.perf_counter()
        with Routes(moe) as rec:
            (loss, g), launches[f"slice_moe_train_twin_{name}"] = run_path(
                ("flash_attention", "flash_attention_bwd"),
                rec.wrap(training.value_and_grad), moe.xent_loss, params,
                inputs, targets, rcfg)
            torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        # The twin: the plain attention, and under dropless the plain
        # per-expert products in place of the grouped GEMM (forward and
        # backward), counted: three a layer.
        fits, per_expert = moe._grouped_mm_fits, moe._per_expert_products
        plain = []
        if routing == "dropless":
            def counted(*a):
                plain.append(1)
                return per_expert(*a)
            moe._grouped_mm_fits = lambda x, w: False
            moe._per_expert_products = counted
        try:
            with Routes(moe, replay=rec.calls) as rep:
                ref_loss, ref_g = no_launch(
                    rep.wrap(training.value_and_grad), moe.xent_loss,
                    params, inputs, targets, rcfg, attn_impl="reference")
        finally:
            moe._grouped_mm_fits = fits
            moe._per_expert_products = per_expert
        if routing == "dropless" and len(plain) != 3 * L:
            failures.append(f"slice_moe_train dropless: the twin ran "
                            f"{len(plain)} per-expert products, expected "
                            f"{3 * L}")
        rel = grad_rel_l2(training, g, ref_g)
        twins[name] = {"loss": float(loss), "ref_loss": float(ref_loss),
                       "s": k_s, "grad_rel_l2_max": max(rel.values()),
                       "grad_rel_l2": rel, "route_flips": rep.flips(),
                       "plain_products": len(plain),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del g, ref_g, rec, rep
        gc.collect()
        torch.cuda.empty_cache()
        if not (twins[name]["grad_rel_l2_max"] <= GRAD_REL_L2_TOL):
            failures.append(f"slice_moe_train {name} gradients vs the "
                            f"replaying reference twin: {rel}")
    ccfg = dataclasses.replace(cfg, routing="psum", capacity_factor=1.25)
    sgd = StepClock(moe.sgd_train_step)
    (params, sgd_loss), launches["slice_moe_train_sgd"] = run_path(
        ("flash_attention", "flash_attention_bwd"), sgd, params, tokens,
        ccfg, lr=TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    rec_ck = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh({"dp": 1, "sp": 1})
            step, opt_init = moe.make_adamw_spmd_train_step(ccfg, mesh,
                                                            lr=TRAIN_LR)
            step = StepClock(step)
            (params, state, losses), launches["slice_moe_train_fit"] = \
                run_path(("flash_attention_partial", "flash_attention_bwd"),
                         trainer.fit, step, params, opt_init(params),
                         [tokens] * MT_ADAMW_STEPS, steps=MT_ADAMW_STEPS,
                         log_every=0)
            fit_peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            dist.destroy_process_group()
        path = os.path.join(tmp, f"step_{MT_ADAMW_STEPS}")
        ck_p, ck_o = first_layer(params), first_layer(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec_ck["bytes"] = trainer.save_state(path, ck_p, ck_o,
                                             MT_ADAMW_STEPS)
        rec_ck["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back_p, back_o, back_step = trainer.load_state(
            path, like_params=ck_p, like_opt=ck_o)
        torch.cuda.synchronize()
        rec_ck["restore_s"] = time.perf_counter() - t0
        rec_ck["layers_saved"], rec_ck["experts_saved"] = 1, 1
        rec_ck["equal"] = back_step == MT_ADAMW_STEPS and all(
            torch.equal(a, b) for a, b in zip(
                training.tree_leaves({"p": back_p, "o": back_o}),
                training.tree_leaves({"p": ck_p, "o": ck_o})))
        del back_p, back_o, ck_p, ck_o
        del state
        gc.collect()
        torch.cuda.empty_cache()
        world1(torch, dist, os.path.join(tmp, "pp_store"))
        try:
            pp_runs, pp_launches = moe_pp_check(
                torch, np, moe, ccfg, params,
                pmesh.make_mesh({"pp": 1}), dev, run_path, failures)
            launches.update(pp_launches)
        finally:
            dist.destroy_process_group()
    losses = [float(x) for x in losses]
    emit({"phase": "slice_moe_train", "model": "mixtral_8x7b",
          "layers": L, "layers_full": mcfg.n_layers, "seq": MT_SEQ,
          "params": sum(t.numel() for t in training.tree_leaves(params)),
          "param_gib": param_bytes / 2**30, "init_s": init_s,
          "twins": twins, "grad_rel_l2_tol": GRAD_REL_L2_TOL,
          "sgd_loss": float(sgd_loss), "sgd_ms": sgd.ms,
          "adamw_losses": losses, "step_ms": step.ms,
          "tok_s": MT_SEQ / (mean(step.ms[1:]) / 1e3),
          "fit_peak_gib": fit_peak, "checkpoint": rec_ck,
          "pp": {"microbatches": MPP_M, "seq": MPP_SEQ, "runs": pp_runs},
          "launches": launches, "card": card})
    if not all(math.isfinite(x) for x in losses + [float(sgd_loss)]):
        failures.append(f"slice_moe_train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"slice_moe_train: the loss did not fall: {losses}")
    if not rec_ck["equal"]:
        failures.append("slice_moe_train: the restored AdamW checkpoint "
                        "differs from the state saved")
    want = {"slice_moe_train_sgd": {"flash_attention": 2 * L,
                                    "flash_attention_bwd": L,
                                    "flash_attention_partial": 0},
            "slice_moe_train_fit": {
                "flash_attention_partial": 2 * L * MT_ADAMW_STEPS,
                "flash_attention_bwd": L * MT_ADAMW_STEPS,
                "flash_attention": 0}}
    for path_, w in want.items():
        if any(launches[path_][k] != n for k, n in w.items()):
            failures.append(f"slice_moe_train {path_} launches "
                            f"{launches[path_]}, expected {w}")
    return launches, params, ccfg


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")     # [L, E, ...]


def first_layer(tree):
    """``tree`` (params, or an AdamW state) with every leaf under a
    "layers" key cut to its first layer, and the experts' leaves to
    that layer's first expert (views); the rest whole."""
    return {k: ({n: t[:1, :1] if n in EXPERT_LEAVES else t[:1]
                 for n, t in v.items()} if k == "layers"
                else first_layer(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


FS_BATCH, FS_SEQ = 4, 1024       # slice_fsdp / slice_pipeline: 4 x 1024
FS_STEPS = 2
PP_M, PP_CHUNKS = 4, 2           # slice_pipeline's microbatches, chunks
MPP_M, MPP_SEQ = 2, 2048         # slice_moe_train's pp step: 2 x 2048
SAT_SECONDS = 3.0                # slice_saturation's windows


def world1(torch, dist, store):
    """A one-rank NCCL group over the FileStore file ``store`` (the
    pattern of slice_train)."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)


def tree_clone(training, tree):
    return training.tree_map(lambda t: t.clone(), tree)


def update_rel_l2(training, got, want, p0):
    """Per-leaf ||got - want|| / ||want - p0||: two steps' updates from
    the same p0 compared leaf by leaf (f32), and whether every leaf is
    bit-equal."""
    import torch
    rel, equal = {}, True
    for name, g, w, p in zip(tree_keys(want), training.tree_leaves(got),
                             training.tree_leaves(want),
                             training.tree_leaves(p0)):
        equal = equal and bool(torch.equal(g, w))
        d = (w.float() - p.float()).norm().item()
        rel[name] = (g.float() - w.float()).norm().item() / max(d, 1e-30)
    return rel, equal


def fs_tokens(np, cfg, seed):
    """slice_fsdp's and slice_pipeline's batch: utils/data.py's first
    window batch over a seeded token array."""
    import importlib
    dpipe = importlib.import_module("tpushare_torch.utils.data")
    corpus = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 16 * FS_BATCH * FS_SEQ).astype(np.uint32)
    return dpipe.batch_at(corpus, 0, batch_size=FS_BATCH, seq_len=FS_SEQ,
                          seed=seed)


def slice_fsdp(torch, np, cfg, dev, card, run_path, failures):
    """slice_fsdp (see the module docstring): Gemma-2B's three fsdp steps
    at fsdp 1 against the SPMD steps from the same params. Returns the
    launch counts by path."""
    import importlib
    dist = importlib.import_module("torch.distributed")
    training = importlib.import_module("tpushare_torch.models.training")
    trainer = importlib.import_module("tpushare_torch.models.trainer")
    tt = importlib.import_module("tpushare_torch.models.transformer")
    pmesh = importlib.import_module("tpushare_torch.parallel.mesh")
    L = cfg.n_layers
    p0 = tt.init_params(torch.Generator(device=dev).manual_seed(11), cfg)
    tokens = torch.as_tensor(fs_tokens(np, cfg, 11), device=dev)
    like = tt.init_params(0, cfg, device="meta")
    launches, runs, rec = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        world1(torch, dist, os.path.join(tmp, "store"))
        try:
            mesh = pmesh.make_mesh({"fsdp": 1})
            for kind in ("sgd", "adamw"):
                ref = tree_clone(training, p0)
                if kind == "sgd":
                    rstep = StepClock(training.make_spmd_train_step(
                        cfg, mesh, lr=TRAIN_LR))
                    ref_losses = [float(rstep(ref, tokens)[1])
                                  for _ in range(FS_STEPS)]
                    paths = (("plain", training.make_fsdp_train_step,
                              training.fsdp_unshard_params),
                             ("stream", training.make_fsdp_stream_train_step,
                              training.fsdp_stream_unshard_params))
                else:
                    rstep = StepClock(training.make_adamw_spmd_train_step(
                        cfg, mesh, lr=TRAIN_LR))
                    st = training.adamw_init(ref)
                    ref_losses = []
                    for _ in range(FS_STEPS):
                        ref, st, loss = rstep(ref, st, tokens)
                        ref_losses.append(float(loss))
                    del st
                    paths = (("stream_adamw",
                              training.make_fsdp_stream_adamw_step,
                              training.fsdp_stream_unshard_params),)
                for name, factory, unshard in paths:
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    made = factory(cfg, mesh, lr=TRAIN_LR)
                    step, shard = StepClock(made[0]), made[1]
                    flat = shard(p0)
                    state = made[2](flat) if len(made) > 2 else None

                    def steps():
                        nonlocal flat, state
                        out = []
                        for _ in range(FS_STEPS):
                            if state is None:
                                flat, loss = step(flat, tokens)
                            else:
                                flat, state, loss = step(flat, state,
                                                         tokens)
                            out.append(float(loss))
                        return out
                    losses, launches[f"slice_fsdp_{name}"] = run_path(
                        ("flash_attention_partial", "flash_attention_bwd"),
                        steps)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    rel, equal = update_rel_l2(training, unshard(flat, like),
                                               ref, p0)
                    runs[name] = {"losses": losses, "ref_losses": ref_losses,
                                  "step_ms": step.ms,
                                  "ref_step_ms": rstep.ms,
                                  "update_rel_l2_max": max(rel.values()),
                                  "update_rel_l2": rel, "bit_equal": equal,
                                  "peak_mem_gib": peak,
                                  "launches": launches[f"slice_fsdp_{name}"]}
                    if not (max(rel.values()) <= GRAD_REL_L2_TOL):
                        failures.append(f"slice_fsdp {name}: updates vs the "
                                        f"SPMD step's {rel}")
                    if any(abs(a - b) > 1e-3 * abs(b)
                           for a, b in zip(losses, ref_losses)):
                        failures.append(f"slice_fsdp {name}: losses {losses}"
                                        f" vs the SPMD step's {ref_losses}")
                    if name == "stream":
                        # The flat storage through a checkpoint and back,
                        # read as rank 0 of 1 (checkpoint.FlatShard).
                        path = os.path.join(tmp, "flat")
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        rec["bytes"] = trainer.save_state(
                            path, training.fsdp_gather_flat(
                                flat, mesh, stream=True), {}, FS_STEPS)
                        rec["save_s"] = time.perf_counter() - t0
                        t0 = time.perf_counter()
                        back, _, back_step = trainer.load_state(
                            path, like_params=flat, like_opt={},
                            shardings={"params": training.fsdp_shardings(
                                like, 1, 0, stream=True)})
                        torch.cuda.synchronize()
                        rec["restore_s"] = time.perf_counter() - t0
                        rec["equal"] = back_step == FS_STEPS and all(
                            torch.equal(a, b) for a, b in zip(
                                training.tree_leaves(back),
                                training.tree_leaves(flat)))
                        del back
                        if not rec["equal"]:
                            failures.append("slice_fsdp: the restored flat "
                                            "checkpoint differs")
                    del flat, state, made, step
                del ref
        finally:
            dist.destroy_process_group()
    want = {"flash_attention_partial": 2 * L * FS_STEPS,
            "flash_attention_bwd": L * FS_STEPS, "flash_attention": 0}
    for path_, got in launches.items():
        if any(got[k] != n for k, n in want.items()):
            failures.append(f"{path_} launches {got}, expected {want}")
    emit({"phase": "slice_fsdp", "model": "gemma_2b",
          "params": cfg.num_params(), "remat": cfg.remat,
          "batch": FS_BATCH, "seq": FS_SEQ, "mesh": {"fsdp": 1},
          "steps": FS_STEPS, "lr": TRAIN_LR, "runs": runs,
          "checkpoint": rec, "update_rel_l2_tol": GRAD_REL_L2_TOL,
          "card": card})
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def slice_pipeline(torch, np, cfg, dev, card, run_path, failures):
    """slice_pipeline (see the module docstring): Gemma-2B through the
    three schedules at pp 1, each held against the whole batch's plain
    gradient. Returns the launch counts by path."""
    import importlib
    dist = importlib.import_module("torch.distributed")
    training = importlib.import_module("tpushare_torch.models.training")
    tt = importlib.import_module("tpushare_torch.models.transformer")
    pl = importlib.import_module("tpushare_torch.models.pipeline")
    pmesh = importlib.import_module("tpushare_torch.parallel.mesh")
    L = cfg.n_layers
    params = tt.init_params(torch.Generator(device=dev).manual_seed(12), cfg)
    tokens = torch.as_tensor(fs_tokens(np, cfg, 12), device=dev)
    launches, runs = {}, {}
    clock = StepClock(training.value_and_grad)
    for _ in range(2):                       # the second call is timed
        ref_loss, ref_g = clock(training.xent_loss, params, tokens[:, :-1],
                                tokens[:, 1:], cfg)
    ref_loss = float(ref_loss)
    with tempfile.TemporaryDirectory() as tmp:
        world1(torch, dist, os.path.join(tmp, "store"))
        try:
            mesh = pmesh.make_mesh({"pp": 1})
            stage = pl.stage_params(params, 1, 0)
            for sched in ("gpipe", "1f1b", "interleaved"):
                p = (pl.to_interleaved_storage(stage, 1, PP_CHUNKS)
                     if sched == "interleaved" else stage)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                fn = StepClock(pl.pp_loss_and_grads)
                kw = dict(schedule=sched, n_microbatches=PP_M,
                          n_chunks=PP_CHUNKS)
                fn(p, tokens, cfg, mesh, **kw)                   # warm-up
                (loss, g), launches[f"slice_pipeline_{sched}"] = run_path(
                    ("flash_attention", "flash_attention_bwd"), fn, p,
                    tokens, cfg, mesh, **kw)
                peak = torch.cuda.max_memory_allocated() / 2**30
                rel = grad_rel_l2(training, g, ref_g)
                runs[sched] = {"loss": float(loss), "grad_ms": fn.ms[1],
                               "first_grad_ms": fn.ms[0],
                               "grad_rel_l2_max": max(rel.values()),
                               "grad_rel_l2": rel, "peak_mem_gib": peak,
                               "launches": launches[
                                   f"slice_pipeline_{sched}"]}
                if not (max(rel.values()) <= GRAD_REL_L2_TOL):
                    failures.append(f"slice_pipeline {sched}: gradients vs "
                                    f"the whole batch's {rel}")
                if abs(float(loss) - ref_loss) > 1e-3 * abs(ref_loss):
                    failures.append(f"slice_pipeline {sched}: loss "
                                    f"{float(loss)} vs {ref_loss}")
                del g, p
            del ref_g
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            astep = StepClock(pl.make_pp_adamw_train_step(
                cfg, mesh, n_microbatches=PP_M, lr=TRAIN_LR,
                schedule="1f1b"))
            state = training.adamw_init(stage)
            (stage, state, aloss), launches["slice_pipeline_adamw"] = \
                run_path(("flash_attention", "flash_attention_bwd"), astep,
                         stage, state, tokens)
            runs["adamw_1f1b"] = {
                "loss": float(aloss), "step_ms": astep.ms[0],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "count": int(state["count"]),
                "launches": launches["slice_pipeline_adamw"]}
            if abs(float(aloss) - ref_loss) > 1e-3 * abs(ref_loss) or \
                    not math.isfinite(float(aloss)):
                failures.append(f"slice_pipeline adamw: loss {float(aloss)}"
                                f" vs {ref_loss}")
            del state
        finally:
            dist.destroy_process_group()
    lc = L // PP_CHUNKS
    want = {"gpipe": (2 * L * PP_M, L * PP_M),
            "1f1b": (L * PP_M, L * PP_M),
            "interleaved": ((2 * lc + lc) * PP_M, L * PP_M),
            "adamw": (L * PP_M, L * PP_M)}
    for sched, (fwd, bwd) in want.items():
        got = launches[f"slice_pipeline_{sched}"]
        if got["flash_attention"] != fwd or \
                got["flash_attention_bwd"] != bwd or \
                got["flash_attention_partial"]:
            failures.append(f"slice_pipeline {sched} launches {got}, "
                            f"expected {fwd} forward, {bwd} gradient")
    emit({"phase": "slice_pipeline", "model": "gemma_2b",
          "params": cfg.num_params(), "remat": cfg.remat,
          "batch": FS_BATCH, "seq": FS_SEQ, "mesh": {"pp": 1},
          "microbatches": PP_M, "n_chunks": PP_CHUNKS, "ref_loss": ref_loss,
          "ref_grad_ms": clock.ms[1], "runs": runs,
          "grad_rel_l2_tol": GRAD_REL_L2_TOL, "card": card})
    del params, stage
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_pp_check(torch, np, moe, cfg, params, mesh, dev, run_path,
                 failures):
    """slice_moe_train's pp step: moe_pp_loss_and_grads at pp 1 and M 2
    under psum (capacity 1.25) and dropless, each against the
    per-microbatch objective (the mean of moe.lm_loss over the
    microbatches, tests/test_moe_pipeline.py's oracle) through the same
    kernels, so routes match; then one make_moe_pp_train_step. Returns
    ({run: record}, launch counts by path)."""
    import importlib
    training = importlib.import_module("tpushare_torch.models.training")
    mp = importlib.import_module("tpushare_torch.models.moe_pipeline")
    tokens = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (MPP_M, MPP_SEQ + 1)), device=dev)
    out, launches = {}, {}
    for name, routing, factor in (("psum_capacity", "psum", 1.25),
                                  ("dropless", "dropless", None)):
        rcfg = dataclasses.replace(cfg, routing=routing,
                                   capacity_factor=factor)

        def per_mb(p):
            return torch.stack([moe.lm_loss(p, tokens[m:m + 1], rcfg)
                                for m in range(MPP_M)]).mean()
        ref_loss, ref_g = training.value_and_grad(per_mb, params)
        fn = StepClock(mp.moe_pp_loss_and_grads)
        (loss, g), launches[f"slice_moe_train_pp_{name}"] = run_path(
            ("flash_attention", "flash_attention_bwd"), fn, params, tokens,
            rcfg, mesh, n_microbatches=MPP_M)
        rel = grad_rel_l2(training, g, ref_g)
        out[name] = {"loss": float(loss), "ref_loss": float(ref_loss),
                     "grad_ms": fn.ms[0], "grad_rel_l2_max": max(rel.values()),
                     "grad_rel_l2": rel,
                     "launches": launches[f"slice_moe_train_pp_{name}"]}
        if not (max(rel.values()) <= GRAD_REL_L2_TOL) or \
                abs(float(loss) - float(ref_loss)) > 1e-3 * abs(
                    float(ref_loss)):
            failures.append(f"slice_moe_train pp {name}: loss {float(loss)}"
                            f" vs {float(ref_loss)}, gradients {rel}")
        del g, ref_g
        gc.collect()
        torch.cuda.empty_cache()
    step = StepClock(mp.make_moe_pp_train_step(
        dataclasses.replace(cfg, routing="psum", capacity_factor=1.25), mesh,
        n_microbatches=MPP_M, lr=TRAIN_LR))
    (params, sloss), launches["slice_moe_train_pp_step"] = run_path(
        ("flash_attention", "flash_attention_bwd"), step, params, tokens)
    out["sgd_step"] = {"loss": float(sloss), "step_ms": step.ms[0],
                       "launches": launches["slice_moe_train_pp_step"]}
    if abs(float(sloss) - out["psum_capacity"]["loss"]) > 1e-3 * abs(
            out["psum_capacity"]["loss"]):
        failures.append(f"slice_moe_train pp step: loss {float(sloss)} vs "
                        f"{out['psum_capacity']['loss']}")
    return out, launches


def slice_saturation(card, failures):
    """slice_saturation (see the module docstring): tools/saturation.py's
    placement (A) and its four ResNet-50 tenants on the card (B)."""
    import importlib
    sat = importlib.import_module("tpushare_torch.tools.saturation")
    t0 = time.perf_counter()
    record = sat.run(sat.build_parser().parse_args(
        ["--seconds", str(SAT_SECONDS)]), log=lambda line: None)
    failures += [f"slice_saturation {f}" for f in record["failures"]]
    b = record["B"]
    emit({"phase": "slice_saturation", "model": "resnet50",
          "batch": b["solo"]["batch"], "image": b["solo"]["image"],
          "placement": record["A"], "grant_bytes": b["grant_bytes"],
          "units_advertised": b["units_advertised"],
          "hbm_binpack_pct": b["hbm_binpack_pct"],
          "solo_images_per_sec": b["solo_images_per_sec"],
          "four_images_per_sec": b["four_images_per_sec"],
          "four_total_images_per_sec": b["four_total_images_per_sec"],
          "four_over_solo": b["four_over_solo"],
          "peak_reserved": [r.get("max_memory_reserved")
                            for r in [b["solo"]] + b["four"]],
          "breaches": [r["hbm_breaches"] for r in [b["solo"]] + b["four"]],
          "logit_rel_err": [r["logit_rel_err"]
                            for r in [b["solo"]] + b["four"]],
          "logit_rel_tol": sat.LOGIT_REL_TOL,
          "tenants": [b["solo"]] + b["four"],
          "seconds": time.perf_counter() - t0, "card": card})


# The kernels each part of slice_mesh must launch on its ranks.
MESH_NEEDS = {"engine": ("flash_attention", "paged_flash_verify",
                         "paged_flash_decode"),
              "direct": ("flash_attention", "paged_flash_decode",
                         "paged_flash_verify"),
              "moe_psum": ("flash_attention", "paged_flash_decode",
                           "q8_expert_ffn"),
              "moe_a2a": ("flash_attention", "paged_flash_decode",
                          "q8_expert_ffn")}


def slice_mesh(card, failures, before_kill=None):
    """slice_mesh (see the module docstring): tools/multichip.py's
    placement (A), Llama-3-8B over tp=2 (B), Mixtral's experts over
    ep=2 (C), elastic serving (E) and the two small pods (D); calls
    ``before_kill`` before E's process case. Returns each part's kernel
    launches, summed over its ranks."""
    import importlib
    mc = importlib.import_module("tpushare_torch.tools.multichip")
    gang = importlib.import_module("tpushare_torch.parallel.gang")
    t0 = time.perf_counter()
    record = mc.run(mc.build_parser().parse_args([]),
                    log=lambda line: None, before_kill=before_kill)
    failures += [f"slice_mesh {f}" for f in record["failures"]]
    bc = record["BC"]
    for part, names in MESH_NEEDS.items():
        got = bc["launches"][part]
        for name in names:
            if got.get(name, 0) <= 0:
                failures.append(f"slice_mesh {part}: {name} was not "
                                f"launched on its ranks ({got})")
    work = bc["stats"].get("work_ticks") or bc["stats"].get("fused_ticks")
    kill = record["E_kill"]
    emit({"phase": "slice_mesh", "part": "E", "model": "llama3_8b tp=2",
          "chip": bc["E"], "kill": kill,
          "heartbeat_timeout_s": gang.HEARTBEAT_TIMEOUT_S, "card": card})
    emit({"phase": "slice_mesh", "model": "llama3_8b tp=2, mixtral "
          f"{mc.MOE_LAYERS} layers ep=2", "placement": record["A"],
          "transport": bc["transport"], "printed": bc.get("printed"),
          "engine_stats": bc["stats"], "ready_s": bc["ready_s"],
          "http_s": bc["http_s"], "twin_s": bc["twin_s"],
          "ranks_s": bc["ranks_s"], "build_s": bc["build_s"],
          "ms_per_tick": bc["ms_per_tick"], "engine_work_ticks": work,
          "engine_ms_per_work_tick": (bc["http_s"] * 1e3 / work
                                      if work else None),
          "flips": {k: bc[k] for k in ("engine_flips", "direct_flips",
                                      "spec_flips")},
          "admit_logit_rel": bc["admit_logit_rel"],
          "logit_rel_tol": mc.LOGIT_REL_TOL, "moe": bc["moe"],
          "moe_logit_rel_tol": mc.MOE_LOGIT_REL_TOL,
          "memory_per_rank": bc["memory"], "launches": bc["launches"],
          "small_tenants": record["D"]["tenants"],
          "failures": record["failures"],
          "seconds": time.perf_counter() - t0, "card": card})
    out = {f"slice_mesh_{k}": v for k, v in bc["launches"].items()}
    # Part E's process case ran its own rank processes: the launches of
    # rank 0 and of both of rank 1's processes, each its last record's.
    ends = [(kill["generations"][who] or {None: {}})
            for who in ("rank0", "rank1", "rank1_restarted")]
    out["slice_mesh_e_kill"] = _sum_counts(
        _cumulative(g) for g in ends)
    return out


def _cumulative(gens):
    """A rank process's launches in all, from its per-generation
    counts."""
    total = {}
    for g in gens.values():
        for k, v in (g.get("launches") or {}).items():
            total[k] = total.get(k, 0) + v
    return total


def _sum_counts(counts):
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# slice_smokes: each smoke, its command, and the kernels it must launch.
# The first three run side by side; the SLO storm, whose gate is a
# latency deadline, runs alone after them.
SMOKES = (
    ("chaos_dense", ("tpushare_torch.chaos.smoke", "--family", "dense"),
     ("flash_attention", "paged_flash_decode")),
    ("chaos_moe_paged", ("tpushare_torch.chaos.smoke", "--family",
                         "moe_paged"),
     ("flash_attention", "paged_flash_decode", "q8_expert_ffn")),
    ("durable", ("tpushare_torch.durable.smoke",), ()),
    ("slo", ("tpushare_torch.slo.smoke",),
     ("flash_attention", "paged_flash_decode")))
SMOKE_TIMEOUT_S = 600


class SliceSmokes:
    """slice_smokes (see the module docstring): the three CI storm
    smokes as processes on the card at their card presets. ``start``
    launches the side smokes (chaos dense, chaos moe_paged, durable),
    which run beside slice_mesh's process case; ``finish`` waits for
    them, then runs the SLO storm alone, and returns each in-process
    smoke's kernel launches."""

    def __init__(self, failures, card):
        self.failures, self.card, self.side = failures, card, {}

    def start(self):
        self.t0 = time.perf_counter()
        self.side = {name: (_start_smoke(name, cmd), needs)
                     for name, cmd, needs in SMOKES[:3]}

    def kill(self):
        """Stop the side smokes (a phase before them failed)."""
        for (proc, _, _), _ in self.side.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(30)

    def finish(self):
        if not self.side:
            self.start()
        launches = {}
        for name, (job, needs) in self.side.items():
            launches[f"slice_smokes_{name}"] = _finish_smoke(
                name, needs, job, self.failures, self.card)
        name, cmd, needs = SMOKES[3]
        launches[f"slice_smokes_{name}"] = _finish_smoke(
            name, needs, _start_smoke(name, cmd), self.failures,
            self.card)
        return launches


def _start_smoke(name, cmd):
    path = os.path.join(tempfile.gettempdir(), f"smoke_{name}.log")
    err = open(path, "w")
    proc = subprocess.Popen([sys.executable, "-m", *cmd],
                            stdout=subprocess.PIPE, stderr=err, text=True,
                            start_new_session=True)
    err.close()
    return proc, path, time.perf_counter()


def _finish_smoke(name, needs, job, failures, card):
    proc, path, t0 = job
    try:
        out, _ = proc.communicate(timeout=SMOKE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not rec.get("ok"):
        with open(path) as f:
            tail = f.read()[-1500:]
        failures.append(f"slice_smokes {name}: exit {proc.returncode}, "
                        f"record {rec}: {tail}")
    got = rec.get("launches", {})
    for k in needs:
        if not got.get(k):
            failures.append(f"slice_smokes {name}: {k} was not launched "
                            f"({got})")
    emit({"phase": "slice_smokes", "smoke": name, "rc": proc.returncode,
          "record": rec, "seconds": time.perf_counter() - t0,
          "card": card})
    return got


def slice_generate(torch, np, paged, cfg, dev, card, run_path, no_launch,
                   moe, m_params, m_cfg, failures):
    """slice_generate (see the module docstring). Returns launch counts
    by path."""
    import importlib
    tg = importlib.import_module("tpushare_torch.models.generate")
    sp = importlib.import_module("tpushare_torch.models.speculative")
    quant = importlib.import_module("tpushare_torch.models.quant")
    tt = importlib.import_module("tpushare_torch.models.transformer")
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(12)
    params = tt.init_params(gen, cfg, device=dev)
    qparams = quant.quantize_params(params, cfg)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, GEN_PROMPT_LEN)
               for _ in range(GEN_PROMPTS)]
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    launches = {}
    # Warm-up (cuBLAS choices, allocator growth), then the timed runs.
    tg.generate(params, toks[:, :16], cfg, max_new_tokens=4)
    rows = []
    orig = tg.sample_logits

    def recording(logits, *a, **kw):
        rows.append(logits.float().clone())
        return orig(logits, *a, **kw)
    tg.sample_logits = recording
    try:
        clock = StepClock(tg.generate)
        out, launches["slice_generate_dense"] = run_path(
            ("flash_attention",), clock, params, toks, cfg,
            max_new_tokens=GEN_NEW)
    finally:
        tg.sample_logits = orig
    gen_ms = clock.ms[0]
    streams = out[:, GEN_PROMPT_LEN:].tolist()
    d_streams, d_rows, _ = direct_run(
        torch, paged, cfg, params, prompts, list(range(GEN_PROMPTS)),
        GEN_NEW, GEN_PROMPTS * ((GEN_PROMPT_LEN + GEN_NEW) // 16 + 2) + 1,
        16, n_slots=GEN_PROMPTS)
    flips = {i: stream_flips(streams[i], d_streams[i], d_rows[i],
                             LOGIT_REL_TOL) for i in range(GEN_PROMPTS)}
    # int8-self speculation, greedy: must give generate's output.
    hook = quant.dequant_hook(cfg)
    calls = [0]

    def counting_hook(layer):
        calls[0] += 1
        return hook(layer)
    sclock = StepClock(sp.speculative_generate)
    sout, launches["slice_generate_spec"] = run_path(
        ("flash_attention",), sclock, params, qparams, toks, cfg,
        max_new_tokens=GEN_NEW, gamma=GEN_GAMMA,
        draft_layers_hook=counting_hook)
    # The draft's forwards: its prefill, then gamma steps and one
    # catch-up write a round.
    rounds = (calls[0] // L - 1) // (GEN_GAMMA + 1)
    accepted = (GEN_NEW - 1) - rounds
    spec_equal = torch.equal(sout, out)
    spec_parts = []
    if not spec_equal:
        for i in range(GEN_PROMPTS):
            s_row = sout[i, GEN_PROMPT_LEN:].tolist()
            for pos, (a, b) in enumerate(zip(s_row, streams[i])):
                if a != b:
                    row = rows[pos][i]
                    top2 = row.topk(2).values
                    spec_parts.append({"prompt": i, "pos": pos,
                                       "gap": float((top2[0] - top2[1])
                                                    / row.abs().max())})
                    break
        failures.append(f"slice_generate: speculative_generate differs from "
                        f"generate: {spec_parts}")
    bad = [t for s_ in streams for t in s_ if not 0 <= t < cfg.vocab_size]
    if bad:
        failures.append(f"slice_generate: tokens outside the vocabulary: "
                        f"{bad[:8]}")
    want_dense = {"flash_attention": L * GEN_NEW, "flash_decode": 0,
                  "paged_flash_decode": 0}
    if any(launches["slice_generate_dense"][k] != n
           for k, n in want_dense.items()):
        failures.append(f"slice_generate: generate's launches "
                        f"{launches['slice_generate_dense']}, expected "
                        f"{want_dense}")
    del params, qparams, rows, d_rows
    gc.collect()
    torch.cuda.empty_cache()
    # moe.generate on slice_moe_train's trained 2-layer Mixtral: the
    # prefill's logits against the reference twin (routes replayed).
    m_toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, m_cfg.vocab_size, (2, 256)), device=dev)
    mclock = StepClock(moe.generate)
    m_out, launches["slice_generate_moe"] = run_path(
        ("flash_attention",), mclock, m_params, m_toks, m_cfg,
        max_new_tokens=MOE_GEN_NEW)
    with torch.no_grad():
        with Routes(moe) as rec:
            k_logits, _ = rec.wrap(moe.forward)(m_params, m_toks, m_cfg)
        with Routes(moe, replay=rec.calls) as rep:
            r_logits, _ = no_launch(rep.wrap(moe.forward), m_params, m_toks,
                                    m_cfg, attn_impl="reference")
    m_rel = float((k_logits - r_logits).abs().max() / r_logits.abs().max())
    m_ok = (m_out.shape == (2, 256 + MOE_GEN_NEW)
            and bool(((m_out >= 0) & (m_out < m_cfg.vocab_size)).all())
            and torch.equal(m_out[:, :256], m_toks))
    if not m_ok or not (m_rel <= MOE_LOGIT_REL_TOL):
        failures.append(f"slice_generate: moe.generate shape/tokens ok "
                        f"{m_ok}, prefill logits vs twin {m_rel}")
    emit({"phase": "slice_generate", "model": "gemma_2b",
          "prompts": GEN_PROMPTS, "prompt_len": GEN_PROMPT_LEN,
          "new_tokens": GEN_NEW, "generate_ms": gen_ms,
          "generate_ms_per_token": gen_ms / GEN_NEW,
          "direct_flips": {i: f for i, f in flips.items() if f},
          "spec_equal": spec_equal, "spec_parts": spec_parts,
          "spec_gamma": GEN_GAMMA, "spec_rounds": rounds,
          "spec_accept_rate": accepted / (rounds * GEN_GAMMA),
          "spec_ms": sclock.ms[0],
          "spec_ms_per_token": sclock.ms[0] / GEN_NEW,
          "moe": {"layers": m_cfg.n_layers, "new_tokens": MOE_GEN_NEW,
                  "ms": mclock.ms[0], "prefill_logit_rel": m_rel,
                  "tokens": m_out[:, 256:].tolist()},
          "launches": launches, "card": card})
    return launches


KV_TIER_BYTES = 2 << 30
KV_ARGV = ["--preset", "gemma_2b", "--n-slots", "8", "--n-blocks", "256",
           "--block-size", "16", "--port", "0", "--seed", "0"]


def gpu_memory():
    """nvidia-smi's reading of the card's used memory and of each
    process's (MiB)."""
    def q(args):
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines() if out.returncode == 0 \
            else [f"nvidia-smi failed: {out.stderr.strip()}"]
    return {"card": q(["--query-gpu=memory.used,memory.total"]),
            "processes": q(["--query-compute-apps=pid,used_memory"])}


def engine_bytes(eng):
    """Device bytes an engine holds: weights and KV pools."""
    import torch
    c = eng.srv.cache
    pools = [c.pool_k, c.pool_v, c.pool_k_scale, c.pool_v_scale]
    leaves, stack = [], [eng.srv.params]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, torch.Tensor):
            leaves.append(x)
    return {"weights": sum(t.nbytes for t in leaves),
            "pools": sum(t.nbytes for t in pools if t is not None)}


def tier_report(stats):
    """Bytes per channel, measured rates and decisions of one engine's
    host tier (its /stats block)."""
    ht = stats["host_tier"]
    cx = ht["crossover"]
    return {"channels": cx["channels"], "prefill": cx["prefill"],
            "decisions": cx["decisions"],
            **{k: ht[k] for k in ("demotions", "promotions", "migrations_in",
                                  "evictions", "demote_failures",
                                  "promote_failures", "blocks_resident",
                                  "bytes_resident", "prefetch_hit_rate")}}


def kv_request(eng, port, prompt, max_tokens):
    """One completion over HTTP: (tokens, cached_prefix, TTFT ms)."""
    st, body = http_json(port, "POST", "/v1/completions",
                         {"prompt": prompt.tolist(),
                          "max_tokens": max_tokens})
    if st != 200:
        raise AssertionError(f"slice_kv_economy: request answered {st} "
                             f"{body}")
    req = eng.request_by_id(body["id"])
    return (body["tokens"], body["cached_prefix"],
            (req.t_first - req.t_submit) * 1e3)


def kv_demote_promote(serve_mod, torch, prompts, extra, failures, card):
    """Phase (A) on one argv variant. The tiered engine serves the
    warm-up W twice (a cold admission, then a device prefix hit: the
    shapes A's admissions take), A (a 1024-token prefix + 100,
    recomputed), fillers that demote A's chain to the host tier, A again
    (promoted from host memory), fillers again, a prefetch of A's chain
    on the engine thread (the overlapped tick's side-stream upload), and
    A a third time (promoted from the staged copy). The oracle engine,
    same argv without the tier (it never evicts), serves W, W and A three
    times (device prefix hits). One request at a time, so the streams
    compare bit for bit."""
    warm, a, fillers = prompts
    out = {}
    for name, argv in (
            ("tier", KV_ARGV + extra + ["--host-kv-bytes",
                                         str(KV_TIER_BYTES)]),
            ("oracle", KV_ARGV + extra)):
        eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(
            argv))
        httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
        port = httpd.server_address[1]
        run = {"warm": [kv_request(eng, port, warm, 8)
                        for _ in range(2)],
               "a1": kv_request(eng, port, a, 32)}
        tier = eng._host_tier
        if tier is not None:
            run["fillers"] = [kv_request(eng, port, f, 8)[1]
                              for f in fillers[:4]]
            run["demoted_before_a2"] = tier.demotions
        run["a2"] = kv_request(eng, port, a, 32)
        if tier is not None:
            for f in fillers[4:]:
                kv_request(eng, port, f, 8)
            run["staged"] = eng._engine_call(
                lambda: eng.srv.prefetch_prefix(a))
            run["prefetch_hits_before_a3"] = tier.prefetch_hits
        run["a3"] = kv_request(eng, port, a, 32)
        run["stats"] = eng.stats()
        if tier is not None:
            run["prefetch_hits"] = tier.prefetch_hits \
                - run["prefetch_hits_before_a3"]
        run["bytes"] = engine_bytes(eng)
        stop_engine(httpd, eng)
        del eng, httpd, tier
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = run
    t, o = out["tier"], out["oracle"]
    tag = "slice_kv_economy A" + (" kv_quant" if extra else "")
    ht = t["stats"]["host_tier"]
    for key in ("a1", "a2", "a3"):
        if t[key][0] != o[key][0]:
            failures.append(f"{tag}: {key} stream {t[key][0]} differs from "
                            f"the never-evicted engine's {o[key][0]}")
        if key != "a1" and (t[key][1] < 1024 or t[key][1] != o[key][1]):
            failures.append(f"{tag}: {key} reused {t[key][1]} tokens "
                            f"(oracle {o[key][1]})")
    if not (ht["demotions"] > 0 and ht["promotions"] > 0):
        failures.append(f"{tag}: demotions {ht['demotions']}, promotions "
                        f"{ht['promotions']}")
    if not (t["staged"] > 0 and t["prefetch_hits"] == t["staged"]):
        failures.append(f"{tag}: prefetch staged {t['staged']} blocks, "
                        f"the admission took {t['prefetch_hits']}")
    for name in out:
        st = out[name]["stats"]
        if st["device_fetches"] != st["work_ticks"]:
            failures.append(f"{tag} {name}: {st['device_fetches']} fetches "
                            f"in {st['work_ticks']} ticks")
    emit({"phase": "slice_kv_economy", "part": "A",
          "kv_quant": bool(extra), "argv": KV_ARGV + extra,
          "host_kv_bytes": KV_TIER_BYTES,
          "streams_equal": {k: t[k][0] == o[k][0]
                            for k in ("a1", "a2", "a3")},
          "cached_prefix": {k: t[k][1] for k in ("a1", "a2", "a3")},
          "oracle_cached_prefix": {k: o[k][1] for k in ("a1", "a2", "a3")},
          "ttft_ms": {"recomputed": t["a1"][2],
                      "promoted_host_upload": t["a2"][2],
                      "promoted_prefetched": t["a3"][2],
                      "oracle_recomputed": o["a1"][2],
                      "oracle_device_hit": [o["a2"][2], o["a3"][2]],
                      "warm_up": [w[2] for w in t["warm"]]},
          "filler_cached_prefix": t["fillers"],
          "demoted_before_promotion": t["demoted_before_a2"],
          "prefetch_staged": t["staged"],
          "prefetch_hits": t["prefetch_hits"],
          "tier": tier_report(t["stats"]),
          "fetches_per_tick": {k: out[k]["stats"]["fetches_per_tick"]
                               for k in out},
          "engine_bytes": t["bytes"], "card": card})


def kv_migration(serve_mod, torch, np, prompts, failures, card):
    """Phase (B): two tiered engines on the one card behind the port's
    router; replica 0 is warmed with 8 prompts sharing a 1024-token
    prefix, drained, and a storm of 8 follow-ups on the same prefix goes
    through the router, which instructs replica 1 to pull the chain
    (POST /kv/migrate). The oracle: one engine, same argv without the
    tier, serving the warm prompts and then the follow-ups."""
    import importlib
    router_mod = importlib.import_module("tpushare_torch.router")
    daemon = importlib.import_module("tpushare_torch.router.daemon")
    warm, follow, probe = prompts

    def storm(port, ps, max_tokens):
        res = [None] * len(ps)

        def go(i):
            try:
                res[i] = http_json(port, "POST", "/v1/completions",
                                   {"prompt": ps[i].tolist(),
                                    "max_tokens": max_tokens})
            except Exception as e:          # noqa: BLE001 — lost
                res[i] = (None, {"error": str(e)})
        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(ps))]
        for t_ in ts:
            t_.start()
        for t_ in ts:
            t_.join(600)
        return res

    eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(
        KV_ARGV))
    httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
    port = httpd.server_address[1]
    o_warm = storm(port, warm, 8)
    want = storm(port, follow, 32)
    o_stats = eng.stats()
    stop_engine(httpd, eng)
    del eng, httpd
    gc.collect()
    torch.cuda.empty_cache()
    if any(r[0] != 200 for r in o_warm + want):
        raise AssertionError("slice_kv_economy B: the oracle failed")

    reps = []
    mem = {"before": gpu_memory(), "allocated_before":
           torch.cuda.memory_allocated()}
    for _ in range(2):
        eng = serve_mod.build_engine(serve_mod.build_parser().parse_args(
            KV_ARGV + ["--host-kv-bytes", str(KV_TIER_BYTES)]))
        httpd = serve_mod.serve(eng, port=0, timeout_s=600.0)
        reps.append((eng, httpd, httpd.server_address[1]))
    urls = [f"http://127.0.0.1:{p}" for _, _, p in reps]
    router = router_mod.Router(urls, poll_interval_s=0.1,
                               breaker_threshold=3, retry_budget=2,
                               shed_wait_s=1.0, migrate_min_blocks=2,
                               request_timeout_s=600.0)
    rhttpd = daemon.serve_router(router, "127.0.0.1", 0)
    try:
        warm_res = storm(reps[0][2], warm + [probe], 8)
        if any(r[0] != 200 for r in warm_res):
            raise AssertionError("slice_kv_economy B: replica 0's warm-up "
                                 "failed")
        router.poll_once()
        reps[0][0].begin_drain()
        router.poll_once()
        mem["two_replicas"] = gpu_memory()
        mem["allocated_two_replicas"] = torch.cuda.memory_allocated()
        mem["engine_bytes"] = [engine_bytes(e) for e, _, _ in reps]
        t0 = time.perf_counter()
        got = storm(rhttpd.server_address[1], follow, 32)
        storm_s = time.perf_counter() - t0
        # The sink's decision once its net and prefill rates are
        # measured: the pull the router would instruct for a second
        # chain replica 0 holds (no completion rides on it).
        keys = router_mod.chain_keys_hex(probe, 16, 64)
        _, probe_out = http_json(reps[1][2], "POST", "/kv/migrate",
                                 {"source": urls[0], "keys": keys})
        rstats = router.stats()
        r_stats = [e.stats() for e, _, _ in reps]
    finally:
        rhttpd.shutdown()
        router.stop()
        for e, h, _ in reps:
            stop_engine(h, e)
        del reps
        gc.collect()
        torch.cuda.empty_cache()
    exact = clean_503 = 0
    bad = []
    for i, (w, g) in enumerate(zip(want, got)):
        if g[0] == 200 and g[1].get("tokens") == w[1]["tokens"]:
            exact += 1
        elif g[0] == 503:
            clean_503 += 1
        else:
            bad.append((i, g[0], g[1].get("tokens", g[1])))
    ht1 = r_stats[1]["host_tier"]
    if bad:
        failures.append(f"slice_kv_economy B: answers not equal to the "
                        f"oracle's nor a clean 503: {bad}")
    if not (rstats["migrations_instructed"] > 0
            and rstats["migrated_blocks"] > 0):
        failures.append(f"slice_kv_economy B: router instructed "
                        f"{rstats['migrations_instructed']}, migrated "
                        f"{rstats['migrated_blocks']} blocks")
    if not (ht1["migrations_in"] > 0 and ht1["promotions"] > 0):
        failures.append(f"slice_kv_economy B: replica 1 migrations_in "
                        f"{ht1['migrations_in']}, promotions "
                        f"{ht1['promotions']}")
    if not (r_stats[1]["fetches_per_tick"] or 0) <= 1.0:
        failures.append(f"slice_kv_economy B: replica 1 fetches_per_tick "
                        f"{r_stats[1]['fetches_per_tick']}")
    emit({"phase": "slice_kv_economy", "part": "B",
          "argv": KV_ARGV + ["--host-kv-bytes", str(KV_TIER_BYTES)],
          "requests": len(follow), "token_exact": exact,
          "clean_503": clean_503,
          "cached_prefix": [g[1].get("cached_prefix") for g in got],
          "oracle_cached_prefix": [w[1]["cached_prefix"] for w in want],
          "storm_s": storm_s, "measured_pull": probe_out,
          "router": {k: rstats[k] for k in (
              "migrations_instructed", "migrations_failed",
              "migrated_blocks", "affinity_hits", "retries", "shed")},
          "replica_tiers": [tier_report(s) for s in r_stats],
          "fetches_per_tick": [s["fetches_per_tick"] for s in r_stats],
          "oracle_fetches_per_tick": o_stats["fetches_per_tick"],
          "memory": mem, "card": card})


def slice_kv_economy(torch, np, cfg, card, run_path, failures):
    """The slice_kv_economy phase (see the module docstring): returns
    the launch counts of (A) bf16, (A) kv_quant and (B); gate breaches
    go to ``failures``."""
    import importlib
    serve_mod = importlib.import_module("tpushare_torch.cli.serve")
    rng = np.random.default_rng(9)
    V = cfg.vocab_size
    warm = rng.integers(0, V, 1124)
    a = rng.integers(0, V, 1124)
    # 1480 + 8 decoded tokens fit the blocks an admission reserves: no
    # filler grows on the decode path, where reclaims destroy (as in the
    # reference) instead of demoting.
    fillers = [rng.integers(0, V, 1480) for _ in range(8)]
    launches = {}
    for name, extra, needed in (
            ("a", [], ("flash_attention", "paged_flash_decode")),
            ("a_kv_quant", ["--kv-quant"],
             ("flash_attention", "paged_flash_decode_int8"))):
        _, launches[name] = run_path(
            needed, kv_demote_promote, serve_mod, torch,
            (warm, a, fillers), extra, failures, card)
    bprefix = rng.integers(0, V, 1024)
    b_warm = [np.concatenate([bprefix, rng.integers(0, V, 64)])
              for _ in range(8)]
    b_follow = [np.concatenate([bprefix, rng.integers(0, V, 64)])
                for _ in range(8)]
    b_probe = rng.integers(0, V, 1088)
    _, launches["b"] = run_path(
        ("flash_attention", "paged_flash_decode"), kv_migration, serve_mod,
        torch, np, (b_warm, b_follow, b_probe), failures, card)
    return launches


class AssumedPod:
    """A pod manager whose one candidate is an extender-assumed pod of
    ``units`` naming card ``idx`` (absent on a one-card node)."""

    def __init__(self, units, idx):
        from tpushare_torch.k8s.types import Pod
        from tpushare_torch.plugin import const
        self.pod = Pod({
            "metadata": {"name": "assumed", "namespace": "default",
                         "uid": "uid-assumed", "annotations": {
                             const.ANN_RESOURCE_INDEX: str(idx),
                             const.ANN_ASSUME_TIME: str(time.time_ns()),
                             const.ANN_ASSIGNED_FLAG: "false"}},
            "spec": {"nodeName": "node-1", "containers": [
                {"name": "c0", "resources": {"limits": {
                    const.RESOURCE_NAME: units}}}]},
            "status": {"phase": "Pending"}})

    def get_candidate_pods(self):
        return [self.pod]


def colocate_discovery(failures, card):
    """(A) NVML's topology through ChainBackend's cross-check against
    torch, held to nvidia-smi; the fake-device count."""
    from tpushare_torch.plugin.backend import (ChainBackend, TorchBackend,
                                               topology_to_json)
    from tpushare_torch.plugin.devices import expand_devices
    from tpushare_torch.plugin.nvmldisc import (Nvml, NvmlBackend,
                                                load_library)
    chain = ChainBackend([NvmlBackend(), TorchBackend()])
    topo = chain.probe()
    with Nvml(load_library()) as nv:
        names = [nv.name(nv.handle(c.index)) for c in topo.chips]
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,memory.total",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    smi = [[f.strip() for f in line.split(",")]
           for line in out.stdout.strip().splitlines()]
    devmap = expand_devices(topo)
    got = [[c.uuid, n, str(c.hbm_bytes >> 20)]
           for c, n in zip(topo.chips, names)]
    if getattr(chain._active, "name", None) != "nvml":
        failures.append(f"slice_colocate A: {chain._active} answered, "
                        f"not NVML")
    if chain.checked_against != "torch" or chain.disagreement:
        failures.append(f"slice_colocate A: cross-check against torch: "
                        f"{chain.checked_against}, {chain.disagreement}")
    if got != smi:
        failures.append(f"slice_colocate A: NVML {got} vs nvidia-smi {smi}")
    units = {c.index: c.hbm_bytes >> 30 for c in topo.chips}
    if devmap.units_per_chip != units:
        failures.append(f"slice_colocate A: {devmap.units_per_chip} fake "
                        f"devices per card, floor(total / GiB) is {units}")
    emit({"phase": "slice_colocate", "part": "A",
          "topology": json.loads(topology_to_json(topo)), "names": names,
          "nvidia_smi": smi, "cross_check": chain.checked_against,
          "disagreement": chain.disagreement,
          "torch_total_memory": TorchBackend().probe().chips[0].hbm_bytes,
          "fake_devices": len(devmap.devices), "card": card})
    return topo


def colocate_allocate(colocate, topo, failures, card):
    """(B) The port's Allocator on its single-card fast path, through
    ``Allocator.allocate`` on the kubelet's messages, for the whole
    card, 16 + 16 and the hog's 8; then the poison path: an assumed pod
    naming a card this node lacks."""
    from tpushare_torch.plugin import const
    from tpushare_torch.utils.tenant import AllocationError, read_tenant_env
    alloc, devmap = colocate.single_card_allocator(topo, const.GIB)
    chip = topo.chips[0]
    whole = devmap.units_per_chip[chip.index]
    grants = {}
    for name, units in (("solo", whole), ("co_0", 16), ("co_1", 16),
                        ("hog", 8)):
        r = colocate.allocate(alloc, devmap, units)
        envs = dict(r.envs)
        grants[name] = {"envs": envs,
                        "devices": [d.host_path for d in r.devices]}
        want = {const.ENV_NVIDIA_VISIBLE_DEVICES: str(chip.index),
                const.ENV_HBM_LIMIT_BYTES: str(units << 30),
                const.ENV_RESOURCE_BY_DEV: str(whole),
                const.ENV_RESOURCE_BY_CONTAINER: str(units)}
        bad = {k: envs.get(k) for k, v in want.items() if envs.get(k) != v}
        nodes = [chip.device_path, *topo.shared_device_paths]
        if bad or grants[name]["devices"] != nodes:
            failures.append(f"slice_colocate B {name}: {bad}, devices "
                            f"{grants[name]['devices']} (want {nodes})")
    missing = max(c.index for c in topo.chips) + 1
    palloc, pmap = colocate.single_card_allocator(
        topo, const.GIB, podmgr=AssumedPod(8, missing))
    poison = dict(colocate.allocate(palloc, pmap, 8).envs)
    with mock.patch.dict(os.environ, poison):
        try:
            read_tenant_env()
            raised = None
        except AllocationError as e:
            raised = str(e)
    if not (poison.get(const.ENV_NVIDIA_VISIBLE_DEVICES, "").startswith(
            "no-gpu-has-8GiB") and raised):
        failures.append(f"slice_colocate B: poison {poison}, "
                        f"read_tenant_env raised {raised}")
    emit({"phase": "slice_colocate", "part": "B", "units_per_card": whole,
          "grants": grants, "poison": poison,
          "poison_read_tenant_env": raised, "card": card})
    return {name: g["envs"] for name, g in grants.items()}


def slice_colocate(failures, card):
    """The slice_colocate phase (see the module docstring): runs A and
    B, and returns C and D as two functions of no arguments, which may
    run side by side. A and B run first because B patches this
    process's env for a moment."""
    import importlib
    colocate = importlib.import_module("tpushare_torch.tools.colocate")
    topo = colocate_discovery(failures, card)
    envs = colocate_allocate(colocate, topo, failures, card)
    args = colocate.build_parser().parse_args([])
    return (functools.partial(colocate_aba, colocate, envs, args, failures,
                              card),
            functools.partial(colocate_isolation, colocate, envs, args,
                              failures, card))


def colocate_aba(colocate, envs, args, failures, card):
    """(C) A-B-A: solo (the whole card), two tenants of 16 GiB, solo."""
    rec = colocate.measure(envs["solo"], envs["co_0"], args,
                           log=lambda s: emit({"phase": "slice_colocate",
                                               "part": "C",
                                               **json.loads(s)}))
    w = rec["windows"]
    tenants = [w["solo_a1"], *w["colocated"], w["solo_a2"]]
    digests = {t["pooled_sha256"] for t in tenants}
    if len(digests) != 1:
        failures.append(f"slice_colocate C: pooled outputs differ across "
                        f"tenants: {digests}")
    for t in tenants:
        if t["hbm_breaches"] or not t["pooled_finite"]:
            failures.append(f"slice_colocate C: stream {t['stream']} "
                            f"breaches {t['hbm_breaches']}, finite "
                            f"{t['pooled_finite']}")
    err = w["solo_a1"]["pooled_vs_f32_max_abs"]
    if not err <= colocate.POOLED_BF16_TOL:
        failures.append(f"slice_colocate C: solo pooled vs the f32 twin "
                        f"{err} > {colocate.POOLED_BF16_TOL}")
    emit({"phase": "slice_colocate", "part": "C", "model": "bert_base",
          "batch": 8, "seq": 128, "seconds": args.seconds,
          "colocated_pct": rec["colocated_pct"],
          "solo_variance_pct": rec["solo_variance_pct"],
          "credible": rec["credible"],
          "refusal_reasons": rec["refusal_reasons"],
          "sat_colocated_pct": rec["sat_colocated_pct"],
          "serve_tokens_per_sec": {
              "solo_a1": w["solo_a1"]["serve_tokens_per_sec"],
              "colocated": [t["serve_tokens_per_sec"]
                            for t in w["colocated"]],
              "solo_a2": w["solo_a2"]["serve_tokens_per_sec"]},
          "sat_tokens_per_sec": {
              "solo_a1": w["solo_a1"]["sat_tokens_per_sec"],
              "colocated": [t["sat_tokens_per_sec"] for t in w["colocated"]],
              "solo_a2": w["solo_a2"]["sat_tokens_per_sec"]},
          "mfu_pct": {"solo_a1": w["solo_a1"].get("mfu_pct"),
                      "colocated": [t.get("mfu_pct")
                                    for t in w["colocated"]]},
          "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
          "breaches": [t["hbm_breaches"] for t in tenants],
          "memory_reserved": [t["memory_reserved"] for t in tenants],
          "nvml_processes": [t["nvml_processes"] for t in tenants],
          "pooled_vs_f32_max_abs": err,
          "pooled_tol": colocate.POOLED_BF16_TOL,
          "pooled_bit_equal": len(digests) == 1,
          "solo_profile": w["solo_a1"].get("profile"), "card": card})


def colocate_isolation(colocate, envs, args, failures, card):
    """(D) Isolation: the HOG (8 GiB) beside STEADY (16 GiB), then the
    planted fault, the HOG with enforcement off and isolation disabled."""
    iso = colocate.isolation(envs["hog"], envs["co_0"], args)
    planted = colocate.planted_hog(envs["hog"], args)
    hog, step = iso["hog"], iso["hog"]["step_bytes"]
    if not (hog["stopped_by"] in ("OutOfMemoryError", "SoftHbmOom")
            and hog["memory_reserved_at_stop"] <= hog["limit_bytes"] + step):
        failures.append(f"slice_colocate D: the HOG stopped by "
                        f"{hog['stopped_by']} at "
                        f"{hog['memory_reserved_at_stop']} reserved")
    if planted["stopped_by"] is not None \
            or not planted["held_bytes"] > planted["limit_bytes"] + step:
        failures.append(f"slice_colocate D: the planted HOG stopped by "
                        f"{planted['stopped_by']} at "
                        f"{planted['held_bytes']}: the gate cannot fail")
    if iso["steady"]["hbm_breaches"]:
        failures.append(f"slice_colocate D: STEADY breached "
                        f"{iso['steady']['hbm_breaches']} times")
    emit({"phase": "slice_colocate", "part": "D", "hog": hog,
          "planted": planted,
          "steady_tokens_per_sec": iso["steady_tokens_per_sec"],
          "steady_windows": iso["steady"]["windows"],
          "steady_memory_reserved": iso["steady"]["memory_reserved"],
          "card": card})


def slice_plugin(failures, card):
    """The slice_plugin phase (see the module docstring); returns the
    two serving tenants' kernel launches, summed."""
    import importlib
    binpack = importlib.import_module("tpushare_torch.tools.binpack")
    args = binpack.build_parser().parse_args([])
    rec = binpack.run(args, log=lambda s: emit({
        "phase": "slice_plugin", **json.loads(s), "card": card}))
    failures += [f"slice_plugin {f}" for f in rec["failures"]]
    tenants = rec["C"]["tenants"]
    launches = {}
    for t in tenants:
        for name, n in t.get("launches", {}).items():
            launches[name] = launches.get(name, 0) + n
    emit({"phase": "slice_plugin", "part": "summary",
          "register_s": rec["A"]["register_s"],
          "filter_bind_ms": {n: v["filter_ms"] + v["bind_ms"]
                             for n, v in rec["B"]["schedule"].items()},
          "allocate_ms": {n: g["allocate_ms"]
                          for n, g in rec["B"]["grants"].items()},
          "tenant_ready_s": rec["C"]["tenant_ready_s"],
          **{k: [t.get(k) for t in tenants]
             for k in ("ttft_ms", "ms_per_token", "max_memory_reserved",
                       "max_memory_allocated")},
          "launches": launches, "detect_s": rec["D"].get("detect_s"),
          "recover_s": rec["D"].get("recover_s"),
          "xid_source": rec["E"]["xid_source"],
          "xid_wait_errors": rec["E"]["xid_wait_errors"],
          "default_sources": rec["E"]["default_sources"],
          "failures": rec["failures"], "seconds": rec["seconds"],
          "card": card})
    return launches


def main() -> int:
    # A crash in native code (the card's driver, a kernel, NVML) leaves
    # every thread's Python stack on stderr, here and in the processes
    # the phases start.
    faulthandler.enable()
    os.environ.setdefault("PYTHONFAULTHANDLER", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import importlib

    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    from tpushare_torch.models import (convert, moe, paged, quant, serving,
                                       trainer, training)
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.ops import _build
    from tpushare_torch.parallel import mesh as pmesh
    ring = importlib.import_module("tpushare_torch.parallel.ring_attention")
    fa = importlib.import_module("tpushare_torch.ops.flash_attention")
    attn = importlib.import_module("tpushare_torch.ops.attention")
    q8 = importlib.import_module("tpushare_torch.ops.q8_expert")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # flex_attention's compiled kernels are cached inside the checkout.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(_build.BUILD_DIR, sub))
    dev = torch.device("cuda")
    card = nvidia_smi()
    t_start = time.perf_counter()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(logs),
          "ptxas": {n: ptxas_summary(log) for n, log in logs.items()}})

    # The slices' workloads, fixed first so the kernels phase can test
    # exactly the shapes the slices will launch.
    cfg = tt.gemma_2b()
    bs, n_blocks, ticks = 16, 1024, 32
    rng = np.random.default_rng(0)
    lengths = [16, 100, 255, 511, 700, 1024, 1500, 2048]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    shared = [(7, 1024, 200), (4, 512, 64)]     # (prompt, prefix, new)
    wave2 = [np.concatenate([prompts[i][:n], rng.integers(0, cfg.vocab_size,
                                                          m)])
             for i, n, m in shared]
    lcfg = tt.llama3_8b()
    l_blocks, l_mb, chunk, gamma, rounds = 8 * 256 + 1, 256, 512, 4, 16
    la_len, lb_len = [100, 511, 1024, 2048], [700, 1500, 2048, 3000]
    lrng = np.random.default_rng(1)
    wave_a = [lrng.integers(0, lcfg.vocab_size, n) for n in la_len]
    wave_b = [lrng.integers(0, lcfg.vocab_size, n) for n in lb_len]

    # Prefill launches: each whole admission attends its whole padded
    # row, Sq = comp_len - cached_len queries at q_offset cached_len
    # over Sk = comp_len keys (the Gemma slice's second wave reuses its
    # whole shared prefix, which the slice checks below).
    def prefill_shapes(admissions, nb):
        out = []
        for S, cached in admissions:
            _, comp = paged.admission_len(S, cached, bs, nb)
            if (comp - cached, comp, cached) not in out:
                out.append((comp - cached, comp, cached))
        return out

    path_shapes = prefill_shapes(
        [(len(p), 0) for p in prompts]
        + [(len(p), n) for p, (_, n, _) in zip(wave2, shared)], n_blocks)
    l_shapes = prefill_shapes([(n, 0) for n in la_len], l_mb)

    def work(sh):
        return causal_pairs(sh[0], sh[1], sh[2], None)
    # The planted causal-edge fault goes on the largest prefix-hit case.
    fault_shape = max((sh for sh in path_shapes if sh[2] > 0), key=work)
    # Decode positions of the Gemma slice's last wave-1 tick.
    dec_pos = [n + ticks - 1 for n in lengths]
    dec_pages = [p // bs + 1 for p in dec_pos]
    # The Llama slice: fused ticks' shapes, and the lengths its
    # speculative round / first decode tick start from.
    l_ticks, l_base, l_spec_pages = llama_schedule(
        serving, paged, la_len, lb_len, chunk, bs, gamma)
    widths = sorted({w for w, _, _ in l_ticks})
    fused_cases = []
    for w in widths:      # the tick of each width with the most context
        _, pos, pages = max((t for t in l_ticks if t[0] == w),
                            key=lambda t: sum(t[1]))
        fused_cases.append((w, pos, pages))
    # slice_moe: Mixtral-8x7B from its published config. 3 whole
    # admissions, 2 by fused ticks in 256-token chunks, a 4th whole one
    # (the rows server's prefix registry keeps the latest admission),
    # then a prompt that reuses 560 of the 4th's tokens.
    mc = importlib.import_module("tpushare_torch.tools.multichip")
    mcfg = convert.moe_config_from_hf(
        types.SimpleNamespace(**mc.MIXTRAL_8X7B))
    mrng = np.random.default_rng(2)
    m_whole, m_chunked = [64, 300, 700, 1000], [200, 280]
    m_prompts = [mrng.integers(0, mcfg.vocab_size, n)
                 for n in m_whole + m_chunked]
    m_reuse = 560
    m_sched = {"whole": m_prompts[:4], "chunked": m_prompts[4:],
               "prefix_prompt": np.concatenate([
                   m_prompts[3][:m_reuse],
                   mrng.integers(0, mcfg.vocab_size, 60)]),
               "chunk": 256, "ticks": 16, "max_len": 4096, "mb": 128}
    m_rows_c, m_paged_c = moe_widths(
        serving, paged, m_whole, m_chunked,
        (len(m_sched["prefix_prompt"]), m_reuse), m_sched["chunk"], bs,
        m_sched["max_len"], m_sched["mb"])
    # slice_rows: Gemma-2-2B over dense rows; two prompts past the 4096
    # window, the longest admitted in prefill_chunk pieces, one more
    # admission finished by a fused tick.
    gcfg = tt.gemma2_2b()
    grng = np.random.default_rng(3)
    g_len = [200, 700, 1500, 4500, 6000]
    g_sched = {"whole": [grng.integers(0, gcfg.vocab_size, n)
                         for n in g_len],
               "fused_prompt": grng.integers(0, gcfg.vocab_size, 300),
               "chunk": 512, "ticks": 16, "max_len": 8192,
               "prefill_chunk": 5000}
    # flash_decode positions of slice_rows' last timed tick: each whole
    # slot advanced by the fused tick and 16 ticks, the fused slot by
    # 16, two idle slots at 0.
    g_dec_pos = ([n + 1 + g_sched["ticks"] - 1 for n in g_len]
                 + [300 + g_sched["ticks"] - 1, 0, 0])

    t_k = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    pre_g = [
        prefill_case(fa, attn, F, torch, dev, flush,
                     f"gemma2b_sq{Sq}_sk{Sk}_off{off}", Sq, Sk, 8, 1, 256,
                     q_offset=off, fault=(Sq, Sk, off) == fault_shape)
        for Sq, Sk, off in path_shapes]
    pre_l = [
        prefill_case(fa, attn, F, torch, dev, flush,
                     f"llama3_8b_sq{Sq}_sk{Sk}_off{off}", Sq, Sk, 32, 8,
                     128, q_offset=off)
        for Sq, Sk, off in l_shapes]
    # slice_moe_spec (Mixtral width: 32/8 heads, head_dim 128): each
    # whole admission's padded row.
    ms_mb, ms_nb = moe_spec_schedule(paged)
    ms_comp = [paged.admission_len(n, 0, bs, ms_mb)[1] for n in MS_LENGTHS]
    pre_m = [prefill_case(fa, attn, F, torch, dev, flush,
                          f"mixtral_sq{c}_sk{c}_off0", c, c, 32, 8, 128,
                          q_offset=0) for c in sorted(set(ms_comp))]
    pre = pre_g + pre_l + pre_m + [
        prefill_case(fa, attn, F, torch, dev, flush,
                     "gemma2_window_softcap", 512, 1024, 8, 4, 256,
                     q_offset=512, window=256, softcap=50.0),
    ]
    # The fine-tuning and generation paths' shapes (Gemma-2B: 8/1 heads,
    # head_dim 256; Mixtral: 32/8, 128). slice_generate: generate's
    # prefill into its dense cache (4 rows of 512 prompt tokens, the
    # cache 512 + 64 rows), then every S = 1 step at its scalar offset;
    # speculative_generate's cache holds gamma + 1 more rows, its draft
    # steps (S = 1) and its verify and catch-up blocks (S = gamma + 1)
    # checked at every offset the cache can take them at; moe.generate's
    # prefill (2 rows of 256, 32 new). slice_finetune: the engine's
    # admission of a tenant's prompt (finetune_serve.BLOCK + 1 tokens,
    # blocks of 16, 4 a slot), and the LoRA step's forward with its lse
    # (4 x 1024); slice_moe_train's forward with its lse (1 x 4096).
    P, g_sk = GEN_PROMPT_LEN, GEN_PROMPT_LEN + GEN_NEW
    s_sk, gw = g_sk + GEN_GAMMA + 1, GEN_GAMMA + 1
    fs = importlib.import_module("tpushare_torch.tools.finetune_serve")
    lc = paged.admission_len(fs.BLOCK + 1, 0, 16, 4)[1]
    gpc = functools.partial(prefill_case, fa, attn, F, torch, dev, flush)
    pre_n = [
        gpc(f"gemma2b_generate_b4_sq{P}_sk{g_sk}_off0", P, g_sk, 8, 1, 256,
            q_offset=0, B=GEN_PROMPTS),
        gpc(f"gemma2b_generate_b4_sq1_sk{g_sk}", 1, g_sk, 8, 1, 256,
            q_offset=P, more_offsets=range(P + 1, g_sk), B=GEN_PROMPTS,
            fault=True),
        gpc(f"gemma2b_spec_b4_sq{P}_sk{s_sk}_off0", P, s_sk, 8, 1, 256,
            q_offset=0, B=GEN_PROMPTS),
        gpc(f"gemma2b_spec_b4_sq1_sk{s_sk}", 1, s_sk, 8, 1, 256,
            q_offset=P, more_offsets=range(P + 1, s_sk), B=GEN_PROMPTS),
        gpc(f"gemma2b_spec_b4_sq{gw}_sk{s_sk}", gw, s_sk, 8, 1, 256,
            q_offset=P, more_offsets=range(P + 1, s_sk - gw + 1),
            B=GEN_PROMPTS, fault=True),
        gpc(f"mixtral_generate_b2_sq256_sk{256 + MOE_GEN_NEW}_off0", 256,
            256 + MOE_GEN_NEW, 32, 8, 128, q_offset=0, B=2),
        gpc(f"gemma2b_lifecycle_sq{lc}_sk{lc}_off0", lc, lc, 8, 1, 256,
            q_offset=0),
        gpc("gemma2b_lora_train_b4_s1024", 1024, 1024, 8, 1, 256,
            q_offset=0, B=4, lse=True),
        gpc(f"mixtral_train_s{MT_SEQ}", MT_SEQ, MT_SEQ, 32, 8, 128,
            q_offset=0, lse=True),
        # slice_pipeline's microbatch (1 x 1024 of its 4 x 1024 batch)
        # and slice_moe_train's pp microbatch (1 x 2048, Mixtral), each
        # with its lse (the training forward) and the causal-edge fault.
        gpc(f"gemma2b_pp_mb1_s{FS_SEQ}", FS_SEQ, FS_SEQ, 8, 1, 256,
            q_offset=0, lse=True, fault=True),
        gpc(f"mixtral_pp_mb1_s{MPP_SEQ}", MPP_SEQ, MPP_SEQ, 32, 8, 128,
            q_offset=0, lse=True, fault=True),
    ]
    pc = functools.partial(paged_case, fa, F, torch, np, dev, flush)
    dec = [
        pc("paged_flash_decode", "gemma2b_b8", dec_pos, dec_pages, 1, 8, 1,
           256, share=(2, 5), fault="page"),
        pc("paged_flash_decode", "llama3_8b_draft_b8", l_base,
           l_spec_pages, 1, 32, 8, 128, nb=l_blocks, mb=l_mb),
        pc("paged_flash_decode", "gemma2_window_softcap", dec_pos,
           dec_pages, 1, 8, 4, 256, window=1024, softcap=50.0,
           share=(2, 5)),
    ]
    # slice_moe_spec's round: draft steps and the target's verify at the
    # positions each slot reaches once every prompt is in (4 slots).
    ms_pos = [n + 1 for n in MS_LENGTHS]
    ms_pages = [(p + gamma) // bs + 1 for p in ms_pos]
    dec_m = [pc("paged_flash_decode", "mixtral_spec_draft_b4",
                [p + gamma - 1 for p in ms_pos], ms_pages, 1, 32, 8, 128,
                nb=ms_nb, mb=ms_mb)]
    ver_m = [pc("paged_flash_verify", "mixtral_spec_verify_sq5", ms_pos,
                ms_pages, gamma + 1, 32, 8, 128, nb=ms_nb, mb=ms_mb)]
    dec += dec_m
    dec8 = [
        pc("paged_flash_decode", "llama3_8b_kvq_b8", l_base,
           [n // bs + 1 for n in l_base], 1, 32, 8, 128, nb=l_blocks,
           mb=l_mb, int8=True, fault="scale"),
    ]
    ver, ver8 = [], []
    for int8, out in ((False, ver), (True, ver8)):
        tag = "_int8" if int8 else ""
        out.append(pc("paged_flash_verify", f"llama3_8b_spec_sq5{tag}",
                      l_base, l_spec_pages, gamma + 1, 32, 8, 128,
                      nb=l_blocks, mb=l_mb, int8=int8,
                      fault="scale" if int8 else "causal"))
        for w, pos, pages in fused_cases:
            out.append(pc("paged_flash_verify",
                          f"llama3_8b_fused_sq{w}{tag}", pos, pages, w,
                          32, 8, 128, nb=l_blocks, mb=l_mb, int8=int8,
                          fault=None if int8 else "causal"))
    ver += ver_m + [
        pc("paged_flash_verify", "gemma2b_sq5", dec_pos,
           [(p + gamma) // bs + 1 for p in dec_pos], gamma + 1, 8, 1, 256,
           share=(2, 5)),
        pc("paged_flash_verify", "gemma2_window_softcap_sq5", dec_pos,
           [(p + gamma) // bs + 1 for p in dec_pos], gamma + 1, 8, 4, 256,
           window=1024, softcap=50.0, share=(2, 5)),
    ]
    # q8_expert_ffn at Mixtral width on one layer's int8 experts: every
    # token-block size the slice_moe servers launch (dense dispatch),
    # a per-expert block at capacity 1.25 of a 512-token block, gelu.
    gen = torch.Generator(device=dev).manual_seed(4)
    E, Dm, Fd = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    mw = []
    for shape, fan in (((Dm, Fd), Dm), ((Dm, Fd), Dm), ((Fd, Dm), Fd)):
        qs = [quant.quantize_weight((torch.randn(
            *shape, generator=gen, device=dev) / fan ** 0.5).to(
                torch.bfloat16)) for _ in range(E)]
        mw += [torch.stack([q for q, _ in qs]),
               torch.stack([s_ for _, s_ in qs])]
        del qs
    # slice_moe_spec's int8 draft: its decode rows (one per slot) and its
    # whole admissions' padded rows, every expert on the shared block.
    m_path_c = sorted(set(m_rows_c) | set(m_paged_c) | {MS_SLOTS}
                      | set(ms_comp))
    q8c = functools.partial(q8_case, q8, F, torch, dev, flush)
    q8_path = [q8c(f"mixtral_c{C}", mw, C, True, fault=C == 8)
               for C in m_path_c]
    cap_c = moe.expert_capacity(512, dataclasses.replace(
        mcfg, capacity_factor=1.25))
    q8_all = q8_path + [
        q8c(f"mixtral_per_expert_c{cap_c}", mw, cap_c, False),
        q8c("mixtral_gelu_c8", mw, 8, True, act="gelu")]
    # slice_mesh's per-rank shapes (tools/multichip.py): Mixtral's
    # experts at ep=2 (4 local experts): the decode tick's and the
    # largest admission's shared blocks (psum), and a2a's queues of
    # ep x the capacity of a rank's share (ceil(T / 2) tokens) rows.
    mm_cfg, mm_prompts, _, (mm_nb, mm_bs) = mc.moe_workload(False)
    mm_slots = len(mm_prompts)
    mm_comp = max(paged.admission_len(len(p_), 0, mm_bs, mm_nb)[1]
                  for p_ in mm_prompts)
    mw4 = [t[:mcfg.n_experts // 2].contiguous() for t in mw]
    a2a_cfg = dataclasses.replace(mcfg,
                                  capacity_factor=mc.a2a_capacity(mcfg))
    q8_mesh = [q8c(f"mixtral_ep2_c{mm_slots}", mw4, mm_slots, True,
                   fault=True),
               q8c(f"mixtral_ep2_c{mm_comp}", mw4, mm_comp, True)] + [
        q8c(f"mixtral_ep2_a2a_c{2 * c}", mw4, 2 * c, False)
        for c in sorted({moe.expert_capacity(-(-T // 2), a2a_cfg)
                         for T in (mm_slots, mm_comp)})]
    q8_all += q8_mesh
    del mw, mw4
    # slice_mesh's Llama-3-8B at tp=2: 16 query and 4 kv heads per rank,
    # at every direct admission's padded row, the decode tick's
    # positions and the speculative round's verify.
    mc_argv, _, mc_prompts, mc_tokens, mc_ticks, _, mc_gamma = \
        mc.llama_workload(False)

    def mc_flag(name):
        return int(mc_argv[mc_argv.index(name) + 1])
    mc_nb = mc_flag("--n-blocks")
    mc_lens = [len(p_) for p_ in mc_prompts]
    mc_comp = sorted({paged.admission_len(n, 0, bs, mc_nb)[1]
                      for n in mc_lens})
    pre_mesh = [gpc(f"llama3_8b_tp2_sq{c}_sk{c}_off0", c, c, 16, 4, 128,
                    q_offset=0, fault=c == mc_comp[-1]) for c in mc_comp]
    mc_pos = [n + mc_ticks - 1 for n in mc_lens]
    dec_mesh = [pc("paged_flash_decode", "llama3_8b_tp2_b8", mc_pos,
                   [p_ // bs + 1 for p_ in mc_pos], 1, 16, 4, 128,
                   nb=mc_nb, fault="page")]
    ver_mesh = [pc("paged_flash_verify", "llama3_8b_tp2_spec_sq5", mc_lens,
                   [(n + mc_gamma) // bs + 1 for n in mc_lens], mc_gamma + 1,
                   16, 4, 128, nb=mc_nb, fault="causal")]
    # The engine's ticks at 16/4 heads: each fused width of its chunked
    # admissions (the tick of that width with the most context), and
    # its decode tick over its slots.
    e_slots = mc_flag("--n-slots")
    e_ticks, (e_pos, e_pages) = engine_schedule(
        serving, paged, mc_lens, e_slots, mc_flag("--prefill-chunk"), bs,
        mc_tokens)
    for w in sorted({w for w, _, _ in e_ticks}):
        _, pos, pages = max((t for t in e_ticks if t[0] == w),
                            key=lambda t: sum(t[1]))
        ver_mesh.append(pc("paged_flash_verify", f"llama3_8b_tp2_fused_sq{w}",
                           pos, pages, w, 16, 4, 128, nb=mc_nb,
                           fault="causal"))
    dec_mesh.append(pc("paged_flash_decode",
                       f"llama3_8b_tp2_engine_b{e_slots}", e_pos, e_pages, 1,
                       16, 4, 128, nb=mc_nb, fault="page"))
    fdc = functools.partial(flash_decode_case, fa, F, torch, np, dev, flush)
    fdec = [fdc("gemma2_2b_local", g_dec_pos, g_sched["max_len"], 8, 4, 256,
                window=gcfg.sliding_window, softcap=gcfg.attn_softcap,
                fault=True),
            fdc("gemma2_2b_global", g_dec_pos, g_sched["max_len"], 8, 4, 256,
                softcap=gcfg.attn_softcap)]
    # slice_train's attention layer (a), and a 4-hop ring (b). Their gate
    # breaches (and slice_train's) are gathered in ``failures``.
    failures = []
    part_a, bwd_a = zip(*[attention_layer_cases(
        fa, torch, dev, flush, failures, f"gemma2_2b_{wn}_s{TRAIN_SEQ}",
        TRAIN_SEQ, 8, 4, 256, win, gcfg.attn_softcap, flex=win is None)
        for wn, win in (("local", gcfg.sliding_window), ("global", None))])
    torch.cuda.empty_cache()
    part_b, bwd_b = ring_cases(fa, ring, F, torch, dev, flush, failures, 4,
                               2048, 32, 8, 128)
    torch.cuda.empty_cache()
    # The gradient at slice_finetune's LoRA step (4 x 1024, Gemma-2B) and
    # at slice_moe_train's steps (1 x 4096, Mixtral; its fit's one-hop
    # ring runs the partial kernel at this shape too).
    # The new training paths' shapes: slice_fsdp's batch (4 x 1024: its
    # one-hop ring runs the partial kernel), slice_pipeline's microbatch
    # and slice_moe_train's pp microbatch (their gradients).
    part_n, bwd_n = zip(*[attention_layer_cases(
        fa, torch, dev, flush, failures, name, S, H, Hkv, D, None, None,
        B=B) for name, B, S, H, Hkv, D in (
            ("gemma2b_lora_b4_s1024", 4, 1024, 8, 1, 256),
            (f"mixtral_s{MT_SEQ}", 1, MT_SEQ, 32, 8, 128),
            (f"gemma2b_fsdp_b{FS_BATCH}_s{FS_SEQ}", FS_BATCH, FS_SEQ, 8, 1,
             256),
            (f"gemma2b_pp_mb1_s{FS_SEQ}", 1, FS_SEQ, 8, 1, 256),
            (f"mixtral_pp_mb1_s{MPP_SEQ}", 1, MPP_SEQ, 32, 8, 128))])
    del flush
    torch.cuda.empty_cache()
    kernels_s = time.perf_counter() - t_k

    # -- slice: Gemma-2B at full width over the paged pool -------------
    t_g = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tt.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # Warm-up: one short pass of the same workload through the plain
    # path, so neither timed server pays the process's first cuBLAS
    # choices and allocator growth for every GEMM shape (the first
    # server to run would otherwise carry them alone).
    serve(paged, cfg, params, prompts, wave2, "reference", 2)
    torch.cuda.empty_cache()

    counters = (("flash_attention", fa.flash_attention, "launches"),
                ("paged_flash_decode", fa.paged_flash_decode, "launches"),
                ("paged_flash_decode_int8", fa.paged_flash_decode,
                 "launches_int8"),
                ("paged_flash_verify", fa.paged_flash_verify, "launches"),
                ("paged_flash_verify_int8", fa.paged_flash_verify,
                 "launches_int8"),
                ("q8_expert_ffn", q8.q8_expert_ffn, "launches"),
                ("flash_decode", fa.flash_decode, "launches"),
                ("flash_attention_partial", fa.flash_attention_partial,
                 "launches"),
                ("flash_attention_bwd", fa.flash_attention_bwd, "launches"))

    def zero_counts():
        for _, fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr) for name, fn, attr in counters}

    def run_path(needed, fn, *a, **kw):
        """Drive one main path with every count zeroed just before and
        read just after; each kernel variant in ``needed`` must have
        launched."""
        zero_counts()
        out = fn(*a, **kw)
        got = read_counts()
        for name in needed:
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"main path")
        return out, got

    def no_launch(fn, *a, **kw):
        """A reference twin: must launch no kernel at all."""
        zero_counts()
        out = fn(*a, **kw)
        if any(read_counts().values()):
            raise AssertionError(f"a reference server launched a kernel: "
                                 f"{read_counts()}")
        return out

    run, launches = run_path(
        ("flash_attention", "paged_flash_decode"), serve, paged, cfg,
        params, prompts, wave2, "auto", ticks, profile=4)
    ref = no_launch(serve, paged, cfg, params, prompts, wave2, "reference",
                    ticks, profile=4)
    V = cfg.vocab_size
    toks = [t for s in run["streams"].values() for t in s]
    if not all(0 <= t < V for t in toks):
        raise AssertionError("a served token is outside [0, V)")
    if run["hits"] != [n for _, n, _ in shared]:
        raise AssertionError(f"second wave's prefix hits {run['hits']}, "
                             f"expected the whole shared prefix")
    rel = []
    if run["rows"] != ref["rows"]:
        raise AssertionError("the two servers' active slots differ")
    for a, b, r in zip(run["logits"], ref["logits"], run["rows"]):
        if a.shape != b.shape:
            raise AssertionError("served logits are not shaped alike")
        a, b = a[r], b[r]
        if not torch.isfinite(a).all():
            raise AssertionError("served logits are not finite")
        rel.append(((a - b).abs().max() / b.abs().max()).item())
    # 8 + 2 admissions, and the first tick of each wave.
    n_rec = len(prompts) + len(wave2) + 2
    if len(rel) != n_rec or len(ref["logits"]) != n_rec:
        raise AssertionError(f"recorded {len(rel)} logit rows, "
                             f"expected {n_rec}")
    worst = max(rel)
    if not (worst <= LOGIT_REL_TOL):
        raise AssertionError(f"logits vs reference server: {rel}")
    agree = sum(int(x == y) for k in run["streams"]
                for x, y in zip(run["streams"][k], ref["streams"][k]))
    emit({"phase": "slice", "model": "gemma_2b", "params": cfg.num_params(),
          "init_s": init_s, "prompt_lengths": lengths,
          "wave2_cached_len": run["hits"], "prefill_shapes": path_shapes,
          "decode_ticks": ticks, "launches": launches,
          "first_tokens": list(run["first"].values()),
          "logit_rel_err_max": worst, "logit_rel_err": rel,
          "logit_rel_tol": LOGIT_REL_TOL,
          "greedy_agreement": agree / len(toks),
          "admit_s": run["admit_s"], "ref_admit_s": ref["admit_s"],
          "decode_ms_per_tick": run["decode_s"] / ticks * 1e3,
          "decode_tok_s": len(prompts) * ticks / run["decode_s"],
          "ref_decode_ms_per_tick": ref["decode_s"] / ticks * 1e3,
          "decode_ms_per_tick_median": run["tick_ms_median"],
          "ref_decode_ms_per_tick_median": ref["tick_ms_median"],
          "ref_profile": ref["profile"],
          "fetches": run["fetches"], "profile": run["profile"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t_g, "card": card})
    del params, run, ref
    torch.cuda.empty_cache()

    # -- slice_engine: the serving engine over real HTTP ----------------
    t_e = time.perf_counter()
    a_launches, b_launches, a_ms = slice_engine(
        torch, np, paged, serving, cfg, dev, card, run_path, failures)
    engine_s = time.perf_counter() - t_e

    # -- slice_engine C: multi-LoRA over Gemma-2B ------------------------
    t_c = time.perf_counter()
    c_launches = slice_engine_lora(torch, np, paged, cfg, dev, card,
                                   run_path, failures, a_ms)
    engine_lora_s = time.perf_counter() - t_c

    # -- slice_kv_economy: the host KV tier, migration and the router ---
    t_k = time.perf_counter()
    kv_launches = slice_kv_economy(torch, np, cfg, card, run_path, failures)
    kv_economy_s = time.perf_counter() - t_k

    # -- slice_colocate, slice_plugin and slice_saturation, side by side -
    # Each runs its tenants, daemon and pods as processes of their own
    # (at most ~55 GB of the card together: the plugin's two 16 GiB
    # Gemma-2B tenants, the planted HOG's 12 GiB, small BERT-base and
    # ResNet-50 tenants), gates no speed (the plugin's health deadlines
    # count in 5 s polls), and holds no cached blocks of this process;
    # meanwhile this process compiles the flex phase's library calls.
    # So their speeds are read beside each other (tools/colocate.py,
    # saturation.py and binpack.py alone measure them). BERT's attention
    # (head_dim 64, non-causal) takes mha_reference and ResNet-50 runs
    # cuDNN: no kernel of ours there.
    gc.collect()
    torch.cuda.empty_cache()
    side_s = {}

    def timed(name, fn):
        def run():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                side_s[name] = time.perf_counter() - t0
        return run

    t_side = time.perf_counter()
    colocate_c, colocate_d = timed("colocate_ab", lambda: slice_colocate(
        failures, card))()

    def isolation_then_saturation():
        timed("colocate_d", colocate_d)()
        timed("saturation", lambda: slice_saturation(card, failures))()

    _, _, _, p_launches = side_by_side(
        timed("flex_compile", compile_flex_later),
        timed("colocate_c", colocate_c), isolation_then_saturation,
        timed("plugin", lambda: slice_plugin(failures, card)))
    side_s["all"] = time.perf_counter() - t_side

    # -- slice_llama: Llama-3-8B at full width, speculative + fused + int8
    t_l = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    lparams = tt.init_params(gen, lcfg)
    qparams = quant.quantize_params(lparams, lcfg)
    torch.cuda.synchronize()
    l_init_s = time.perf_counter() - t0
    common = dict(wave_a=wave_a, wave_b=wave_b, rounds=rounds,
                  n_blocks=l_blocks, chunk=chunk)
    l_launches = {}
    for mode, needed in (
            ("spec", ("flash_attention", "paged_flash_decode",
                      "paged_flash_verify")),
            ("kvq", ("flash_attention", "paged_flash_decode_int8",
                     "paged_flash_verify_int8"))):
        kw = dict(common, mode=mode)
        lrun, l_launches[mode] = run_path(
            needed, serve_llama, paged, quant, lcfg, lparams, qparams,
            attn_impl="auto", **kw)
        lref = no_launch(serve_llama, paged, quant, lcfg, lparams, qparams,
                         attn_impl="reference", **kw)
        checks = llama_logit_checks(torch, lrun, lref, mode)
        worst_l = max(max(v) for v in checks.values())
        if not (worst_l <= LOGIT_REL_TOL):
            raise AssertionError(f"Llama {mode} logits vs reference twin: "
                                 f"{checks}")
        for what, fetches in (("fused tick", lrun["fused_fetch"]),
                              ("round" if mode == "spec" else "tick",
                               lrun["round_fetch"])):
            if any(f != (1, 1) for f in fetches):
                raise AssertionError(f"Llama {mode}: a {what} made other "
                                     f"than one fetch: {fetches}")
        ltoks = [t for v in lrun["streams"].values() for t in v]
        if not all(0 <= t < lcfg.vocab_size for t in ltoks):
            raise AssertionError("a served token is outside [0, V)")
        # Every served token advanced its slot by one position.
        want_len = [n + len(lrun["streams"][s]) - 1
                    for s, n in enumerate(la_len + lb_len)]
        if lrun["lengths"] != want_len:
            raise AssertionError(f"Llama {mode}: lengths {lrun['lengths']} "
                                 f"!= prompts + served tokens {want_len}")
        agree = sum(int(x == y) for s in lrun["streams"]
                    for x, y in zip(lrun["streams"][s], lref["streams"][s]))
        step = "round" if mode == "spec" else "tick"
        emit({
            "phase": "slice_llama", "server": mode, "model": "llama3_8b",
            "params": lcfg.num_params(), "init_s": l_init_s,
            "wave_a": la_len, "wave_b": lb_len, "chunk_tokens": chunk,
            "fused_widths": [w for w, _, _ in l_ticks],
            "gamma": gamma if mode == "spec" else None,
            "launches": l_launches[mode], "logit_rel_err": checks,
            "logit_rel_err_max": worst_l, "logit_rel_tol": LOGIT_REL_TOL,
            "greedy_agreement": agree / len(ltoks),
            "admit_s": lrun["admit_s"], "ref_admit_s": lref["admit_s"],
            "fused_ticks": len(lrun["fused_ms"]),
            "fused_ms_per_tick": mean(lrun["fused_ms_unprofiled"]),
            "ref_fused_ms_per_tick": mean(lref["fused_ms_unprofiled"]),
            "fused_profile": lrun["fused_profile"],
            "ref_fused_profile": lref["fused_profile"],
            f"ms_per_{step}": mean(lrun["round_ms"]),
            f"ms_per_{step}_median": median(lrun["round_ms"]),
            f"ref_ms_per_{step}": mean(lref["round_ms"]),
            f"{step}_profile": lrun["step_profile"],
            f"ref_{step}_profile": lref["step_profile"],
            "tok_s": lrun["emitted"] / (sum(lrun["round_ms"]) / 1e3),
            "ref_tok_s": lref["emitted"] / (sum(lref["round_ms"]) / 1e3),
            "accept_rate": lrun["accept_rate"],
            "ref_accept_rate": lref["accept_rate"],
            "fetches_per_fused_tick": sorted({f for f, _ in
                                              lrun["fused_fetch"]}),
            f"fetches_per_{step}": sorted({f for f, _ in
                                           lrun["round_fetch"]}),
            "fetches": lrun["fetches"],
            "peak_mem_gib": lrun["peak_mem_gib"],
            "ref_peak_mem_gib": lref["peak_mem_gib"],
            "seconds": time.perf_counter() - t_l, "card": card})
        del lrun, lref
    del lparams, qparams
    torch.cuda.empty_cache()

    # -- slice_moe: Mixtral-8x7B at full width and depth, int8 experts --
    t_m = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    mparams = mixtral_int8_params(torch, quant, mcfg, gen, dev)
    torch.cuda.synchronize()
    m_init_s = time.perf_counter() - t0
    m_bytes = sum(t.numel() * t.element_size() for t in
                  [mparams["embed"], mparams["unembed"],
                   mparams["final_norm"], *mparams["layers"].values()])
    m_launches = {}
    for kind, needed in (
            ("rows", ("flash_attention", "q8_expert_ffn")),
            ("paged", ("flash_attention", "q8_expert_ffn",
                       "paged_flash_decode", "paged_flash_verify"))):
        kw = dict(kind=kind, attn_impl="auto")
        mrun, m_launches[kind] = run_path(
            needed, serve_moe, torch, moe, paged, mcfg, mparams, m_sched,
            hook=quant.fused_expert_hook(mcfg), **kw)
        # Every MoE layer of every forward ran the fused int8 kernel.
        if m_launches[kind]["q8_expert_ffn"] != \
                mrun["forwards"] * mcfg.n_layers:
            raise AssertionError(f"slice_moe {kind}: q8_expert_ffn launched "
                                 f"{m_launches[kind]['q8_expert_ffn']} times "
                                 f"over {mrun['forwards']} forwards")
        mref = no_launch(serve_moe, torch, moe, paged, mcfg, mparams,
                         m_sched, hook=quant.dequant_hook(mcfg),
                         kind=kind, attn_impl="reference",
                         replay=mrun["routes"])
        checks, worst_m = served_logit_checks(torch, mrun, mref,
                                              MOE_LOGIT_REL_TOL, routes=True)
        for what, f in mrun["fetch"].items():
            if any(x != (1, 1) for x in f):
                raise AssertionError(f"slice_moe {kind}: a {what} made other "
                                     f"than one fetch: {f}")
        mtoks = [t for v in mrun["streams"].values() for t in v]
        if not all(0 <= t < mcfg.vocab_size for t in mtoks):
            raise AssertionError("a served token is outside [0, V)")
        if mrun["prefix_cached_len"] < 512:
            raise AssertionError(f"slice_moe {kind}: the prefix admission "
                                 f"reused {mrun['prefix_cached_len']} tokens")
        agree = sum(int(x == y) for s_ in mrun["streams"] for x, y in
                    zip(mrun["streams"][s_], mref["streams"][s_]))
        active = len(m_whole) + len(m_chunked)
        emit({"phase": "slice_moe", "server": kind, "model": "mixtral_8x7b",
              "params": mcfg.num_params(), "param_gib": m_bytes / 2**30,
              "init_s": m_init_s, "whole": m_whole, "chunked": m_chunked,
              "chunk_tokens": m_sched["chunk"],
              "prefix_cached_len": mrun["prefix_cached_len"],
              "q8_token_blocks": m_rows_c if kind == "rows" else m_paged_c,
              "launches": m_launches[kind], "forwards": mrun["forwards"],
              "logit_rel_err": checks, "logit_rel_err_max": worst_m,
              "logit_rel_tol": MOE_LOGIT_REL_TOL,
              "greedy_agreement": agree / len(mtoks),
              "admit_s": mrun["admit_s"], "ref_admit_s": mref["admit_s"],
              "prefix_admit_s": mrun["prefix_admit_s"],
              "fused_ticks": len(mrun["fused_ms"]),
              "fused_ms_per_tick": mean(mrun["fused_ms"]),
              "ref_fused_ms_per_tick": mean(mref["fused_ms"]),
              "ms_per_tick": mean(mrun["tick_ms"]),
              "ms_per_tick_median": median(mrun["tick_ms"]),
              "ref_ms_per_tick": mean(mref["tick_ms"]),
              "tok_s": active * len(mrun["tick_ms"])
              / (sum(mrun["tick_ms"]) / 1e3),
              "ref_tok_s": active * len(mref["tick_ms"])
              / (sum(mref["tick_ms"]) / 1e3),
              "fetches_per_fused_tick": sorted({f for f, _ in
                                                mrun["fetch"]["fused"]}),
              "fetches_per_tick": sorted({f for f, _ in
                                          mrun["fetch"]["tick"]}),
              "fetches": mrun["fetches"], "profile": mrun["profile"],
              "ref_profile": mref["profile"],
              "peak_mem_gib": mrun["peak_mem_gib"],
              "ref_peak_mem_gib": mref["peak_mem_gib"],
              "seconds": time.perf_counter() - t_m, "card": card})
        if not (worst_m <= MOE_LOGIT_REL_TOL):
            raise AssertionError(f"slice_moe {kind} logits vs the dequant "
                                 f"reference twin: {worst_m}")
        del mrun, mref
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    # -- slice_moe_spec: MoE int8-self speculation, the routings ---------
    t_ms = time.perf_counter()
    ms_launches = slice_moe_spec(torch, np, moe, paged, quant, q8, mcfg, dev,
                                 card, run_path, failures)
    moe_spec_s = time.perf_counter() - t_ms

    # -- slice_rows: Gemma-2-2B at full width and depth, dense rows ------
    t_r = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    gparams = tt.init_params(gen, gcfg)
    torch.cuda.synchronize()
    g_init_s = time.perf_counter() - t0
    rrun, r_launches = run_path(("flash_attention", "flash_decode"),
                                serve_rows, torch, serving, gcfg, gparams,
                                g_sched, attn_impl="auto")
    rref = no_launch(serve_rows, torch, serving, gcfg, gparams, g_sched,
                     attn_impl="reference")
    r_checks, worst_r = served_logit_checks(torch, rrun, rref,
                                            LOGIT_REL_TOL)
    for what, f in rrun["fetch"].items():
        if any(x != (1, 1) for x in f):
            raise AssertionError(f"slice_rows: a {what} made other than one "
                                 f"fetch: {f}")
    rtoks = [t for v in rrun["streams"].values() for t in v]
    if not all(0 <= t < gcfg.vocab_size for t in rtoks):
        raise AssertionError("a served token is outside [0, V)")
    want_len = [n + len(rrun["streams"][s_]) - 1 for s_, n in
                enumerate(g_len + [len(g_sched["fused_prompt"])])]
    if rrun["lengths"][:len(want_len)] != want_len:
        raise AssertionError(f"slice_rows: lengths {rrun['lengths']} != "
                             f"prompts + served tokens {want_len}")
    if max(rrun["lengths"]) <= gcfg.sliding_window:
        raise AssertionError("slice_rows: no row decoded past the window")
    agree = sum(int(x == y) for s_ in rrun["streams"] for x, y in
                zip(rrun["streams"][s_], rref["streams"][s_]))
    n_act = len(g_len) + 1
    emit({"phase": "slice_rows", "model": "gemma2_2b",
          "params": gcfg.num_params(), "init_s": g_init_s,
          "prompt_lengths": g_len,
          "fused_prompt": len(g_sched["fused_prompt"]),
          "prefill_chunk": g_sched["prefill_chunk"],
          "max_len": g_sched["max_len"], "launches": r_launches,
          "logit_rel_err": r_checks, "logit_rel_err_max": worst_r,
          "logit_rel_tol": LOGIT_REL_TOL,
          "greedy_agreement": agree / len(rtoks),
          "admit_s": rrun["admit_s"], "ref_admit_s": rref["admit_s"],
          "fused_ms": rrun["fused_ms"], "ref_fused_ms": rref["fused_ms"],
          "ms_per_tick": mean(rrun["tick_ms"]),
          "ms_per_tick_median": median(rrun["tick_ms"]),
          "ref_ms_per_tick": mean(rref["tick_ms"]),
          "tok_s": n_act * len(rrun["tick_ms"])
          / (sum(rrun["tick_ms"]) / 1e3),
          "ref_tok_s": n_act * len(rref["tick_ms"])
          / (sum(rref["tick_ms"]) / 1e3),
          "fetches_per_fused_tick": sorted({f for f, _ in
                                            rrun["fetch"]["fused"]}),
          "fetches_per_tick": sorted({f for f, _ in rrun["fetch"]["tick"]}),
          "fetches": rrun["fetches"], "profile": rrun["profile"],
          "ref_profile": rref["profile"],
          "peak_mem_gib": rrun["peak_mem_gib"],
          "ref_peak_mem_gib": rref["peak_mem_gib"],
          "seconds": time.perf_counter() - t_r, "card": card})
    if not (worst_r <= LOGIT_REL_TOL):
        raise AssertionError(f"slice_rows logits vs reference twin: "
                             f"{worst_r}")
    del gparams, rrun, rref
    torch.cuda.empty_cache()

    # -- slice_train: Gemma-2-2B training at full width and depth ---------
    t_t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    tparams = tt.init_params(gen, gcfg)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, gcfg.vocab_size, (1, TRAIN_SEQ + 1)), device=dev)
    torch.cuda.synchronize()
    t_init_s = time.perf_counter() - t0
    L = gcfg.n_layers
    with tempfile.TemporaryDirectory() as tmp:
        # A one-rank NCCL group and a dp1 x sp1 mesh: the SPMD step's
        # ring is one hop, as the JAX step on one chip is.
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh({"dp": 1, "sp": 1})
            inputs, targets = training.shard_batch(tokens, mesh)
            pctx = tt.ParallelCtx(sp=mesh.get_group("sp"))
            # Gradient twins first, before any optimizer state exists: the
            # ring path and the single-device path (kernels) against
            # autograd through mha_reference on the same params and batch
            # (on one rank the ring computes the same function).
            t0 = time.perf_counter()
            ref_loss, ref_g = no_launch(training.loss_and_grads, tparams,
                                        inputs, targets, gcfg,
                                        attn_impl="reference")
            torch.cuda.synchronize()
            twin = {"reference": {"loss": ref_loss.item(),
                                  "s": time.perf_counter() - t0}}
            for path, kw in (("ring", {"pctx": pctx}), ("single", {})):
                zero_counts()
                t0 = time.perf_counter()
                loss, g = training.loss_and_grads(tparams, inputs, targets,
                                                  gcfg, **kw)
                torch.cuda.synchronize()
                rel = grad_rel_l2(training, g, ref_g)
                twin[path] = {"loss": loss.item(),
                              "s": time.perf_counter() - t0,
                              "launches": read_counts(),
                              "grad_rel_l2_max": max(rel.values()),
                              "grad_rel_l2": rel}
                del g
            del ref_g
            gc.collect()
            torch.cuda.empty_cache()
            worst_g = max(twin[p_]["grad_rel_l2_max"]
                          for p_ in ("ring", "single"))
            emit({"phase": "slice_train_twin", "twin": twin,
                  "grad_rel_l2_max": worst_g,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
            # One SGD step without pctx: the prefill kernel and its
            # gradient (from the same params as the single twin).
            sgd_step = StepClock(training.sgd_train_step)
            (tparams, sgd_loss), sgd_launches = run_path(
                ("flash_attention", "flash_attention_bwd"), sgd_step,
                tparams, tokens, gcfg, lr=TRAIN_LR)
            # The training run: AdamW over the mesh through trainer.fit.
            torch.cuda.reset_peak_memory_stats()
            step = StepClock(training.make_adamw_spmd_train_step(
                gcfg, mesh, lr=TRAIN_LR))
            (tparams, state, losses), fit_launches = run_path(
                ("flash_attention_partial", "flash_attention_bwd"),
                trainer.fit, step, tparams, training.adamw_init(tparams),
                [tokens] * 4, steps=4, log_every=0)
            train_peak = torch.cuda.max_memory_allocated() / 2**30
            with DeviceProfile(1) as tprof:
                tparams, state, _ = step(tparams, state, tokens)
        finally:
            dist.destroy_process_group()
    losses = [float(x) for x in losses]
    emit({"phase": "slice_train", "model": "gemma2_2b",
          "params": gcfg.num_params(), "init_s": t_init_s,
          "seq": TRAIN_SEQ, "batch": 1, "remat": gcfg.remat,
          "mesh": {"dp": 1, "sp": 1}, "lr": TRAIN_LR, "twin": twin,
          "grad_rel_l2_max": worst_g, "grad_rel_l2_tol": GRAD_REL_L2_TOL,
          "sgd_loss": float(sgd_loss), "sgd_ms": sgd_step.ms,
          "sgd_launches": sgd_launches, "adamw_losses": losses,
          "step_ms": step.ms[:4], "profiled_step_ms": step.ms[4],
          "step_ms_steady": mean(step.ms[1:4]),
          "tok_s": TRAIN_SEQ / (mean(step.ms[1:4]) / 1e3),
          "fit_launches": fit_launches, "peak_mem_gib": train_peak,
          "profile": tprof.stats,
          "seconds": time.perf_counter() - t_t, "card": card})
    if not all(math.isfinite(x) for x in losses + [float(sgd_loss)]):
        failures.append(f"slice_train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"slice_train: the loss did not fall: {losses}")
    if not (worst_g <= GRAD_REL_L2_TOL):
        failures.append(f"slice_train gradients vs the reference twin: "
                        f"{worst_g}")
    if abs(float(sgd_loss) - twin["single"]["loss"]) > 1e-4 * abs(
            twin["single"]["loss"]):
        failures.append(f"slice_train: sgd_train_step's loss "
                        f"{float(sgd_loss)} is not the twin's "
                        f"{twin['single']['loss']}")
    # Every layer's attention ran through the kernels: the ring's partial
    # pass per layer, again in the remat recompute, and one gradient.
    want_fit = {"flash_attention_partial": 4 * 2 * L,
                "flash_attention_bwd": 4 * L, "flash_attention": 0}
    want_sgd = {"flash_attention": 2 * L, "flash_attention_bwd": L,
                "flash_attention_partial": 0}
    for what, got_c, want_c in (("fit", fit_launches, want_fit),
                                ("sgd", sgd_launches, want_sgd)):
        if any(got_c[k] != n for k, n in want_c.items()):
            failures.append(f"slice_train {what} launches {got_c}, "
                            f"expected {want_c}")
    del tparams, state
    gc.collect()
    torch.cuda.empty_cache()

    # -- slice_finetune: the LoRA lifecycle at Gemma-2B's full width ----
    t_ft = time.perf_counter()
    ft_launches = slice_finetune(torch, np, cfg, dev, card, run_path,
                                 no_launch, failures)
    finetune_s = time.perf_counter() - t_ft

    # -- slice_moe_train: Mixtral width, 1 layer, the routings' grads --
    t_mt = time.perf_counter()
    mt_launches, mt_params, mt_cfg = slice_moe_train(
        torch, np, moe, mcfg, dev, card, run_path, no_launch, failures)
    moe_train_s = time.perf_counter() - t_mt

    # -- slice_generate: generate, speculative_generate, moe.generate ----
    t_gn = time.perf_counter()
    gn_launches = slice_generate(torch, np, paged, cfg, dev, card, run_path,
                                 no_launch, moe, mt_params, mt_cfg, failures)
    generate_s = time.perf_counter() - t_gn
    del mt_params
    gc.collect()
    torch.cuda.empty_cache()

    # -- slice_fsdp / slice_pipeline: Gemma-2B, sharded and pipelined ----
    t_fs = time.perf_counter()
    fs_launches = slice_fsdp(torch, np, cfg, dev, card, run_path, failures)
    fsdp_s = time.perf_counter() - t_fs
    t_pp = time.perf_counter()
    pp_launches = slice_pipeline(torch, np, cfg, dev, card, run_path,
                                 failures)
    pipeline_s = time.perf_counter() - t_pp

    # -- slice_mesh: Llama-3-8B over tp=2, Mixtral's experts over ep=2 --
    gc.collect()
    torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    smokes = SliceSmokes(failures, card)
    try:
        mesh_launches = slice_mesh(card, failures,
                                   before_kill=smokes.start)
    except BaseException:
        smokes.kill()
        raise
    mesh_s = time.perf_counter() - t_mesh

    # -- slice_smokes: the chaos, SLO and crash-recovery storms --------
    gc.collect()
    torch.cuda.empty_cache()
    t_sm = time.perf_counter()
    smoke_launches = smokes.finish()
    smokes_s = time.perf_counter() - t_sm

    t_f = time.perf_counter()
    run_flex_later()
    flex_s = time.perf_counter() - t_f

    # The kernels line: one entry per kernel and page type, timed at
    # its largest main-path case; launches summed over the paths' runs.
    paths = {"slice": launches, "slice_engine_a": a_launches,
             "slice_engine_b": b_launches, "slice_engine_c": c_launches,
             **{f"slice_moe_spec_{m}": c for m, c in ms_launches.items()},
             **{f"slice_kv_economy_{m}": c for m, c in kv_launches.items()},
             **{f"slice_llama_{m}": c for m, c in l_launches.items()},
             **{f"slice_moe_{m}": c for m, c in m_launches.items()},
             "slice_rows": r_launches, "slice_train_sgd": sgd_launches,
             "slice_train_fit": fit_launches, "slice_plugin": p_launches,
             **ft_launches, **mt_launches, **gn_launches, **fs_launches,
             **pp_launches, **mesh_launches, **smoke_launches}

    def total(name):
        return sum(c.get(name, 0) for c in paths.values())

    def entry(name, source, replaces, path_cases, all_cases):
        """Times from the variant's largest main-path case; the check
        columns over every case of the variant, the extra geometries'
        too."""
        main = max(path_cases, key=lambda r: r["bound_ms"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "pages": main.get("pages"),
                "launches": total(name),
                "launches_by_path": {p_: c.get(name, 0)
                                     for p_, c in paths.items()},
                "max_abs_err": max(r["max_abs_err"] for r in all_cases),
                "ulp_ratio": max(r["ulp_ratio"] for r in all_cases),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                "library_calls": main.get("library_calls", "SDPA"),
                "case": main["case"]}

    def largest(cases):
        return max(cases, key=lambda r: r["bound_ms"])

    src = "tpushare_torch/csrc/"
    ref_fa = "tpushare/ops/flash_attention.py:"
    kernels = [
        dict(entry("flash_attention", src + "flash_prefill.cu",
                   ref_fa + "105", pre_g + pre_l + pre_m + pre_n,
                   pre + pre_n + pre_mesh),
             also_replaces=ref_fa + "180"),
        entry("paged_flash_decode", src + "paged_decode.cu", ref_fa + "659",
              dec[:2] + dec_m, dec + dec_mesh),
        entry("paged_flash_decode_int8", src + "paged_decode.cu",
              ref_fa + "659", dec8, dec8),
        entry("paged_flash_verify", src + "paged_verify.cu", ref_fa + "843",
              ver[:1 + len(fused_cases)] + ver_m, ver + ver_mesh),
        entry("paged_flash_verify_int8", src + "paged_verify.cu",
              ref_fa + "843", ver8, ver8),
        dict(entry("q8_expert_ffn", src + "q8_expert.cu",
                   "tpushare/ops/q8_expert.py:170", q8_path, q8_all),
             pass_ms=largest(q8_path)["pass_ms"]),
        dict(entry("flash_decode", src + "flash_decode.cu", ref_fa + "483",
                   fdec, fdec),
             library_ms_no_softcap=largest(fdec)["library_ms_no_softcap"],
             library_no_softcap_calls=fdec[0]["library_no_softcap_calls"]),
        dict(entry("flash_attention_partial", src + "flash_prefill.cu",
                   ref_fa + "453", part_a + part_n[1:3],
                   part_a + (part_b,) + part_n),
             library_ms_no_softcap=part_b["library_ms"],
             no_softcap_case=part_b["case"]),
        dict(entry("flash_attention_bwd", src + "flash_bwd.cu",
                   ref_fa + "105", bwd_a + bwd_n, bwd_a + (bwd_b,) + bwd_n),
             note="the gradient of _fa_kernel: the JAX package has no "
                  "backward kernel (jax 0.9.0 pallas_call registers no "
                  "transpose)",
             library_ms_no_softcap=bwd_b["library_ms"],
             no_softcap_case=bwd_b["case"]),
    ]
    # These run at softcapped shapes on their main paths, which SDPA
    # lacks: their library call is flex_attention under torch.compile,
    # null (with the error text in the case's row) where it does not
    # compile; the SDPA readings without the softcap stay beside it.
    no_library = ("flash_decode", "flash_attention_partial",
                  "flash_attention_bwd")
    for k in kernels:
        need = ("ms", "plain_ms", "bound_ms", "max_abs_err") + (
            () if k["name"] in no_library else ("library_ms",))
        for key in need:
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']}: {key} = {k[key]}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on a main path")
    emit({"phase": "seconds", "kernels": kernels_s, "engine": engine_s,
          "engine_lora": engine_lora_s, "moe_spec": moe_spec_s,
          "kv_economy": kv_economy_s, "side_by_side": side_s,
          "finetune": finetune_s,
          "moe_train": moe_train_s, "generate": generate_s,
          "fsdp": fsdp_s, "pipeline": pipeline_s,
          "mesh": mesh_s, "smokes": smokes_s,
          "flex": flex_s,
          "flex_compile": {f"{r['kernel']} {r['case']}": r["flex_compile_s"]
                           for r in dec + fdec + list(part_a) + list(bwd_a)
                           if r.get("flex_compile_s") is not None},
          "total": time.perf_counter() - t_start})
    if failures:
        raise AssertionError("failed gates:\n" + "\n".join(failures))
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
