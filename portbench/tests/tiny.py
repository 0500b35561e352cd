"""Tiny cells for the CPU tests: the published configurations' shapes of
layer (GQA, rotary, SwiGLU, top-2 of the router's softmax) at widths a
CPU runs in seconds, and small mixes of the same kinds."""

import copy

from portbench import harness

DENSE = {
    "family": "dense", "model_type": "mistral", "hidden_size": 64,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 128, "vocab_size": 256,
    "rms_norm_eps": 1e-5, "rope_theta": 1e6, "hidden_act": "silu",
    "tie_word_embeddings": False, "sliding_window": None,
    "pool_blocks": 160,
}
MOE = dict(DENSE, family="moe_int8", model_type="mixtral",
           num_local_experts=4, num_experts_per_tok=2)
RAG = {"clients": 3, "n_slots": 3, "prefill_chunk": None,
       "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.6,
                  "min": 16, "max": 96},
       "output": {"dist": "uniform", "min": 4, "max": 8},
       "document": None}
LONGDOC = {"clients": 3, "n_slots": 3, "prefill_chunk": None,
           "document": {"dist": "uniform", "min": 64, "max": 160},
           "prompt": {"dist": "uniform", "min": 8, "max": 16},
           "output": {"dist": "uniform", "min": 4, "max": 8}}

END_TO_END = [{"name": n, "unit": u} for n, u in (
    ("output_tok_s", "tokens/s"), ("ttft_p90_ms", "ms"),
    ("itl_p95_ms", "ms"), ("setup_s", "s"))]
PER_LAYER = [{"name": n, "unit": u} for n, u in (
    ("engine.tokens_per_tick", "tokens"), ("paged.prefix_hit_pct", "%"),
    ("model.step_mfu_pct", "%"), ("q8_expert_roofline", "%"),
    ("prefill_attn_roofline", "%"),
    ("paged_decode_roofline", "%"), ("device.idle_pct", "%"))]


def cell(conf: dict, mix: dict, limit: float = 0.05) -> harness.Cell:
    family = harness.load_file(
        f"{harness.PB}/families/{conf['family']}.py",
        "portbench_family_" + conf["family"])
    limits = {"compare": {"max_logit_gap": limit}, "sample_tokens": 256,
              "sample_requests": 8}
    return harness.Cell({"name": "tiny", "chips": 1}, copy.deepcopy(conf),
                        copy.deepcopy(mix), limits, family, END_TO_END,
                        PER_LAYER)
