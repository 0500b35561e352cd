"""paged.prefix_hit_pct: prompt tokens the prefix cache served from the
pool, over prompt tokens admitted, over the traced run's untraced part
(ServeEngine.stats() prefix_hit_tokens over prefix_prompt_tokens)."""


def read(run):
    total = run.untraced_delta("prefix_prompt_tokens")
    return (100.0 * run.untraced_delta("prefix_hit_tokens") / total
            if total else None)
