"""engine.tokens_per_tick: tokens the engine emitted per work tick over
the traced run's untraced part (the deltas of ServeEngine.stats()
tokens_out and work_ticks)."""


def read(run):
    ticks = run.untraced_delta("work_ticks")
    return run.untraced_delta("tokens_out") / ticks if ticks else None
