"""setup_s: process start to the first timed request (host clock):
imports, the kernel build where one is due, the weights, the engine and
its pool, the mix's set-up traffic and the warm-up."""


def read(run):
    return run.setup_s
