"""DN601 fixture — true positives. Parsed by the analyzer, never
imported: host reads of a non_blocking device->host copy before any
synchronize."""
import numpy as np
import torch


def fetch_tokens(nxt):
    host = nxt.to("cpu", non_blocking=True)
    return host.tolist()                          # DN601 .tolist()


def stage(rows):
    dst = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    dst.copy_(rows, non_blocking=True)
    first = dst[0].item()                         # DN601 .item() of an element
    return first, np.asarray(dst)                 # DN601 np.asarray


def maybe_wait(t, wait):
    h = t.cpu(non_blocking=True)
    if wait:
        torch.cuda.synchronize()
    return h.numpy()                              # DN601 on the no-wait path
