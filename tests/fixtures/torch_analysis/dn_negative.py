"""DN601 fixture — negatives: every host read follows a synchronize, a
buffer handed off with its event is the receiver's to wait on, and
copies into device tensors (host->device) are stream-ordered."""
import torch


def fetch_tokens(nxt):
    host = nxt.to("cpu", non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return host.tolist()


def read_blocks(g):
    dst = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
    dst.copy_(g, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return dst, event                             # handed off with its event


def upload(host_rows, dev_rows):
    dev_rows.copy_(host_rows, non_blocking=True)  # host->device
    return dev_rows.sum()


def blocking(t):
    return t.to("cpu").tolist()                   # a blocking copy
