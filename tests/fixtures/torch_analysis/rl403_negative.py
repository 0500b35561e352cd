"""RL403 negatives: reads, append-only segments (CRC-framed WAL —
crash-consistent by construction), the atomicio helper itself, and a
dynamic mode the rule cannot judge. Expected: zero findings."""

from tpushare_torch.utils import atomicio


def load_checkpoint_meta(path):
    with open(path) as f:               # read: exempt
        return f.read()


def load_binary(path):
    with open(path, "rb") as f:         # read: exempt
        return f.read()


def append_segment(path, frame):
    with open(path, "ab") as f:         # append-only WAL: the torn
        f.write(frame)                  # tail is discarded on replay


def save_checkpoint_meta(path, meta):
    atomicio.write_json(path, meta)     # THE safe spelling


def open_dynamic(path, mode):
    return open(path, mode)             # unjudgeable: not flagged
