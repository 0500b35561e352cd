"""RL403 true positives: in-place writes of files another process
re-reads. Expected: four findings (plain "w", "wb", keyword mode=,
exclusive-create "x")."""

import json
import os


def save_checkpoint_meta(path, meta):
    with open(path, "w") as f:          # RL403: truncate-in-place
        json.dump(meta, f)


def save_baseline(path, payload):
    f = open(path, "wb")                # RL403: binary, same tear
    f.write(payload)
    f.close()


def save_state(path, text):
    with open(path, mode="w+") as f:    # RL403: keyword-mode spelling
        f.write(text)


def save_once(path, text):
    with open(path, "x") as f:          # RL403: exclusive-create still
        f.write(text)                   # strands a torn final name
