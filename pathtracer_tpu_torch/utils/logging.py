"""Structured logging (the reference's ``utils/logging.py``): rank-0-only
stderr lines and JSON rows."""

from __future__ import annotations

import json
import sys
import time

import torch.distributed as dist


def is_host_zero() -> bool:
    """True unless torch.distributed is initialised and this is not rank 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def log(msg: str, **fields) -> None:
    """Human line + optional structured fields, rank 0 only."""
    if not is_host_zero():
        return
    if fields:
        msg = f"{msg} " + " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[pathtracer {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr)


def log_json(path: str | None, **row) -> None:
    """Append one sorted-key JSON row to `path`; stdout if no path."""
    if not is_host_zero():
        return
    line = json.dumps(row, sort_keys=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    else:
        print(line)
