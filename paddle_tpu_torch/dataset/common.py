"""Dataset infrastructure, the port's copy of paddle_tpu/dataset/common.py
(reference: python/paddle/v2/dataset/common.py — download + md5 cache).

This environment has no network egress, so each dataset module falls back to
a deterministic synthetic surrogate with the real schema (same field types,
shapes, vocab sizes) when the cached real data is absent. Real data dropped
into DATA_HOME is picked up transparently."""

from __future__ import annotations

import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def cache_path(module: str, filename: str) -> str:
    d = os.path.join(DATA_HOME, module)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, filename)


def have_real_data(module: str, filename: str) -> bool:
    return os.path.exists(os.path.join(DATA_HOME, module, filename))


def download(url: str, module: str, md5sum: str = None,
             save_name: str = None):
    """API-compatible stub for the reference's downloader: with no egress it
    only resolves already-cached files."""
    filename = save_name or url.split("/")[-1]
    path = os.path.join(DATA_HOME, module, filename)
    if os.path.exists(path):
        return path
    raise RuntimeError(
        f"no network egress: place {filename} under {DATA_HOME}/{module}/ "
        "to use real data (synthetic surrogate is used by default)")
