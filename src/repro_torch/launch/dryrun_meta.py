"""Dry-run artifact format: hardware constants, format version, digest —
the counterpart of `repro.launch.dryrun_meta`, with the NVIDIA H100's
roofs in place of the TPU's.

Split out of `dryrun` so a reader can validate a persisted
``dryrun_results.json`` without importing the dry-run module.

The artifact is versioned by a digest over the format version plus
every constant that shapes the persisted numbers, and over the torch
version (major.minor) that traced the cells: DTensor's sharding
propagation differs between versions, so one program traces other
collectives and temporaries under another torch. Any change to the
roofline model — other hardware, other wire factors, a new per-cell
schema, another torch — changes the digest, and readers treat the
stale file as absent (recompute) instead of reporting roofline
fractions computed against the wrong machine or the wrong trace. A dry-run artifact of the reference (TPU roofs) reads
as stale here, and the port's as stale there.
"""
from __future__ import annotations

import hashlib
import json
from types import MappingProxyType
from typing import List, Optional, Tuple

import torch

# --- hardware constants (one NVIDIA H100 SXM5) ---------------------------------
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores (NVIDIA data sheet)
HBM_BW = 3.35e12             # bytes/s of HBM3 (NVIDIA data sheet)
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (chip_smoke.py's sharding_path prints it)
HBM_BYTES = 85_017_493_504
# bytes/s per device between nodes: one 400 Gb/s NDR InfiniBand NIC per GPU
# (the NVIDIA DGX H100 layout: eight ConnectX-7 ports for eight GPUs). The
# 16-wide model axis spans two 8-GPU NVLink nodes, so its ring crosses it.
LINK_BW = 50e9

# wire-byte multipliers per collective kind (ring algorithms, k->inf)
WIRE_FACTOR = MappingProxyType({
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0})

# v1: bare list of cells (legacy, no meta header)
# v2: {"meta": {...}, "cells": [...]} with digest validation
FORMAT_VERSION = 2


def torch_minor() -> str:
    """``torch.__version__`` cut to major.minor ("2.11" of "2.11.0+cu128")."""
    return ".".join(torch.__version__.split("+")[0].split(".")[:2])


def dryrun_digest() -> str:
    """Digest of everything besides the (arch x shape x mesh) grid that
    determines a persisted cell's numbers: format version, hardware
    roofs, collective wire factors, and the torch version (major.minor)
    whose DTensor traced the cells."""
    blob = json.dumps({"format": FORMAT_VERSION, "peak_flops": PEAK_FLOPS,
                       "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                       "hbm_bytes": HBM_BYTES, "wire": dict(WIRE_FACTOR),
                       "torch": torch_minor()},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def wrap_results(cells: List[dict]) -> dict:
    """The on-disk document `dryrun --out` writes."""
    return {"meta": {"format_version": FORMAT_VERSION,
                     "digest": dryrun_digest(), "torch": torch_minor()},
            "cells": cells}


def unwrap_results(payload) -> Tuple[Optional[List[dict]], str]:
    """Validate a loaded ``dryrun_results.json`` document.

    Returns ``(cells, "")`` when the artifact is current, else
    ``(None, reason)`` — a legacy bare list (pre-versioning), a format
    bump, or a digest mismatch all read as stale, never as an error."""
    if isinstance(payload, list):
        return None, "legacy unversioned artifact (bare list)"
    if not isinstance(payload, dict):
        return None, f"unrecognized artifact type {type(payload).__name__}"
    meta = payload.get("meta", {})
    if meta.get("format_version") != FORMAT_VERSION:
        return None, (f"format_version {meta.get('format_version')!r} != "
                      f"{FORMAT_VERSION}")
    if meta.get("digest") != dryrun_digest():
        return None, (f"digest {meta.get('digest')!r} != {dryrun_digest()} "
                      "(roofline constants or torch version changed)")
    cells = payload.get("cells")
    if not isinstance(cells, list):
        return None, "missing cells list"
    return cells, ""
