"""Device resolution and an environment probe for the port.

`resolve_device` is the one place the "CUDA by default, CPU only on
request" rule lives: every entry point of the sweep path funnels its
``device`` argument through it, so a host without a card fails loudly
instead of quietly simulating on the CPU.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises `RuntimeError` when a CUDA
    device is asked for (the default) and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def nvcc_path() -> Optional[str]:
    """Path of the CUDA compiler, or None when the host has none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    return None


def _run(cmd) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def nvidia_smi_name_and_limit() -> Optional[str]:
    """First line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. ``"NVIDIA H100 80GB HBM3, 700.00 W"``),
    or None when the tool is missing or fails."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return out.splitlines()[0].strip() if out else None


def probe() -> Dict[str, object]:
    """What this host offers the port: CUDA present, device name and
    compute capability, power limit as `nvidia-smi` reports it, and the
    torch / CUDA / nvcc versions."""
    cuda = torch.cuda.is_available()
    info: Dict[str, object] = {
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "capability": (list(torch.cuda.get_device_capability(0))
                       if cuda else None),
        "nvidia_smi": nvidia_smi_name_and_limit(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": None,
        "nvcc_version": None,
    }
    nvcc = nvcc_path()
    if nvcc is not None:
        info["nvcc"] = nvcc
        ver = _run([nvcc, "--version"])
        if ver:
            rel = [ln for ln in ver.splitlines() if "release" in ln]
            info["nvcc_version"] = (rel[0] if rel else ver).strip()
    return info
