"""Kernel dispatch: which device a call runs on, and the launch counters.

Counterpart of ``rten_tpu/kernels/dispatch.py`` (``on_tpu``). The rule is
decided per call from the tensors, never from the machine:

- every tensor on a CUDA device → the wrapper launches its hand-written
  kernel (or raises if the kernel cannot build or launch);
- every tensor on the CPU → the wrapper runs its plain PyTorch version;
- anything else (mixed devices, another backend) → ``ValueError``.

There is no fallback from a CUDA tensor to the plain version.

Every wrapper adds one to ``LAUNCHES[name]`` each time it launches its
kernel; every plain version adds one to ``PLAIN[name]`` each time it runs.
A run shows which path it took by reading both after setting them to zero
(``reset_counters``).
"""

from __future__ import annotations

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()
PLAIN: collections.Counter = collections.Counter()


def reset_counters() -> None:
    LAUNCHES.clear()
    PLAIN.clear()


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for, checked. ``"cuda"`` on a
    machine without CUDA raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected 'cuda' or 'cpu')")


def use_kernel(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device (launch the
    kernel), False when every one lies on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors if t is not None}
        if len(devs) != 1:
            raise ValueError(f"tensors on several CUDA devices: {sorted(map(str, devs))}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"kernel inputs must all lie on one CUDA device or all on the CPU; got {sorted(kinds)}"
    )
