"""Device selection and host <-> device transfers.

- `resolve_device` turns an entry point's `device=` into a `torch.device`
  and raises when CUDA is asked for and absent: nothing silently runs on
  the CPU.
- `to_host` and `tree_to_host` are the ports of
  `lrf_tpu/utils/transfer.py:57-83`.
- `HostCopy` is the counterpart of jax's `copy_to_host_async`: device ->
  pinned-host copies started at once, read after a CUDA event.
- `state_from_numpy` carries the JAX package's factor state (numpy arrays
  in its `(B, M, R)` / `(B, N, R)` layout) into float32 tensors, so both
  packages can start from one init.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_CUDA_READY = False


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for an entry point; raises if CUDA is asked and absent."""
    global _CUDA_READY
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asked for, but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if not _CUDA_READY:
            # The init's Gram and X V products and the decode's U V^T must
            # run in full float32, never TF32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            _CUDA_READY = True
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def to_host(x) -> np.ndarray:
    """Numpy copy (or view) of a tensor on any device."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def tree_to_host(tree):
    """`to_host` over nested lists, tuples and dicts of tensors or arrays."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    return to_host(tree)


class HostCopy:
    """Asynchronous device -> host copies of some tensors.

    On CUDA tensors each copy goes into a freshly allocated pinned host
    buffer on the current stream, and one CUDA event marks their end; CPU
    tensors are taken as they are. `wait()` blocks on the event and returns
    numpy views of the host buffers. The buffers belong to this copy alone
    (one set per batch), so a thread that still reads them can never see a
    later copy land in them. Create and wait on the thread that owns the
    device work; the arrays `wait()` returns may go to any thread.
    """

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._event = None
        self._host = []
        device = None
        for t in tensors:
            t = t.detach()
            if t.device.type == "cuda":
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t, non_blocking=True)
                self._host.append(pinned)
                device = t.device
            else:
                self._host.append(t.contiguous())
        if device is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        """Whether the copies have ended (CPU tensors' always have)."""
        return self._event is None or self._event.query()

    def wait(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def state_from_numpy(u, v, w=None, *, device):
    """Factor state from numpy arrays (JAX layout) as float32 tensors on `device`.

    Returns `(u, v)`, or `(u, v, w)` when `w` is given.
    """
    device = resolve_device(device)
    out = [torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device) for a in (u, v)]
    if w is not None:
        out.append(torch.from_numpy(np.array(w, dtype=np.float32, copy=True)).to(device))
    return tuple(out)
