"""Device resolution, compute dtype and f32 precision for the port.

Counterpart of ``adlm_tpu.core.dtypes`` plus the device choice JAX makes
implicitly.  The port runs on the CUDA card unless the caller asks for
the CPU: ``resolve_device(None)`` is ``cuda`` and raises on a host
without one — there is no silent CPU fallback.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

DeviceLike = Union[str, torch.device, None]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  A CUDA device on a host without one
    raises; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "adlm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def compute_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """'float32' / 'bfloat16' (the config strings) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown compute dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def cast_params(model: nn.Module, dtype: Union[str, torch.dtype]) -> nn.Module:
    """Cast the module's float32 PARAMETERS to ``dtype`` in place.

    Buffers (frozen-BN statistics, the ``ones`` constant) stay float32,
    as the JAX package keeps its ``constants`` collection in f32 while
    the bf16 eval casts ``params`` (``core/dtypes.py::tree_cast``).
    """
    dt = compute_dtype(dtype)
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dt)
    return model


def model_dtype(model: nn.Module) -> torch.dtype:
    """The dtype the model computes in: that of its first parameter."""
    return next(model.parameters()).dtype


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """Run float32 convolutions and matmuls in full IEEE f32.

    cuDNN allows TF32 for f32 convolutions by default, which keeps about
    three decimal digits; the JAX reference computes f32 at full
    precision.  The entry points wrap their work in this scope and
    restore the caller's flags afterwards.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """Run cuDNN's deterministic algorithms, chosen without autotuning
    (``cudnn.deterministic``, no ``cudnn.benchmark``), so that a run
    repeats bit for bit on the same card; the caller's flags come back
    afterwards.  The training commands run in this scope."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """numpy array or tensor → tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype, non_blocking=True)


HostCopies = Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]


def to_host_async(tensors: Sequence[torch.Tensor]) -> HostCopies:
    """Start copying ``tensors`` to the host behind the work already
    queued on their device, and return the copies with an event that
    marks their end (None on the CPU).  Work queued after this call does
    not hold them up: a loop can queue batch n + 1 before it reads batch
    n (``host_numpy``)."""
    out = [t.to("cpu", non_blocking=True) for t in tensors]
    if not tensors[0].is_cuda:
        return out, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return out, ev


def host_numpy(copies: HostCopies) -> List[np.ndarray]:
    """The arrays of ``to_host_async``, once their copies have landed."""
    host, ev = copies
    if ev is not None:
        ev.synchronize()
    return [t.numpy() for t in host]


def pipelined_batches(step: Callable, dataset: Iterable, batch_size: int,
                      pad: Callable, merge: Callable) -> None:
    """Drive ``step`` over ``dataset``'s (image (1, ...), label (1, ...))
    pairs in batches of ``batch_size``, with one batch in flight: batch
    n + 1 is queued on the device before the host merges batch n, whose
    results were copied out behind it.

    A batch ends early where the image shape changes; a partial batch is
    filled to ``batch_size`` with ``pad(image, label)`` items made from
    its first.  ``step(images, labels)`` takes the concatenated batch and
    returns (tensors to bring back, a host context); ``merge(arrays,
    context, offset, n_real)`` is called once per batch in dataset order,
    ``offset`` being the dataset index of the batch's first item and
    ``n_real`` its count of items that are not padding."""
    pending: list = []
    offset = 0
    inflight = None

    def drain():
        if inflight is not None:
            copies, *rest = inflight
            merge(host_numpy(copies), *rest)

    def flush():
        nonlocal offset, inflight
        if not pending:
            return
        n_real = len(pending)
        pending.extend(pad(*pending[0]) for _ in range(batch_size - n_real))
        tensors, context = step(np.concatenate([p[0] for p in pending]),
                                np.concatenate([p[1] for p in pending]))
        copies = to_host_async(tensors)
        drain()
        inflight = (copies, context, offset, n_real)
        offset += n_real
        pending.clear()

    for image, label in dataset:
        image, label = np.asarray(image), np.asarray(label)
        if pending and image.shape != pending[0][0].shape:
            flush()
        pending.append((image, label))
        if len(pending) == batch_size:
            flush()
    flush()
    drain()
