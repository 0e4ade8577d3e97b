"""The (data, model) device mesh over ``torch.distributed`` (counterpart
of ``adlm_tpu.core.mesh``).

One process per rank.  The JAX package lays its devices out as
``np.asarray(devices).reshape(data, model)``; here rank ``r`` sits at
``(r // model, r % model)`` of the same grid.  The batch is split over
``data``: ranks that share a ``data`` coordinate hold the same slice,
and the gradient and the batch statistics reduce over the ranks that
share a ``model`` coordinate (the "data group").

The ranks that share a ``data`` coordinate form the "model group"; under
spatial eval (``parallel/spatial.py``) they split image H between them
and trade the rows a convolution reads across their boundary
(``exchange_rows``).

Every collective is an ``all_reduce`` (SUM or MIN) or a ``broadcast``,
which NCCL, gloo on the CPU and gloo on CUDA tensors all take: a gather
is an all-reduce of a zero-filled buffer in which each rank fills its
own rows, and an argmin across ranks is two MIN reductions (the value,
then the global index among the ranks that hold it).  Gloo's
``send``/``recv`` take CPU tensors only, and NCCL refuses two ranks on
one card, so point-to-point copies serve neither case: the row
exchange is such a zero-filled all-reduce too.

A world of one built without a process group (``make_mesh()`` in a
plain process) runs no collective at all; a world of one inside an
initialized group (``torchrun --nproc-per-node 1``) runs them for real.

The backend is an argument: NCCL on the card and gloo on the CPU by
default.  NCCL refuses two ranks on one card; gloo takes CUDA tensors
too (staged through the host), which is how two ranks can share one
card.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_SELF = "self"  # the group of a rank that is alone on its line of the mesh


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data * model`` must equal the rank count."""

    data: int = -1  # -1 = all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != {n_devices} devices")
        return data, model


def mesh_coords(data: int, model: int) -> np.ndarray:
    """(data, model) grid of ranks, as the JAX package lays out devices."""
    return np.arange(data * model).reshape(data, model)


def _active() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _reduce(t: torch.Tensor, op: str, group: Any) -> None:
    import torch.distributed as dist

    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op],
                    group=group)


class _SumAllReduce(torch.autograd.Function):
    """SUM over a group; the backward sums the incoming gradients over the
    same group (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def row_range(index: int, n: int, parts: int) -> Tuple[int, int]:
    """Rows [lo, hi) of ``n`` that part ``index`` of ``parts`` holds:
    [⌊index·n/parts⌋, ⌊(index + 1)·n/parts⌋)."""
    return index * n // parts, (index + 1) * n // parts


def row_sources(owned: Sequence[Tuple[int, int]], need: Tuple[int, int]
                ) -> List[Tuple[int, int, int]]:
    """Where each row of the global range ``need`` = [lo, hi) comes from,
    as consecutive (lo, hi, source) pieces that cover it exactly once:
    source −1 for rows past the image edge (the fill), else the index of
    the part whose ``owned`` range holds them.  ``owned`` partitions the
    image's rows in order."""
    lo, hi = need
    height = owned[-1][1]
    out: List[Tuple[int, int, int]] = []
    if lo < min(hi, 0):
        out.append((lo, min(hi, 0), -1))
    for q, (a, b) in enumerate(owned):
        s, e = max(a, lo), min(b, hi)
        if s < e:
            out.append((s, e, q))
    if max(lo, height) < hi:
        out.append((max(lo, height), hi, -1))
    return out


@dataclass
class Mesh:
    """This process's place in a (data, model) mesh, its device, the
    backend of its process group (None where none runs), its data
    group: the ranks that share its ``model`` coordinate, over which the
    gradients and the batch statistics reduce (None: the whole world),
    and its model group: the ranks that share its ``data`` coordinate,
    which split image H under spatial eval (None: the whole world)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = _SELF

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def batch_slice(self, n: int) -> slice:
        """The rows of a global batch of ``n`` this rank holds."""
        if n % self.data:
            raise ValueError(f"batch {n} does not divide over {self.data} "
                             f"data ranks")
        b = n // self.data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def share(self, n_valid: int, local: int) -> int:
        """Of a global batch whose first ``n_valid`` images are real, the
        real images of this rank's ``local`` rows."""
        return int(min(max(n_valid - self.data_index * local, 0), local))

    # -- collectives over the data group ------------------------------------

    def _alone(self) -> bool:
        return not self.distributed or self.data_group == _SELF

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place, SUM or MIN."""
        if not self._alone():
            _reduce(t, op, self.data_group)
        return t

    def all_reduce_world_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over every rank of the world, in place."""
        if self.distributed and self.world > 1:
            _reduce(t, "sum", None)
        return t

    def all_reduce_grad(self, t: torch.Tensor) -> torch.Tensor:
        """A differentiable SUM: its backward sums the incoming gradients
        over the same ranks."""
        if self._alone():
            return t
        return _SumAllReduce.apply(t, self.data_group)

    def sum_flat_(self, tensors: Sequence[torch.Tensor]) -> None:
        """SUM a list of tensors of one dtype in place, as one flattened
        buffer (one collective)."""
        if self._alone() or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat)
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def lexmin(self, values: torch.Tensor, index: torch.Tensor, over: str = "data"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Element-wise lexicographic (value, index) minimum over the data
        group (``over="model"``: the model group): the least value, and
        among the ranks that hold it the least index.  ``index`` is
        int64."""
        reduce = self.all_reduce_ if over == "data" else self.all_reduce_model_
        v = reduce(values.clone(), "min")
        big = torch.iinfo(torch.int64).max
        idx = torch.where(values == v, index.long(),
                          torch.full_like(index, big, dtype=torch.int64))
        return v, reduce(idx, "min")

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch of a batch-sharded ``local`` (b, ...): a
        zero-filled (b·data, ...) buffer in which this rank fills its own
        rows, SUM-reduced."""
        if not self.distributed:
            return local
        b = local.shape[0]
        buf = local.new_zeros((b * self.data,) + tuple(local.shape[1:]))
        buf[self.data_index * b:(self.data_index + 1) * b] = local
        return self.all_reduce_(buf)

    # -- collectives and the row exchange over the model group --------------

    def all_reduce_model_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the model group, SUM or MIN (a model group of one:
        nothing).  Every rank gets the same bits: each element's reduction
        runs once and is handed to every rank (a SUM of two ranks is one
        commutative add)."""
        if self.distributed and self.model > 1:
            _reduce(t, op, self.model_group)
        return t


    def exchange_rows(self, local: torch.Tensor, dim: int,
                      owned: Sequence[Tuple[int, int]],
                      need: Sequence[Tuple[int, int]], fill: float = 0.0) -> torch.Tensor:
        """Rows ``need[me]`` (global, half-open, may reach past the image)
        of a tensor whose rows along ``dim`` the model group splits as
        ``owned`` (one (lo, hi) per model index, in order);
        ``local`` holds this rank's ``owned[me]``.  Rows past the image
        edge are ``fill`` (0 for a convolution's padding, −inf for a max
        pool's).

        Every rank knows every rank's ``owned`` and ``need`` from the
        geometry, so one collective moves all of it: a zero-filled buffer
        with a slot for each row that some rank needs from another, in
        which each rank writes the rows it holds, SUM-reduced over the
        model group as int32 words (exact bits whatever the dtype: each
        word has one writer, so the sum adds zeros to it).  Rows needed
        from several ranks (a halo wider than a neighbour's rows) come
        from each of them."""
        me = self.model_index
        olo, ohi = owned[me]
        if local.shape[dim] != ohi - olo:
            raise ValueError(f"rank holds {local.shape[dim]} rows, the plan "
                             f"gives it [{olo}, {ohi})")
        # the slot of every (requester, piece) another rank fills
        slots, n_rows = [], 0
        for q in range(self.model):
            for lo, hi, src in row_sources(owned, need[q]):
                if src not in (-1, q):
                    slots.append((q, lo, hi, src, n_rows))
                    n_rows += hi - lo
        recv = None
        if n_rows:
            shape = list(local.shape)
            shape[dim] = n_rows
            nbytes = math.prod(shape) * local.element_size()
            words = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=local.device)
            recv = words.view(torch.uint8)[:nbytes].view(local.dtype).view(shape)
            for q, lo, hi, src, off in slots:
                if src == me:
                    recv.narrow(dim, off, hi - lo).copy_(local.narrow(dim, lo - olo, hi - lo))
            self.all_reduce_model_(words)
        pieces = []
        mine = {(lo, hi): off for q, lo, hi, _, off in slots if q == me}
        for lo, hi, src in row_sources(owned, need[me]):
            if src == -1:
                shape = list(local.shape)
                shape[dim] = hi - lo
                pieces.append(local.new_full(shape, fill))
            elif src == me:
                pieces.append(local.narrow(dim, lo - olo, hi - lo))
            else:
                pieces.append(recv.narrow(dim, mine[(lo, hi)], hi - lo))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def broadcast_(self, tensors: Iterable[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` with rank ``src``'s, over the world."""
        if not self.distributed:
            return
        import torch.distributed as dist

        for t in tensors:
            if self.backend == "nccl" and t.device != self.device:
                # NCCL moves device memory only (an optimizer's step count
                # lives on the host)
                tmp = t.to(self.device)
                dist.broadcast(tmp, src=src)
                t.copy_(tmp)
            else:
                dist.broadcast(t, src=src)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """A picklable value of rank ``src`` on every rank."""
        if not self.distributed:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist

            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()


def make_mesh(spec: MeshSpec = MeshSpec(), device: Any = None,
              backend: Optional[str] = None, init_method: Optional[str] = None,
              rank: int = 0, world_size: int = 1,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This process's ``Mesh``.

    * A process group already initialized (``init_distributed``) is used
      as it is: its rank and world size.
    * Else ``init_method`` (e.g. ``file:///run/dir/.store``) starts one
      of ``world_size`` ranks with ``backend`` (default NCCL on the
      card, gloo on the CPU).
    * Else the mesh is a world of one without a process group.

    ``device`` defaults to the card (``core/device.py``).  The data
    groups are built collectively: every rank calls this in the same
    order."""
    from adlm_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if init_method is not None and not _active():
        import torch.distributed as dist

        backend = backend or default_backend(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    if not _active():
        data, model = spec.resolve(1)
        return Mesh(data, model, 0, dev)
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = spec.resolve(world)
    group = None if model == 1 else _SELF if data == 1 else None
    model_group = None if data == 1 else _SELF if model == 1 else None
    if model > 1 and data > 1:
        # new_group is collective: every rank creates every data line's
        # group (the ranks of one model coordinate), then every model
        # group (the ranks of one data coordinate), in order
        coords = mesh_coords(data, model)
        for line in coords.T:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                group = g
        for line in coords:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                model_group = g
    return Mesh(data, model, rank, dev, backend=dist.get_backend(), data_group=group,
                model_group=model_group)


def init_distributed(spec: MeshSpec, device: Any = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The ``--distributed`` path: the world from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), each rank on ``cuda:LOCAL_RANK``
    unless ``device`` is the CPU."""
    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        if key not in os.environ:
            raise SystemExit(f"--distributed needs torchrun's environment "
                             f"({key} is not set)")
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if not _active():
        from adlm_tpu_torch.core.device import resolve_device

        resolve_device(dev)
        backend = backend or default_backend(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return make_mesh(spec, dev)


def destroy(mesh: Optional[Mesh]) -> None:
    """End this process's group (a no-op without one)."""
    if mesh is not None and mesh.distributed and _active():
        import torch.distributed as dist

        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# local ranks: one process per rank on this machine
# ---------------------------------------------------------------------------

def _rank_entry(fn: Callable, rank: int, world: int, store: str,
                device: str, backend: Optional[str], timeout_s: float,
                args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cpu":
        # the ranks share this machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh_args = dict(init_method=f"file://{store}", rank=rank, world_size=world,
                     backend=backend,
                     timeout=datetime.timedelta(seconds=timeout_s))
    fn(dev, mesh_args, *args)


def spawn_local(fn: Callable, world: int, store: str, devices: Sequence[str],
                args: tuple = (), backend: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT.total_seconds(),
                join_timeout: Optional[float] = None) -> List[int]:
    """Run ``fn(device, mesh_args, *args)`` in ``world`` spawned
    processes, rank r on ``devices[r]``; ``make_mesh(spec,
    device, **mesh_args)`` joins the world through the file store
    ``store`` (a path that must not exist yet).  Returns the exit codes
    in rank order.  Once a rank fails, the others get a few seconds to
    raise from their collectives' timeout, then are terminated; every
    process is ended before this returns (``join_timeout`` bounds the
    whole run)."""
    if os.path.exists(store):
        os.remove(store)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, store, str(devices[r]), backend,
                               timeout_s, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    failed_at = None
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if deadline is not None and now > deadline:
                break
            if failed_at is not None and now - failed_at > 10.0:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.remove(store)
    codes = [p.exitcode for p in procs]
    return [124 if c is None else (c if c >= 0 else 128 - c) for c in codes]
