"""The port's distributed layer: a data-parallel process group over
`torch.distributed`, the counterpart of `conductor_tpu/parallel/mesh.py`.

JAX runs one program over a ('data', 'seq') mesh and lets XLA insert the
collectives; the port runs one process a rank, launched by ``torchrun``,
each holding its rows of every global batch.  `init_from_env` reads
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and joins the group;
`Mesh` is the group a run spans (one process when there is no torchrun
environment), with the rank's rows of a global batch (`Mesh.rows`,
`Mesh.local`), `Mesh.gather_rows` (the counterpart of JAX assembling a
global array from the processes' rows), the sums and maxima the
data-parallel step and sharded evaluation need, and `Mesh.is_main`.
`pad_to_multiple` is JAX's (`mesh.py:91-103`).

The backend is explicit: "nccl" by default on the card, one card a rank
(rank r on ``cuda:LOCAL_RANK``); "gloo" on the CPU or when asked, and the
only way for two ranks to share one card, since NCCL refuses two ranks on
one device (gloo ranks on one card take ``cuda:LOCAL_RANK % cards``).
Every collective here takes a tensor on any device: gloo moves it through
the host, NCCL through this rank's card.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclass(frozen=True)
class Mesh:
    """The ranks of one data-parallel run: ``size`` processes, this one
    ``rank`` (``local_rank`` on its host), over ``backend`` ("nccl" or
    "gloo"; None for one process).  Every rank holds ``1 / size`` of each
    global batch, the contiguous rows `rows` names, as JAX's data axis
    shards a batch."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    backend: str | None = None

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def is_main(self) -> bool:
        """Rank 0, the one that writes (JAX's ``process_index() == 0``)."""
        return self.rank == 0

    def local_batch(self, global_batch: int) -> int:
        """This rank's rows of a global batch; raises where ``size`` does not
        divide it (JAX's multi-host assert, `data/dataset.py:226-232`)."""
        if global_batch % self.size:
            raise ValueError(f"global batch {global_batch} must divide the world size {self.size}")
        return global_batch // self.size

    def rows(self, global_batch: int) -> slice:
        """The contiguous rows of a global batch that this rank holds."""
        b = self.local_batch(global_batch)
        return slice(self.rank * b, (self.rank + 1) * b)

    def local(self, x):
        """This rank's rows of a global-batch array or tensor (``x`` itself
        on one process)."""
        return x if not self.distributed else x[self.rows(x.shape[0])]

    # ------------------------------------------------------------ collectives

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend takes it: gloo on the host, NCCL on this
        rank's card."""
        if self.backend == "gloo":
            return x.cpu()
        return x if x.is_cuda else x.to(torch.device("cuda", torch.cuda.current_device()))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or "max") of ``x`` over the ranks, a new tensor on
        ``x``'s device; ``x`` itself on one process."""
        if not self.distributed:
            return x
        y = self._wire(x.detach()).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return y.to(x.device)

    def all_reduce_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place, in one collective over
        a flat buffer (the data-parallel step's gradients)."""
        if not self.distributed or not tensors:
            return
        flat = self._wire(torch.cat([t.reshape(-1) for t in tensors]))
        dist.all_reduce(flat)
        flat = flat.to(tensors[0].device)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on each) concatenated along
        the first axis in rank order: the global batch from the ranks' rows."""
        if not self.distributed:
            return x
        src = self._wire(x.detach()).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src)
        return torch.cat(out).to(x.device)

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Copy rank ``src``'s tensors into every rank's, in place."""
        if not self.distributed:
            return
        for t in tensors:
            h = self._wire(t.detach()).clone()
            dist.broadcast(h, src)
            with torch.no_grad():
                t.copy_(h.to(t.device))

    def any(self, flag: bool) -> bool:
        """True where any rank's ``flag`` is (one all-reduce of a flag)."""
        if not self.distributed:
            return bool(flag)
        return bool(self.all_reduce(torch.tensor([int(flag)]), "max").item())

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def init_from_env(backend: str | None = None, device: torch.device | str = "cuda",
                  ) -> tuple[Mesh, torch.device]:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and return it with
    this rank's device: ``cuda:LOCAL_RANK`` under NCCL (one card a rank;
    raises where the host has fewer cards than ranks), ``cuda:LOCAL_RANK %
    cards`` under gloo, the CPU for ``device="cpu"``.  ``backend`` is
    "nccl" on the card and "gloo" on the CPU unless given.  Without a
    torchrun environment, or with ``WORLD_SIZE=1`` and no group, it returns
    one process on ``device``; a world above 1 that fails to join raises
    and never carries on alone."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and "RANK" not in os.environ:
        return Mesh(), device
    rank, local_rank = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", "0"))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a CUDA device was asked for but torch.cuda.device_count() is 0")
        if backend == "nccl" and local_rank >= n:
            raise RuntimeError(
                f"local rank {local_rank} on a host with {n} CUDA device(s): NCCL takes one card a "
                "rank; ranks that share a card need --dist_backend gloo")
        device = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs CUDA devices; the CPU takes gloo")
    if not dist.is_initialized():
        try:
            kw = {"device_id": device} if backend == "nccl" else {}
            dist.init_process_group(backend, rank=rank, world_size=world, **kw)
        except Exception as e:  # never train alone where a world was asked for
            raise RuntimeError(f"rank {rank} of {world} could not join the {backend} process "
                               f"group: {e}") from e
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(f"process group is rank {dist.get_rank()} of {dist.get_world_size()}, "
                           f"the environment says {rank} of {world}")
    return Mesh(rank=rank, size=world, local_rank=local_rank, backend=backend), device


def free_port() -> int:
    """A free TCP port on localhost, for a group's ``MASTER_PORT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shutdown(mesh: Mesh) -> None:
    """Leave the process group `init_from_env` joined."""
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


def pad_to_multiple(x: Any, multiple: int) -> tuple[Any, int]:
    """Round the leading dim up to a multiple by repeating head samples, the
    reference sampler's ``round_up`` duplication
    (`datasets/dataloader.py:30-49`); JAX's `pad_to_multiple`.  Returns
    (padded, original_len); numpy arrays and tensors alike."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    cat = torch.cat if torch.is_tensor(x) else np.concatenate
    reps = cat([x] * (-(-rem // n)), 0)[:rem]  # rem may exceed n
    return cat([x, reps], 0), n
