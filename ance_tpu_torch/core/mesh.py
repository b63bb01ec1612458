"""Data parallelism over ``torch.distributed``: one process a card.

Counterpart of ``ance_tpu/core/mesh.py``. The JAX package runs one process a
host and a 1-D ``Mesh`` over that host's chips; PyTorch's idiom is one
process a card, a *rank*. So ``--num_processes`` counts ranks, and rank ``r``
runs on ``cuda:(r % torch.cuda.device_count())``. A :class:`DataMesh` (rank,
world, device, backend) stands wherever the JAX package passes its ``Mesh``;
``None`` means one device.

  * batch rows: each rank feeds only its own rows of the global batch (its
    contiguous block of every encode batch, its stripe of the triples); the
    global row order is [rank 0's rows; rank 1's rows; ...], the JAX mesh's
    device order, so :func:`shard_batch` is the identity here;
  * gradients are all-reduced over the ranks before the clip and the
    optimizer (``train/trainer.py``), so the parameters stay bit-equal on
    every rank;
  * index rows (``index/flat.py``) and IVF clusters (``index/ivf.py``) are
    sharded over the ranks; each rank searches its shard and the [Q, k]
    candidates are gathered and merged.

The backend is explicit: NCCL on CUDA and gloo on the CPU by default, or as
``--dist_backend`` asks. NCCL runs one rank a card and fails on two ranks
that share one; :func:`initialize_distributed` says so first, naming gloo,
which runs them. gloo's collectives take CUDA tensors through host copies
here. Nothing falls back: a collective that fails raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# collectives wait this long for a late rank (a checkpoint write, a long
# refresh item) before the run fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

_AS_BYTES = (torch.bfloat16, torch.float16, torch.int16, torch.int8,
             torch.bool)
_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of one data-parallel job, as this rank sees them."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        """Devices on the data axis (``jax.sharding.Mesh.size``)."""
        return self.world

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the ranks (``sum``, ``mean``, ``max``
        or ``min``); every rank ends with the same values."""
        buf = t.cpu() if self._staged(t) else t
        dist.all_reduce(buf, op=_OPS[op])
        if buf is not t:
            t.copy_(buf)
        if op == "mean":
            t.div_(self.world)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: every rank's ``t``, in rank order."""
        src = t.contiguous().reshape(-1)
        if t.dtype in _AS_BYTES:  # types gloo does not take: their bytes
            src = src.view(torch.uint8)
        if self._staged(src):
            src = src.cpu()
        out = src.new_empty((self.world, src.numel()))
        dist.all_gather(list(out.unbind(0)), src)
        return out.to(t.device).view(t.dtype).reshape(
            (self.world,) + tuple(t.shape))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, concatenated in rank order."""
        return self.all_gather(t).reshape((-1,) + tuple(t.shape[1:]))

    def barrier(self) -> None:
        """Returns on every rank once all have reached it (a reduction the
        host waits for)."""
        float(self.all_reduce_(torch.zeros(1, device=self.device)))

    def block(self, n: int) -> slice:
        """This rank's contiguous rows of an ``n``-row global batch."""
        if n % self.world:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_grads_(self, tensors: Iterable[torch.Tensor],
                          op: str = "mean") -> None:
        """All-reduce gradient tensors in place, one flat buffer a dtype
        (one collective each, not one a tensor)."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            self.all_reduce_(flat, op)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def rank_generator(self, generator: torch.Generator) -> torch.Generator:
        """The host generator this rank draws a step's dropout from: one
        draw of the shared step generator (every rank draws it, so theirs
        stay in step; the draw follows from the seed and the step count)
        mixed with the rank."""
        draw = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        state = np.random.SeedSequence((draw, self.rank)).generate_state(
            1, np.uint64)
        return torch.Generator().manual_seed(int(state[0]))

    def check_replicated(self, tensors: Mapping[str, torch.Tensor],
                         what: str = "parameters") -> None:
        """Raise unless every rank holds the same bits in ``tensors``: each
        tensor's bit patterns summed as integers, gathered and compared (a
        drift of one ulp anywhere changes its sum)."""
        names = list(tensors)
        sums = torch.stack([_bit_sum(tensors[n]) for n in names])
        every = self.all_gather(sums.to(self.device)).cpu()
        for r in range(self.world):
            bad = (every[r] != every[0]).nonzero().flatten()
            if len(bad):
                raise RuntimeError(
                    f"{what} differ between rank 0 and rank {r} (first: "
                    f"{names[int(bad[0])]}); the ranks no longer train one "
                    "model")


def _bit_sum(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.view(ints).to(torch.int64).sum()


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def shard_batch(batch: dict, mesh: Optional[DataMesh] = None) -> dict:
    """The identity: under one process a card each rank already holds only
    its own rows of the global batch (the JAX package assembles its global
    array here). Kept so the counterpart is easy to find."""
    return batch


def rank_device(device, rank: int) -> torch.device:
    """The card rank ``rank`` runs on: ``cuda:(rank % device_count)``, or
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def card_id(device: torch.device) -> str:
    """Host and card identity of ``device`` (its UUID where torch has it)."""
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def check_distinct_cards(cards: list[str]) -> None:
    """NCCL runs one rank a card: refuse ranks that share one before NCCL
    fails on them ("Duplicate GPU detected")."""
    seen: dict = {}
    for rank, card in enumerate(cards):
        if card in seen:
            raise SystemExit(
                f"--dist_backend nccl: ranks {seen[card]} and {rank} share "
                f"the card {card}, and NCCL runs one rank a card; run ranks "
                "that share a card with --dist_backend gloo")
        seen[card] = rank


def start_group(init_method: str, world: int, rank: int, *, device,
                backend: Optional[str] = None,
                timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> DataMesh:
    """Join the process group of ``world`` ranks at ``init_method``
    (``tcp://host:port`` or ``file://path``) as ``rank``; returns its mesh.
    A group of one rank is a mesh too: its collectives run, over one rank."""
    if not 0 <= rank < world:
        raise SystemExit(f"--process_id {rank} outside [0, {world})")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise SystemExit(f"--dist_backend {backend}: expected one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise SystemExit("--dist_backend nccl needs --device cuda; the CPU "
                         "runs --dist_backend gloo")
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    if backend == "nccl" and world > 1:
        # NCCL makes its communicator at the first collective: compare the
        # ranks' cards over gloo before any
        side = dist.new_group(backend="gloo", timeout=timeout)
        cards = [None] * world
        dist.all_gather_object(cards, card_id(device), group=side)
        dist.destroy_process_group(side)
        check_distinct_cards(cards)
    return DataMesh(rank=rank, world=world, device=device, backend=backend)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cpu", backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> tuple[int, int]:
    """Multi-process bring-up (the reference's torch.distributed.launch +
    init_process_group, run_ann.py:603-646). With ``num_processes`` None or
    1 nothing starts: one device. Otherwise this process joins the group at
    ``tcp://coordinator_address`` as rank ``process_id``. Returns (rank,
    world)."""
    if not num_processes or num_processes == 1:
        return 0, 1
    if coordinator_address is None or process_id is None:
        raise SystemExit("--num_processes > 1 needs --coordinator_address "
                         "host:port (rank 0's) and --process_id")
    start_group("tcp://" + coordinator_address, num_processes, process_id,
                device=device, backend=backend, timeout=timeout)
    return process_id, num_processes


def make_mesh(device) -> Optional[DataMesh]:
    """The mesh of the process group this process joined, on its rank's
    card; None when it joined none (one device)."""
    if not dist.is_initialized():
        return None
    rank = dist.get_rank()
    return DataMesh(rank=rank, world=dist.get_world_size(),
                    device=rank_device(device, rank),
                    backend=dist.get_backend())

