"""Process groups for tensor- and data-parallel serving (counterpart of
gabby_tpu/parallel/mesh.py).

The reference is single-controller SPMD: one process drives all of a
host's devices through a ("data", "model") Mesh, GSPMD inserts the
collectives, and across hosts jax.distributed joins the processes into one
global mesh. PyTorch's idiom is one process per rank, each on its own
device, with explicit collectives in the model (parallel/collectives.py)
and a torch.distributed store for control and liveness
(parallel/multihost.py). So every run with tp > 1 has the reference's
multi-host shape: rank 0 owns the HTTP front door and composes the
serving plan, every other rank replays it.

The processes form the reference's ("data", "model") grid: dp replicas of
a tp group, rank r = d * tp + t with the model axis innermost, as the
reference's make_mesh places it. Each rank's TPGroup carries its tp
group (the model's collectives) and its dp group (the ranks that hold the
same model shard in the other replicas: the data axis's collectives).
dp = 1 is the tensor-parallel run it was.

The data plane's backend follows one rule, printed at start-up and never
switched after a failure: nccl when every rank has a card of its own,
gloo when ranks share a card or run on the CPU (NCCL refuses two ranks on
one device; gloo moves CUDA tensors for broadcast and all_reduce, all the
model needs). The control plane (plan broadcasts, barriers) is a gloo
group of its own. Every group carries the run's timeout: a collective
that does not complete in time raises (the counterpart of the reference's
`jax_enable_recoverability`).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from gabby_tpu_torch import resolve_device


@dataclasses.dataclass
class TPGroup:
    """One rank's view of the dp x tp grid: its rank in the tensor-parallel
    group and that group's size, its device, the tp data-plane process
    group (the model's collectives), its replica's index `dp_rank` among
    `dp_size` and the dp process group (the data axis), the gloo control
    group over every rank (plan broadcasts) and the store (liveness
    counters)."""

    rank: int
    size: int
    device: torch.device
    backend: str = "none"
    group: Any = None
    ctrl: Any = None
    store: Any = None
    dp_rank: int = 0
    dp_size: int = 1
    dp_group: Any = None

    @property
    def world_rank(self) -> int:
        return self.global_rank(self.dp_rank)

    @property
    def world_size(self) -> int:
        return self.dp_size * self.size

    def global_rank(self, dp_rank: int) -> int:
        """The rank in the whole grid of replica `dp_rank`'s rank that
        holds this rank's model shard."""
        return dp_rank * self.size + self.rank

    def close(self) -> None:
        """Leave the process group (a no-op for the local group)."""
        if self.world_size > 1 and dist.is_initialized():
            dist.destroy_process_group()


def local_group(device=None) -> TPGroup:
    """The tp = 1 group: one rank, no process group; every collective of
    parallel/collectives.py is a no-op on it."""
    return TPGroup(rank=0, size=1, device=resolve_device(device))


def _card_key(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else \
        f"{socket.gethostname()}:{device.index}"


def choose_backend(device: torch.device, store, rank: int,
                   world: int) -> str:
    """The data plane's backend: nccl when every rank has a card of its own
    (the ranks' card ids, exchanged through the store, are distinct), gloo
    when ranks share a card or run on the CPU."""
    if device.type != "cuda":
        return "gloo"
    store.set(f"gabby/card/{rank}", _card_key(device))
    cards = {store.get(f"gabby/card/{r}").decode() for r in range(world)}
    return "nccl" if len(cards) == world else "gloo"


def init_distributed(coordinator: Optional[str], num_processes: int,
                     process_id: int, *, dp: int = 1, store=None,
                     device=None, timeout: Optional[float] = 60.0) -> TPGroup:
    """Join rank `process_id` of `num_processes` = dp x tp and return its
    TPGroup (rank r is replica r // tp's tp rank r % tp). The store is
    `store` when given (tests pass a FileStore), else a TCPStore at
    `coordinator` ("host:port", hosted by rank 0). The data plane's
    backend is `choose_backend`'s for the whole world, printed. Every rank
    makes every tp and dp subgroup, in one order. timeout: seconds any
    collective may block before it raises (None: the torch default of 30
    minutes)."""
    if dp < 1 or num_processes % dp:
        raise ValueError(f"dp={dp} must divide the process count "
                         f"{num_processes}")
    tp = num_processes // dp
    dev = resolve_device(device)
    td = (datetime.timedelta(seconds=timeout) if timeout
          else datetime.timedelta(minutes=30))
    if store is None:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=td)
    backend = choose_backend(dev, store, process_id, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=td)
    ctrl = dist.new_group(backend="gloo", timeout=td)
    d, t = divmod(process_id, tp)
    tp_group = dp_group = dist.group.WORLD
    if dp > 1 and tp > 1:
        # the model axis innermost: replica d is ranks [d * tp, (d + 1) * tp)
        tp_groups = [dist.new_group([r * tp + i for i in range(tp)],
                                    timeout=td) for r in range(dp)]
        dp_groups = [dist.new_group([r * tp + i for r in range(dp)],
                                    timeout=td) for i in range(tp)]
        tp_group, dp_group = tp_groups[d], dp_groups[t]
    elif dp > 1:
        tp_group = None
    else:
        dp_group = None
    grid = f"dp {d}/{dp}, " if dp > 1 else ""
    print(f"{grid}tp rank {t}/{tp} on {dev}: data plane {backend}, "
          f"control plane gloo", flush=True)
    return TPGroup(rank=t, size=tp, device=dev, backend=backend,
                   group=tp_group, ctrl=ctrl, store=store, dp_rank=d,
                   dp_size=dp, dp_group=dp_group)


def _rank_entry(fn, rank: int, nprocs: int, args: tuple, results) -> None:
    try:
        results.put((rank, True, fn(rank, nprocs, *args)))
    except BaseException:  # noqa: BLE001 — relayed to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (), *,
                timeout: float) -> list:
    """Run fn(rank, nprocs, *args) in `nprocs` processes started with the
    spawn method and return their results in rank order. A result must
    pickle without shared memory (numpy and plain Python, not tensors: a
    rank exits once it has returned). A rank that raises, dies or is still
    running after `timeout` seconds fails the call; every process is
    stopped before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, rank, nprocs, args, results))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict[int, Any] = {}
    seen_dead: set[int] = set()
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(nprocs)) - set(got))
                raise TimeoutError(f"ranks {late} still running after "
                                   f"{timeout:.0f}s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank found dead on two empty polls in a row left no
                # result (the first poll may race its last put)
                dead = {r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None}
                for r in sorted(dead & seen_dead):
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{procs[r].exitcode} and no result")
                seen_dead = dead
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[rank] for rank in range(nprocs)]
