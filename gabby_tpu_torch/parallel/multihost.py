"""Multi-process serving coordination (counterpart of
gabby_tpu/parallel/multihost.py).

Every rank must make the same device calls and collectives in the same
order, but requests only arrive at rank 0's HTTP front door. HostSync
closes that gap: rank 0 broadcasts each serving-loop iteration's plan
(admissions, decode step count, cancellations) and every rank replays it,
so the tensor-parallel shards and the data-parallel replicas stay in
lockstep. Payloads are arbitrary pickled objects, moved over the gloo
control group in two phases: the length, then the padded bytes.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist


class HostSyncTimeout(RuntimeError):
    """A broadcast did not complete in time: a peer rank is dead or
    unreachable. The caller must fail its in-flight work and stop issuing
    collectives (an abandoned collective cannot be taken back)."""


class HostSync:
    """Rank 0 -> all broadcast of small host-side control payloads, and
    the ranks' liveness.

    timeout: seconds a broadcast may block before a peer is declared dead
    (HostSyncTimeout; None waits forever). An idle leader broadcasts a
    no-op plan every <= 2 s, so a wait near the timeout means a rank is
    gone, not idle.

    Liveness: every rank bumps its counter in the group's store once a
    second (`store.add("gabby/hb/<rank>", 1)`); `dead_peers` reads the
    others' (`store.add(key, 0)`). This sees a peer stuck or killed INSIDE
    a device collective, a hang the broadcast timeout never sees because
    the serving loop blocks in the collective and never reaches the next
    broadcast."""

    HB_INTERVAL = 1.0  # seconds between liveness-counter bumps

    def __init__(self, group, timeout: Optional[float] = 60.0):
        self.group = group
        # every rank of the dp x tp grid replays the plan
        self.process_index = group.world_rank
        self.num_processes = group.world_size
        self.timeout = timeout
        self.store = group.store
        self._hb_seen: dict[int, tuple[Optional[int], float]] = {}
        # one persistent worker serves every timed broadcast
        self._bc_req: queue.Queue = queue.Queue()
        self._bc_res: queue.Queue = queue.Queue()
        self._bc_thread: Optional[threading.Thread] = None
        self._bc_poisoned = False
        if self.num_processes > 1:
            now = time.monotonic()
            self._hb_seen = {p: (None, now)
                             for p in range(self.num_processes)
                             if p != self.process_index}
            if self.store is not None:
                threading.Thread(target=self._heartbeat_loop, daemon=True,
                                 name="hostsync-heartbeat").start()

    def _heartbeat_loop(self) -> None:
        key = f"gabby/hb/{self.process_index}"
        while True:
            try:
                self.store.add(key, 1)
            except Exception:  # noqa: BLE001
                return  # the store is gone: peers see our stall either way
            time.sleep(self.HB_INTERVAL)

    def dead_peers(self, stall: Optional[float] = None) -> list[int]:
        """Ranks whose liveness counter has not moved within `stall`
        seconds (default: the instance timeout), or EVERY peer when the
        store cannot be reached. Empty = all alive. A peer that never
        bumped its counter counts from this HostSync's construction."""
        stall = self.timeout if stall is None else stall
        if self.num_processes == 1 or self.store is None or stall is None:
            return []
        now = time.monotonic()
        dead = []
        for p, (val, since) in self._hb_seen.items():
            try:
                cur = int(self.store.add(f"gabby/hb/{p}", 0))
            except Exception:  # noqa: BLE001 — the store itself is gone
                return list(self._hb_seen)
            if cur and cur != val:
                self._hb_seen[p] = (cur, now)
            elif now - since > stall:
                dead.append(p)
        return dead

    @property
    def is_leader(self) -> bool:
        return self.process_index == 0

    def _broadcast_impl(self, payload: Any) -> Any:
        ctrl = self.group.ctrl
        data = pickle.dumps(payload if self.is_leader else None)
        length = torch.tensor([len(data)], dtype=torch.int64)
        dist.broadcast(length, 0, group=ctrl)
        buf = torch.zeros(int(length[0]), dtype=torch.uint8)
        if self.is_leader:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        dist.broadcast(buf, 0, group=ctrl)
        return pickle.loads(buf.numpy().tobytes())

    def broadcast(self, payload: Any = None,
                  timeout: Optional[float] = None) -> Any:
        """The leader passes the payload, followers anything (ignored);
        every rank gets the leader's. Collective: every rank calls it at
        the same point. Raises HostSyncTimeout after `timeout` (default:
        the instance's); the collective cannot be cancelled, so its worker
        is abandoned and the instance poisoned."""
        if self.num_processes == 1:
            return payload
        timeout = self.timeout if timeout is None else timeout
        if timeout is None:
            return self._broadcast_impl(payload)
        if self._bc_poisoned:
            raise HostSyncTimeout(
                "a previous broadcast timed out; the abandoned collective "
                "makes this HostSync unusable")
        if self._bc_thread is None:
            self._bc_thread = threading.Thread(
                target=self._broadcast_worker, daemon=True,
                name="hostsync-broadcast")
            self._bc_thread.start()
        self._bc_req.put(payload)
        try:
            kind, val = self._bc_res.get(timeout=timeout)
        except queue.Empty:
            self._bc_poisoned = True
            raise HostSyncTimeout(
                f"plan broadcast did not complete within {timeout:.0f}s "
                f"(rank {self.process_index}/{self.num_processes}): a peer "
                f"rank is dead or partitioned") from None
        if kind == "err":
            raise val
        return val

    def _broadcast_worker(self) -> None:
        while True:
            payload = self._bc_req.get()
            try:
                self._bc_res.put(("ok", self._broadcast_impl(payload)))
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                self._bc_res.put(("err", e))

    def barrier(self) -> None:
        if self.num_processes > 1:
            dist.barrier(group=self.group.ctrl)
