"""A cell on n > 1 chips: one process per GPU in one `torch.distributed`
group, set up as the CLI's multi-GPU spawn sets up its workers
(`henjou_torch/render.py` `_worker`): `torch.cuda.set_device(rank)`, then
`init_process_group("nccl", tcp://localhost:<free port>, world, rank)`.
On the CPU the same code joins a gloo group, so the harness's tests can
drive it.

Rank 0 is the harness's own process. `Leader` starts ranks 1..n-1 as
follower processes (`benchmark/follower.py`) before rank 0 builds its
renderer; every rank renders the cell's option file through
`Renderer.initialize_and_render`, and the program shards each frame's
samples over the group. Rank 0's `Window` decides at every frame start
whether the loop goes on or stops; `lockstep` hands that decision to every
rank in one broadcast, so all ranks leave the frame loop at the same frame.

Nothing hangs: a follower that exits non-zero while the run goes on ends
rank 0 at once (`os._exit`, no result: rank 0 may be blocked in a
collective that will never complete); followers that do not exit within
FOLLOWER_EXIT_S of the window's close are killed and the run gives no
result; a follower ends itself when rank 0's process is gone; and every
collective of the group times out after GROUP_TIMEOUT_S.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLLOWER = os.path.join(BENCH_DIR, "follower.py")
# a collective that waits longer than this fails the run (set-up skew
# between ranks, a first run's kernel build included, stays well under it)
GROUP_TIMEOUT_S = 300
# after the window closes, every follower has this long to leave the
# group and exit
FOLLOWER_EXIT_S = 60
# how often rank 0 looks at its followers, and a follower at rank 0
POLL_S = 0.2
# exit codes of a run that a follower ended
FOLLOWER_FAILED = 5
LEADER_GONE = 6


class FollowerError(RuntimeError):
    pass


def join(rank: int, world: int, init_method: str, device_type: str):
    """Join the group as `rank`; the torch.device this rank renders on."""
    import torch
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=init_method, world_size=world,
                                rank=rank, timeout=timeout)
        return torch.device("cuda", rank)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    return torch.device("cpu")


def lockstep(stop: bool) -> bool:
    """Rank 0's `stop` on every rank (the others pass anything): one
    broadcast at each frame start."""
    import torch
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(stop))], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())


def fullest_peak(device) -> int:
    """The largest CUDA allocator peak of any rank's device (0 on the
    CPU), on every rank: each rank calls it once, after the window."""
    import torch
    import torch.distributed as dist

    mine = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t = torch.tensor([int(mine)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def follower_command(rank: int, world: int, init_method: str, option_path: str,
                     device_type: str) -> list:
    return [sys.executable, FOLLOWER, "--rank", str(rank), "--world", str(world),
            "--init", init_method, "--option", option_path, "--device", device_type,
            "--leader", str(os.getpid())]


class Leader:
    """Rank 0's side of the group: starts the followers, joins the group,
    watches the followers until `close`."""

    def __init__(self, world: int, option_path: str, device_type: str):
        init = f"tcp://localhost:{free_port()}"
        self.procs = []
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        try:
            for rank in range(1, world):
                # a follower's standard output goes to file descriptor 2,
                # standard error: the last line of standard output is rank
                # 0's result alone
                self.procs.append(subprocess.Popen(
                    follower_command(rank, world, init, option_path, device_type), stdout=2))
            self._watch.start()
            self.device = join(0, world, init, device_type)
        except BaseException:
            self.kill()
            raise

    def _watchdog(self):
        while not self._stop.wait(POLL_S):
            for rank, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and rc != 0 and not self._stop.is_set():
                    print(f"no result: follower rank {rank} exited with code {rc} during the "
                          "run", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(FOLLOWER_FAILED)

    def close(self) -> int:
        """After the window: the fullest device's memory peak over the
        group, then leave the group and wait for every follower to exit
        with 0; raises FollowerError otherwise."""
        import torch.distributed as dist

        peak = fullest_peak(self.device)
        dist.destroy_process_group()
        self._stop.set()
        self._watch.join()
        failed = []
        deadline = time.monotonic() + FOLLOWER_EXIT_S
        for rank, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "none (did not exit)"
            if rc != 0:
                failed.append(f"rank {rank}: {rc}")
        if failed:
            self.kill()
            raise FollowerError("followers' exit codes " + ", ".join(failed))
        return peak

    def kill(self):
        """End every follower still running and wait for it."""
        self._stop.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def watch_leader(leader_pid: int):
    """In a follower: end this process when rank 0's is gone (its parent
    changes)."""

    def run():
        while os.getppid() == leader_pid:
            time.sleep(POLL_S)
        os._exit(LEADER_GONE)

    threading.Thread(target=run, daemon=True).start()
