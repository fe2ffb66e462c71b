"""One follower of a cell on n > 1 chips: rank `--rank` of the group that
rank 0, the benchmark's own process (`run.py`), set up and started it for
(see hbench/group.py). It renders the cell's option file through the
program's own frame loop on its GPU, takes rank 0's decision at every frame
start, and leaves the loop when rank 0's window closes. It holds no window,
films or trace of its own and prints no result; it exits 0 only when the
window closed it and it holds none of the JAX modules."""

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from hbench import group  # noqa: E402
from hbench.runner import forbidden_modules  # noqa: E402
from hbench.window import WindowClosed  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one follower rank of a multi-chip cell")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="the group's tcp://localhost:<port>")
    ap.add_argument("--option", required=True, help="the run's option file")
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--leader", type=int, required=True, help="rank 0's process id")
    args = ap.parse_args(argv)
    group.watch_leader(args.leader)
    device = group.join(args.rank, args.world, args.init, args.device)

    import torch.distributed as dist
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device=str(device))
    render = r.render_frame

    def render_frame(*a, **k):
        if group.lockstep(False):
            raise WindowClosed
        return render(*a, **k)

    r.render_frame = render_frame
    try:
        r.initialize_and_render(args.option)
    except WindowClosed:
        pass
    else:
        print(f"follower rank {args.rank}: the frame loop ended before the window closed",
              file=sys.stderr)
        return 1
    group.fullest_peak(device)
    dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"follower rank {args.rank} holds {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
