"""Faults planted in the program for the tests of the check: each breaks the
timed path underneath the harness, which must then judge the run not
correct. `install(name, set_attr, rank)` plants one in this process with
`set_attr` (pytest's `monkeypatch.setattr`, or `setattr` in a rank's own
process); on a cell of n > 1 chips every rank plants it, and each fault
says which ranks it breaks."""

import torch


def _wrap_steps(set_attr, fault):
    from henjou_torch.runtime.renderer import Renderer

    for name in ("_make_wavefront_step", "_make_masked_step"):
        make = getattr(Renderer, name)

        def broken(self, *a, _make=make, **k):
            step, groups = _make(self, *a, **k)
            return (lambda arg, s0, n, **kw: fault(step, arg, s0, n, **kw)), groups

        set_attr(Renderer, name, broken)


def _unchanged(step, arg, s0, n, **kw):
    """The step returns its state unchanged: no sample reaches the film."""
    out = step(arg, s0, n, **kw)
    return tuple(torch.zeros_like(x) for x in out[:5]) + (out[5],)


def _half(step, arg, s0, n, **kw):
    """Half the batch left out, the mean taken over the rest: half the
    samples of a step; in a one-sample step of the masked engine, every
    other pixel of the tile, each rendered pixel's sums given to the next."""
    if n > 1 or not torch.is_tensor(arg):
        return step(arg, s0, max(1, n // 2), **kw)
    out = step(arg[::2], s0, n, **kw)
    return tuple(x.repeat_interleave(2, 0)[:arg.shape[0]] for x in out[:5]) + (out[5],)


def _altered(step, arg, s0, n, **kw):
    """An answer altered where it is produced: every 4th pixel's colour."""
    out = list(step(arg, s0, n, **kw))
    c = out[0].clone()
    c[::4] *= 1.5
    out[0] = c
    return tuple(out)


def _altered_finalize(set_attr):
    """The finalized image altered on every 3rd row."""
    from henjou_torch.runtime.renderer import Renderer

    fin = Renderer._finalize

    def broken(self, aovs, frame=None):
        img = fin(self, aovs, frame=frame).copy()
        img[::3] *= 1.1
        return img

    set_attr(Renderer, "_finalize", broken)


def _altered_history(set_attr):
    """DenoiseTemporal's history altered as the finalize banks it: every
    frame's own image is right, and only the next frame's shows it."""
    from henjou_torch.runtime.renderer import Renderer

    fin = Renderer._finalize_temporal

    def broken(self, dev, frame):
        out = fin(self, dev, frame)
        hist = self._temporal_history
        self._temporal_history = (hist[0] * 1.5,) + tuple(hist[1:])
        if self._temporal_raw is not None:
            raw = self._temporal_raw
            self._temporal_raw = (raw[0] * 1.5,) + tuple(raw[1:])
        return out

    set_attr(Renderer, "_finalize_temporal", broken)


def _exchange_left_out(set_attr):
    """The exchange between chips left out for this rank: it takes part in
    each all-reduce of the film with zeros, so its share of the samples
    never reaches the sum."""
    from henjou_torch.runtime import sharding

    reduce = sharding.all_reduce_film

    def dropped(sums):
        return reduce(tuple(torch.zeros_like(x) for x in sums))

    set_attr(sharding, "all_reduce_film", dropped)


def _raises_in_window(set_attr):
    """The rank raises in the frame loop at its third frame, the first of
    the window after a cell's two warm-up frames."""
    from henjou_torch.runtime.renderer import Renderer

    render = Renderer.render_frame
    calls = []

    def broken(self, frame, *a, **k):
        calls.append(frame)
        if len(calls) == 3:
            raise RuntimeError(f"planted fault at frame {frame}")
        return render(self, frame, *a, **k)

    set_attr(Renderer, "render_frame", broken)


STEP = {"_unchanged": _unchanged, "_half": _half, "_altered": _altered}
# fault -> (plant(set_attr), whether rank 0 plants it, whether followers do)
OTHER = {"finalize": (_altered_finalize, True, False),
         "history": (_altered_history, True, False),
         "exchange": (_exchange_left_out, False, True),
         "raise": (_raises_in_window, False, True)}
NAMES = (*STEP, *OTHER)


def install(name, set_attr, rank: int = 0):
    if name in STEP:
        _wrap_steps(set_attr, STEP[name])
        return
    plant, leader, followers = OTHER[name]
    if (leader if rank == 0 else followers):
        plant(set_attr)
