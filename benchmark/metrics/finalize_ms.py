"""Mean milliseconds per window frame of the finalize step (the render
mode's denoiser and its probes): frame_stats finalize_s."""


def read(ctx):
    fr = ctx["window"]["frames"]
    if not fr:
        return None
    return 1e3 * sum(f["finalize_s"] for f in fr) / len(fr)
