"""Mean milliseconds per window frame outside its render and finalize:
total_s - render_s - finalize_s of the program's frame_stats (the frame's
scene and camera, the sRGB conversion and PNG, the checkpoint's removal)."""


def read(ctx):
    fr = ctx["window"]["frames"]
    if not fr:
        return None
    return 1e3 * sum(f["total_s"] - f["render_s"] - f["finalize_s"] for f in fr) / len(fr)
