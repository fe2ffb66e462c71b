"""The binned intersector's share of its bandwidth roofline in the traced
window: the bytes its calls need (hbench.roofline.trace_bytes from each
call's shapes, counted at the program's public `intersect_binned`) at
3.35 TB/s, over the device time of the binned walk kernel by name. The
calls counted on the device have to be the launches that the program's
own `LAUNCHES` counter saw, or the reading is refused."""

from hbench.roofline import checked_calls, share_pct, trace_bytes

HOOKS = (("henjou_torch.accel.pallas_binned", "intersect_binned"),)
COUNTER = ("henjou_torch.accel.pallas_binned", "LAUNCHES")
KERNELS = r"walk_kernel"


def count(args, kwargs, fn="intersect_binned"):
    bc, ray_o = args[0], args[1]
    if ray_o.device.type != "cuda":
        return {}
    any_hit = bool(kwargs.get("any_hit", args[5] if len(args) > 5 else False))
    pack = 4 * (bc.rows.numel() + bc.aabb.numel() + bc.gaabb.numel())
    return {"bytes": trace_bytes(int(ray_o.shape[0]), pack, any_hit), "calls": 1}


def read(ctx):
    t = ctx.get("trace")
    sums = checked_calls(ctx.get("hooks", {}).get("binned_roofline"), "intersect_binned")
    if t is None or not sums:
        return None
    return share_pct(sums["bytes"], t.seconds_of(KERNELS))
