"""The keyed sort's share of its bandwidth roofline in the traced window:
the bytes of every `bitonic_sort` and `bitonic_unsort` call on the device
(hbench.roofline.sort_bytes from each call's shapes, counted at the
program's public wrappers) at 3.35 TB/s, over the device time of the
network and column kernels by name. The calls counted have to be the
launches that the program's own `LAUNCHES` counter saw."""

from hbench.roofline import checked_calls, share_pct, sort_bytes

HOOKS = (("henjou_torch.accel.bitonic", "bitonic_sort"),
         ("henjou_torch.accel.bitonic", "bitonic_unsort"))
COUNTER = ("henjou_torch.accel.bitonic", "LAUNCHES")
KERNELS = r"network<|scatter_columns|gather_columns"


def count(args, kwargs, fn="bitonic_sort"):
    key, planes = args[0], args[1:]
    if key.device.type != "cuda" or not planes:
        return {}  # the plain version on the CPU, or an unsort of nothing: no launch
    cols = sum(p.element_size() * (p.shape[1] if p.dim() == 2 else 1) for p in planes)
    # the sort writes its sorted key; the unsort reads lane ids and writes none
    return {"bytes": sort_bytes(int(key.shape[0]), cols, key_written=fn == "bitonic_sort"),
            "calls": 1}


def read(ctx):
    t = ctx.get("trace")
    sums = checked_calls(ctx.get("hooks", {}).get("bitonic_sort_roofline"), "bitonic_sort")
    if t is None or not sums:
        return None
    return share_pct(sums["bytes"], t.seconds_of(KERNELS))
