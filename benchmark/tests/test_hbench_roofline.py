"""The byte counts of the rooflines at toy shapes, the metric readers'
per-call counts, and the hooks that count calls at the program's public
wrappers."""

import types

import pytest
import torch

from hbench import roofline, spec
from hbench.hooks import HookError, Hooks


def test_trace_bytes():
    # 4 rays: 32 B in, 16 B out each (closest) or 4 B (any-hit), + pack
    assert roofline.trace_bytes(4, 1000, False) == 4 * 48 + 1000
    assert roofline.trace_bytes(4, 1000, True) == 4 * 36 + 1000


def test_sort_bytes():
    # 8 rows, key 4 B read and 4 B written, 12 B of payload read and written
    assert roofline.sort_bytes(8, 12) == 8 * (4 + 4 + 24)
    # an unsort reads its lane ids and writes no key
    assert roofline.sort_bytes(8, 12, key_written=False) == 8 * (4 + 24)


def test_share_pct():
    b = roofline.BYTES_PER_S
    assert roofline.share_pct(b * 1e-3, 2e-3) == pytest.approx(50.0)
    assert roofline.share_pct(0, 1.0) is None and roofline.share_pct(1.0, 0) is None


class _Cuda(types.SimpleNamespace):
    """A stand-in for a CUDA tensor's shape and device."""

    device = torch.device("cuda")

    def __init__(self, *shape, size=4):
        super().__init__(shape=shape, _size=size)

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return self._size


def test_binned_count_from_shapes():
    mod = spec.metric_reader("binned_roofline")
    bc = types.SimpleNamespace(rows=torch.zeros(32, 128), aabb=torch.zeros(8, 2),
                               gaabb=torch.zeros(8, 1))
    o = _Cuda(5, 3)
    pack = 4 * (32 * 128 + 16 + 8)
    assert mod.count((bc, o, o, None, None, False), {}, "intersect_binned") == {
        "bytes": 5 * 48 + pack, "calls": 1}
    assert mod.count((bc, o, o, None), {"any_hit": True}, "intersect_binned")["bytes"] == (
        5 * 36 + pack)
    # the plain version on the CPU launches nothing
    assert mod.count((bc, torch.zeros(5, 3), o, None), {}, "intersect_binned") == {}


def test_bitonic_count_from_shapes():
    mod = spec.metric_reader("bitonic_sort_roofline")
    key = _Cuda(16)
    planes = (_Cuda(16, 3), _Cuda(16), _Cuda(16))
    assert mod.count((key, *planes), {}, "bitonic_sort") == {
        "bytes": 16 * (4 + 4 + 2 * 20), "calls": 1}
    assert mod.count((key, *planes), {}, "bitonic_unsort") == {
        "bytes": 16 * (4 + 2 * 20), "calls": 1}
    assert mod.count((key,), {}, "bitonic_unsort") == {}
    assert mod.count((torch.zeros(16, dtype=torch.int32), torch.zeros(16)), {},
                     "bitonic_sort") == {}


def test_roofline_readers_need_a_trace_and_calls():
    mod = spec.metric_reader("binned_roofline")
    assert mod.read({}) is None
    assert mod.read({"trace": object(), "hooks": {}}) is None
    none = {"calls": 0.0, "launches": 0.0}
    assert mod.read({"trace": object(), "hooks": {"binned_roofline": none}}) is None


def test_roofline_refuses_calls_the_program_did_not_launch():
    mod = spec.metric_reader("bitonic_sort_roofline")
    sums = {"bitonic_sort_roofline": {"bytes": 1e6, "calls": 3.0, "launches": 4.0}}
    with pytest.raises(ValueError, match="3 calls"):
        mod.read({"trace": object(), "hooks": sums})


def test_hooks_count_every_reference_and_restore():
    """A default argument bound at import still reaches the hooked
    function; the counter's rise is kept; removal restores the function."""
    from henjou_torch.accel import bitonic, sorting

    bound = sorting.make_bitonic_sorted_intersector.__defaults__
    assert bitonic.bitonic_sort in bound
    code = bitonic.bitonic_sort.__code__
    h = Hooks()
    h.install("m", (("henjou_torch.accel.bitonic", "bitonic_sort"),),
              lambda a, k, fn: {"rows": a[0].shape[0], "calls": 1},
              ("henjou_torch.accel.bitonic", "LAUNCHES"))
    key = torch.tensor([3, 1, 2], dtype=torch.int32)
    sorted_key, col = bound[0](key, torch.arange(3.0))
    h.remove()
    assert sorted_key.tolist() == [1, 2, 3] and col.tolist() == [1.0, 2.0, 0.0]
    assert dict(h.sums["m"]) == {"launches": 0.0, "rows": 3.0, "calls": 1.0}
    assert bitonic.bitonic_sort.__code__ is code
    bitonic.bitonic_sort(key)  # no longer counted
    assert h.sums["m"]["calls"] == 1.0


@pytest.mark.parametrize("target", [("henjou_torch.accel.bitonic", "no_such_sort"),
                                    ("henjou_torch.no_such_module", "f"),
                                    ("henjou_torch.accel.bitonic", "LAUNCHES")])
def test_a_hook_that_cannot_install_raises(target):
    with pytest.raises(HookError):
        Hooks().install("m", (target,), lambda a, k, fn: {})


@pytest.mark.parametrize("name", ["binned_roofline", "bitonic_sort_roofline"])
def test_reader_hooks_install_on_the_program(name):
    mod = spec.metric_reader(name)
    h = Hooks()
    h.install(name, mod.HOOKS, mod.count, mod.COUNTER)
    h.remove()
