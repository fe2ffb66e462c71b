"""The device trace's arithmetic on a synthetic trace: busy time as the
union of intervals, idle gaps labelled by the host's CUDA call, time by
name, launches."""

import pytest

from hbench import spec
from hbench.trace import DeviceTrace, union_seconds

MS = 1_000_000  # ns


def _trace():
    kernels = [("walk_kernel<Binned>", 0, 2 * MS), ("add", 1 * MS, 3 * MS),
               ("network<true>", 5 * MS, 6 * MS), ("Memcpy DtoH", 6 * MS, 7 * MS),
               ("add", 10 * MS, 11 * MS)]
    runtime = [("cudaLaunchKernel", 0, MS // 10), ("cudaStreamSynchronize", 3 * MS, 5 * MS)]
    return DeviceTrace(kernels, runtime, 0.020)


def test_union_seconds():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == pytest.approx(4e-9)
    assert union_seconds([]) == 0.0
    assert union_seconds([(0, 10), (2, 3)]) == pytest.approx(10e-9)


def test_busy_idle_and_launches():
    t = _trace()
    assert t.busy_s() == pytest.approx(0.006)  # [0,3] + [5,7] + [10,11] ms
    assert t.launches() == 4  # the memcpy is not a launch
    assert t.seconds_of(r"walk_kernel") == pytest.approx(0.002)
    assert t.seconds_of(r"network<|scatter_columns") == pytest.approx(0.001)
    idle = spec.metric_reader("device_idle_pct").read({"trace": t})
    assert idle == pytest.approx(70.0)
    lps = spec.metric_reader("launches_per_spp").read({"trace": t, "traced": [{"spp": 2}]})
    assert lps == 2.0


def test_idle_gaps_by_host_call():
    gaps = dict(_trace().idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.002)
    assert gaps["host outside any CUDA call"] == pytest.approx(0.003)


def test_top_ops_sorted():
    ops = _trace().top_ops(2)
    assert ops[0] == ["add", pytest.approx(0.003)]
    assert len(ops) == 2


def test_short_name():
    from hbench.trace import short_name

    long = ("void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<long>,"
            " std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<long>)")
    assert short_name(long) == ("vectorized_elementwise_kernel<2, CUDAFunctor_add<long>,"
                                " std::array<char*, 3ul> >")
    assert len(short_name("x" * 300)) == 120


def test_allreduce_ms_counts_nccl_kernels_alone():
    nccl = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
             20 * MS, 23 * MS),
            ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
             30 * MS, 30 * MS + MS // 2)]
    t = _trace()
    read = spec.metric_reader("allreduce_ms").read
    assert read({"trace": DeviceTrace(t.kernels + nccl, t.runtime, 0.040)}) == \
        pytest.approx(3.5)
    # a trace without NCCL kernels (one chip, or a gloo group), or none at all
    assert read({"trace": t}) is None
    assert read({}) is None
