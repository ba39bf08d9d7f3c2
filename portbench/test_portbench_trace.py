"""CPU tests of the trace reduction's pure parts: kernel names to launch
names, busy intervals, and the host op behind an idle gap."""

import pytest

from portbench import trace

LAUNCHES = {"fold_tw", "fold_end", "fold_end2_mul", "pointwise_mul"}


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::fold_tw_kernel<false>(int const*, long)",
     "fold_tw"),
    ("void (anonymous namespace)::fold_tw_t_kernel<true>(int const*)",
     "fold_tw"),
    ("void (anonymous namespace)::fold_end2_mul_kernel<false>(int const*)",
     "fold_end2_mul"),
    ("void (anonymous namespace)::fold_end_kernel<false>(int const*, long)",
     "fold_end"),
    ("void (anonymous namespace)::pointwise_mul_kernel<false>(unsigned long)",
     "pointwise_mul"),
    ("void at::native::elementwise_kernel<128, 2, at::native::fold_tw>(int)",
     None),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8>(Params)",
     None),
    ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n", None),
    ("Memcpy DtoH (Device -> Pageable)", None),
])
def test_hand_kernel_names(name, want):
    assert trace._hand_name(name, LAUNCHES) == want


@pytest.mark.parametrize("name,want", [
    ("void at::native::elementwise_kernel<128, 2, at::native::fold_tw>(int)",
     True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>()",
     True),
    ("void at_cuda_detail::cub::DeviceReduceKernel<int>(int*)", True),
    ("Memcpy DtoH (Device -> Pageable)", True),
    ("Memset (Device)", True),
    ("void (anonymous namespace)::fold_end_kernel<false>(int const*, long)",
     False),
    ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n", False),
])
def test_torch_kernel_names(name, want):
    """PyTorch's own kernels, copies and fills; a hand kernel or a GEMM
    is not one, so a hand kernel the launch names miss is counted in no
    layer rather than in the torch ops."""
    assert trace.is_torch_kernel(name) == want


def test_merge_and_host_label():
    busy = trace._merge([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [[0, 3], [5, 9]]
    cpu = sorted([(0, 10, "portbench.call"), (1, 4, "aten::add"),
                  (2, 3, "cudaLaunchKernel"), (6, 8, "aten::mul")])
    starts = [c[0] for c in cpu]
    assert trace._host_label(cpu, starts, 2.5) == "cudaLaunchKernel"
    assert trace._host_label(cpu, starts, 3.5) == "aten::add"
    assert trace._host_label(cpu, starts, 5.0) == "portbench.call"
    assert trace._host_label(cpu, starts, 7.0) == "aten::mul"
    assert trace._host_label(cpu, starts, 11.0) == "python"


def test_breakdown_keeps_ten_of_each():
    t = trace.TraceSummary(1, 1.0, 0.5, {f"k{i}": i for i in range(12)}, {},
                           0.0, [], [], {}, {f"h{i}": i for i in range(12)})
    b = t.breakdown()
    assert [k for k, _ in b["device_ops"]] == [f"k{i}" for i in
                                               range(11, 1, -1)]
    assert len(b["idle_gaps"]) == 10
