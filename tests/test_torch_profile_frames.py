"""The host-side helpers of `profile_frames.py` that read the port's own
kernels out of a profiler trace (the trace itself needs a card)."""

import pytest

from wild_video_3d_reconstruction_torch import profile_frames as pf


def test_port_kernel_sources_name_every_kernel():
    assert pf.port_kernel_sources() == {
        "chol_solve_kernel": "chol.cu", "corr_box_kernel": "corr_box.cu",
        "surfaces_kernel": "corr_box.cu", "extract_kernel": "corr_region.cu",
        "runsum_boundary": "runsum.cu", "runsum_apply": "runsum.cu",
        "corr_backward_kernel": "corr_grad.cu"}


@pytest.mark.parametrize("key,name", [
    ("(anonymous namespace)::runsum_apply(float4 const*, int const*)",
     "runsum_apply"),
    ("void (anonymous namespace)::corr_box_kernel<__nv_bfloat16>(float*)",
     "corr_box_kernel"),
    # PyTorch's own kernels, also in anonymous namespaces
    ("void (anonymous namespace)::elementwise_kernel_with_index<int>(int)",
     None),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>()",
     None),
])
def test_port_kernel_names_only_the_ports_kernels(key, name):
    assert pf.port_kernel(key, pf.port_kernel_sources()) == name


def test_busy_ms_counts_overlapping_kernels_once():
    # microseconds in, ms out: [0, 160) and [200, 210)
    assert pf.busy_ms([(50, 160), (0, 100), (200, 210)]) == pytest.approx(
        0.17)
    assert pf.busy_ms([]) == 0.0
