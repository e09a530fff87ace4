"""profile_system.py's device busy time: the union of operation intervals,
so that overlapping operations on several streams count once."""
import pytest
import torch

import profile_system

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], 0.0),
        ([(0.0, 2.0)], 2.0),
        ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),  # overlap and order
        ([(0.0, 4.0), (1.0, 2.0)], 4.0),  # nested
        ([(0.0, 1.0), (1.0, 2.0)], 2.0),  # touching
    ],
)
def test_busy_is_the_union_of_intervals(intervals, want):
    assert profile_system.busy_us(intervals) == want


@pytest.mark.parametrize(
    "name, want",
    [
        ("(anonymous namespace)::fast_score_kernel(float const*, float*, int, int, float, float)", "fast_score_kernel"),
        ("void (anonymous namespace)::pose_lm_kernel<false>(float const*, float const*)", "pose_lm_kernel<false>"),
        ("void at::native::(anonymous namespace)::masked_fill_kernel(at::TensorIterator&)", None),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)", None),
    ],
)
def test_hand_written_kernels_are_told_from_pytorch_ones(name, want):
    """The csrc/ kernels (top-level anonymous namespaces, templates named
    after their return type) by name; PyTorch's are not among them."""
    m = profile_system.OURS.match(name)
    assert (m.group(1) if m else None) == want
