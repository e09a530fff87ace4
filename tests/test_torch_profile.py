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
