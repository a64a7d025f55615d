"""The serving engine on (data 4), four CPU ranks over gloo, against the
port's one-device engine and the reference's no-mesh engine (see
``tests/torch_dp_engine.py``)."""
import pytest

from torch_dp_engine import CASES, check


@pytest.mark.parametrize("name,page,slots", CASES)
def test_data4_engine_streams_equal_one_device_and_the_reference(name, page, slots):
    check("data4", name, page, slots)
