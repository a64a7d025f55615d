"""Port hardware database and pointer-chase analysis against the reference:
every registered part serializes to the same JSON, ``fit_from_probes`` fits
the same model from the same inputs, Sattolo's permutation is bit-identical
and plateau detection segments the same curves the same way."""
import numpy as np
import pytest

import repro.hw as jhw
import repro_torch.hw as thw
from repro.core import pchase as jpc
from repro_torch.core import pchase as tpc

SPEC_PARTS = ("A100", "B200", "H100", "P4", "T4_PAPER", "TPU_V5E", "V100")


@pytest.mark.parametrize("const", SPEC_PARTS)
def test_spec_part_json_equal(const):
    assert getattr(thw, const).to_json() == getattr(jhw, const).to_json()


def test_every_registered_part_and_alias_matches():
    for name in thw.names():
        if name == "measured-host":  # a fit, covered below
            continue
        assert thw.get(name).to_json() == jhw.get(name).to_json()
    for alias in ("t4", "h100", "h100-sxm", "tpu-v5e", "p4", "v100", "a100", "b200"):
        assert thw.get(alias).name == jhw.get(alias).name
    assert thw.compare("H100", "T4") == jhw.compare("H100", "T4")
    assert [h.name for h in thw.query(dtype="int8", min_peak=500e12)] == [
        h.name for h in jhw.query(dtype="int8", min_peak=500e12)
    ]


def test_fit_from_probes_equal():
    kw = dict(
        name="fit-parity-host",
        plateau_levels=[(1.5, 32768), (4.25, 1 << 20), (80.0, None)],
        stream_Bps=1.2e12,
        matmul_flops={"float32": 3.3e13},
    )
    try:
        got, want = thw.fit_from_probes(**kw), jhw.fit_from_probes(**kw)
        assert got.to_json() == want.to_json()
        assert thw.get("fit-parity-host").to_json() == want.to_json()
        assert thw.HardwareModel.from_json(got.to_json()) == got
    finally:
        thw.unregister("fit-parity-host")
        jhw.unregister("fit-parity-host")


@pytest.mark.parametrize("n", [1, 2, 8, 1000, 65537])
@pytest.mark.parametrize("seed", [0, 3])
def test_single_cycle_permutation_identical(n, seed):
    got = tpc.single_cycle_permutation(n, seed)
    want = jpc.single_cycle_permutation(n, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    idx, seen = 0, set()  # one n-cycle
    for _ in range(n):
        seen.add(idx)
        idx = int(got[idx])
    assert idx == 0 and len(seen) == n


@pytest.mark.parametrize("seed", range(4))
def test_detect_plateaus_identical(seed):
    rng = np.random.default_rng(seed)
    sizes = np.array([1 << p for p in range(10, 28)])
    steps = np.repeat([1.0, 4.0, 30.0, 120.0], [4, 5, 5, 4])
    lat = steps * (1 + 0.05 * rng.standard_normal(len(sizes)))
    for rel in (0.3, 0.35):
        got = tpc.detect_plateaus(sizes, lat, rel)
        want = jpc.detect_plateaus(sizes, lat, rel)
        assert [(p.latency, p.start_size, p.end_size) for p in got] == [
            (p.latency, p.start_size, p.end_size) for p in want
        ]
        assert tpc.capacities_from_plateaus(got) == jpc.capacities_from_plateaus(want)
