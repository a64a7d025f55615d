"""The port's numerics guard against the reference's on the CPU.

``repro_torch.kernels.guard`` is held against ``repro.kernels.guard`` on the
same numpy inputs: the tolerance ladder for every float and integer dtype on
three parts, ``compare`` / ``trees_match`` reports, the saturation sentinels,
and the guard's state machine (sample stride, breaker trip, cooldown
doubling, half-open revival, probes and attribution) in the reference's order
of events.  The CPU has no native backend to shadow (a ``cuda`` call on CPU
tensors raises, rightly), so the dispatch weave runs through a test-local
:class:`KernelOp` whose ``cuda`` impl is the kernel's plain version; the
reference runs its Pallas kernel in interpret mode for the same role.  The
guard's state is process-global: every test runs inside ``isolated()`` of
both packages.
"""
import dataclasses
import warnings
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import cli as jcli
from repro.kernels import api as japi
from repro.kernels import guard as jguard
from repro.kernels import flash_attention as jfa
from repro.kernels import matmul as jmm
from repro.kernels import ref as jref
from repro_torch.bench import cli as tcli
from repro_torch.kernels import api as tapi
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import guard as tguard
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ref as tref

BF16 = np.dtype("bfloat16")
PARTS = ("T4", "nvidia-h100-sxm", "tpu-v5e")
FLOATS = ("float64", "float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")
INTS = ("int8", "int16", "int32", "int64", "uint8", "bool")


@pytest.fixture(autouse=True)
def _fresh_guards():
    with jguard.isolated(), tguard.isolated():
        yield


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch on the CPU, bit-exact."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


class PlainOp(tapi.KernelOp):
    """A kernel op whose ``cuda`` impl is the kernel's plain version and runs
    on CPU tensors: the guard's dispatch weave without a card."""

    def bound(self, *args, backend=None, **kwargs):
        be = backend or "cuda"
        return partial(self.impl(be), **{k: v for k, v in kwargs.items()
                                         if k in self._accepts[be]})


def _plain_matmul() -> PlainOp:
    op = PlainOp("matmul")

    def plain(a, b, *, out_dtype=None):
        return tref.matmul_ref(a, b, out_dtype)

    op.bind("cuda", plain)
    op.bind("torch", plain)
    return op


MATMUL = _plain_matmul()


def _tcall(a, b, **kw):
    """The port's guarded matmul on the cuda route (the plain op)."""
    with tapi.kernel_policy(backend="cuda"):
        return MATMUL(a, b, **kw)


# ---------------------------------------------------------------------------
# tolerance ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw", PARTS)
@pytest.mark.parametrize("name", FLOATS + INTS)
def test_tolerance_matches_reference(name, hw):
    tdt = torch.bool if name == "bool" else getattr(torch, name)
    jdt = np.bool_ if name == "bool" else jnp.dtype(name)
    want = dataclasses.asdict(jguard.tolerance(jdt, hw))
    assert dataclasses.asdict(tguard.tolerance(tdt, hw)) == want
    assert dataclasses.asdict(tguard.tolerance(name, hw)) == want  # names resolve too
    if name in FLOATS:
        assert (dataclasses.asdict(tguard.tolerance(tdt, hw, ulps=3))
                == dataclasses.asdict(jguard.tolerance(jdt, hw, ulps=3)))


def test_tolerance_defaults_to_the_t4():
    assert tguard.tolerance(torch.bfloat16).resolved == "float16"
    assert tguard.tolerance(torch.bfloat16) == tguard.tolerance(torch.bfloat16, "T4")


# ---------------------------------------------------------------------------
# compare / trees_match
# ---------------------------------------------------------------------------
def _compare_cases():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    near = x + np.float32(1e-6) * rng.standard_normal(x.shape).astype(np.float32)
    far = x + np.float32(0.5)
    nan = x.copy()
    nan[2, 3] = np.nan
    inf_both = x.copy()
    inf_both[0, 0] = np.inf
    i = rng.integers(-100, 100, (6, 5)).astype(np.int32)
    i_off = i.copy()
    i_off[1, 2] += 3
    xb = x.astype(BF16)
    return {
        "f32_near": (near, x), "f32_far": (far, x), "f32_nan": (nan, x),
        "f32_inf_both": (inf_both, inf_both), "i32_same": (i, i.copy()),
        "i32_off": (i_off, i), "bf16_near": ((x * 1.001).astype(BF16), xb),
        "bf16_far": ((x * 1.5).astype(BF16), xb), "empty": (x[:0], x[:0]),
    }


@pytest.mark.parametrize("hw", ("T4", "nvidia-h100-sxm"))
@pytest.mark.parametrize("case", sorted(_compare_cases()))
def test_compare_reports_match_reference(case, hw):
    got, want = _compare_cases()[case]
    jt = jguard.tolerance(got.dtype, hw)
    tt = tguard.tolerance(_t(got).dtype, hw)
    jr = jguard.compare(got, want, jt, op="x", backend="b")
    tr = tguard.compare(_t(got), _t(want), tt, op="x", backend="b")
    assert (tr.ok, tr.shapes, tr.dtype, tr.checked) == (jr.ok, jr.shapes, jr.dtype, jr.checked)
    for k in ("max_abs", "max_rel", "max_ulp"):
        assert getattr(tr, k) == pytest.approx(getattr(jr, k), rel=1e-12, abs=0), k
    assert tr.describe() == jr.describe()


def test_trees_match_matches_reference():
    cases = [
        ({"a": np.ones(4, np.float32)}, {"a": np.ones(4, np.float32)}),
        ({"a": np.ones(4, np.float32), "b": np.zeros(3, np.float32)},
         {"a": np.ones(4, np.float32), "b": np.full(3, 9.0, np.float32)}),
        ({"v": np.zeros(3, np.float32), "k": np.ones(2, np.int32)},
         {"v": np.zeros(3, np.float32), "k": np.full(2, 2, np.int32)}),
        ((np.ones(2, np.float32),), (np.ones(2, np.float32), np.ones(2, np.float32))),
        ((np.ones(3, np.float32), {"k": np.ones(2, np.float32), "v": np.ones(2, np.float32)}),
         (np.ones(3, np.float32), {"k": np.ones(2, np.float32), "v": np.full(2, 5.0, np.float32)})),
    ]

    def torchify(tree):
        if isinstance(tree, dict):
            return {k: torchify(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(torchify(v) for v in tree)
        return _t(tree)

    for got, want in cases:
        assert tguard.trees_match(torchify(got), torchify(want)) == jguard.trees_match(got, want)


# ---------------------------------------------------------------------------
# saturation sentinels
# ---------------------------------------------------------------------------
def _sentinel_cases():
    rng = np.random.default_rng(11)
    ri = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    rj = rng.integers(-128, 128, (64, 8)).astype(np.int8)
    small = rng.integers(-3, 4, (16, 16)).astype(np.int8)
    big = np.full((16, 16), 64, np.int8)
    with np.errstate(over="ignore"):  # entries past the narrow types' range: inf
        f16 = (rng.standard_normal((32, 32)) * 3e4).astype(np.float16)
        b16 = (rng.standard_normal((32, 32)) * 1e38).astype(BF16)
    f16[0, :5] = np.inf
    f16[1, 0] = np.nan
    b16[3, 3] = np.nan
    f32 = rng.standard_normal((8, 8)).astype(np.float32)
    f32[0, 0] = np.inf
    return {
        "int8_random_to_int8": ((ri, rj), np.int8),
        "int8_random_to_int32": ((ri, rj), np.int32),
        "int8_small_to_int8": ((small, small), np.int8),
        "int8_64s_to_int8": ((big, big), np.int8),
        "fp16_out": ((f16[:, :4], f16[:4]), f16),
        "bf16_out": ((b16[:, :4], b16[:4]), b16),
        "fp32_out": ((f32, f32), f32),
    }


@pytest.mark.parametrize("case", sorted(_sentinel_cases()))
def test_matmul_saturation_check_matches_reference(case):
    args, out = _sentinel_cases()[case]
    if isinstance(out, type):  # integer outputs: the product itself, cast as XLA casts
        jout = np.asarray(jref.matmul_ref(jnp.asarray(args[0]), jnp.asarray(args[1]), out))
        tout = tref.matmul_ref(_t(args[0]), _t(args[1]), getattr(torch, np.dtype(out).name))
        assert np.array_equal(tout.numpy(), jout)
    else:
        jout, tout = out, _t(out)
    want = jmm.saturation_check(args, jout)
    got = tmm.saturation_check(tuple(_t(a) for a in args), tout)
    assert got == want


@pytest.mark.parametrize("case", ("fp16_out", "bf16_out", "fp32_out"))
def test_flash_saturation_check_matches_reference(case):
    _, out = _sentinel_cases()[case]
    assert tfa.saturation_check((), _t(out)) == jfa.saturation_check((), out)


def test_int8_saturation_sentinel_fires_as_in_the_reference():
    a = np.full((16, 16), 64, np.int8)
    with japi.kernel_policy(guard="shadow"):
        with pytest.raises(jguard.SaturationError) as je:
            japi.matmul(jnp.asarray(a), jnp.asarray(a), out_dtype=jnp.int8)
    with tapi.kernel_policy(guard="shadow"):
        with pytest.raises(tguard.SaturationError) as te:
            _tcall(_t(a), _t(a), out_dtype=torch.int8)
    assert (te.value.op, te.value.fraction, str(te.value)) == (
        je.value.op, je.value.fraction, str(je.value))
    # saturation is a property of the inputs: the breaker must not trip
    assert not tguard.is_quarantined("matmul")
    assert tguard.metrics().summary() == jguard.metrics().summary()


def test_small_int8_matmul_passes_sentinel_and_oracle():
    a = torch.ones((16, 16), dtype=torch.int8)
    with tapi.kernel_policy(guard="shadow"):
        out = _tcall(a, a, out_dtype=torch.int32)
    assert torch.equal(out, torch.full((16, 16), 16, dtype=torch.int32))
    gm = tguard.metrics()
    assert gm.sentinel_checks == 1 and gm.saturation_events == 0 and gm.checks == 1


def test_sentinels_can_be_disabled():
    tguard.configure(sentinels=False)
    a = torch.full((16, 16), 64, dtype=torch.int8)
    with tapi.kernel_policy(guard="shadow"):
        _tcall(a, a, out_dtype=torch.int8)  # would raise with sentinels on
    assert tguard.metrics().saturation_events == 0


# ---------------------------------------------------------------------------
# the state machine, event by event against the reference
# ---------------------------------------------------------------------------
def _both(events, a, b, **cfg):
    """Run ``events`` (a list of "call" / "inject" / "clear") through the
    reference's guarded api.matmul and the port's plain op, recording after
    each event what either guard reports."""
    a_np, b_np = a, b
    jguard.configure(**cfg)
    tguard.configure(**cfg)
    traces = []
    for pkg in ("jax", "torch"):
        guard = jguard if pkg == "jax" else tguard
        trace = []
        for ev in events:
            if ev == "inject":
                guard.inject_drift("matmul", scale=0.5)
            elif ev == "clear":
                guard.clear_drift("matmul")
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    try:
                        if pkg == "jax":
                            with japi.kernel_policy(guard=ev):
                                japi.matmul(jnp.asarray(a_np), jnp.asarray(b_np))
                        else:
                            with tapi.kernel_policy(guard=ev):
                                _tcall(_t(a_np), _t(b_np))
                        raised = ""
                    except guard.KernelGuardError as err:
                        raised = type(err).__name__
            s = guard.state()
            br = s.breakers.get("matmul")
            trace.append((ev, raised if ev not in ("inject", "clear") else "",
                          guard.metrics().summary(), s.clock,
                          None if br is None else (br.state, br.fail_count, br.opened_at,
                                                   br.probe_ok)))
        traces.append(trace)
    return traces


def test_sample_mode_stride_matches_reference():
    a, b = _pair(16, 16, 16)
    jt, tt = _both(["sample"] * 8, a, b, sample_stride=4, seed=0)
    assert tt == jt and tt[-1][2]["checks"] == 2


def test_sample_mode_misses_drift_between_strides_then_catches_it():
    a, b = _pair(16, 16, 16)
    events = ["sample", "inject"] + ["sample"] * 4
    jt, tt = _both(events, a, b, sample_stride=4, seed=0, on_drift="oracle")
    assert tt == jt
    assert tt[-1][2]["drift_events"] == 1 and tguard.is_quarantined("matmul")


def test_breaker_trip_cooldown_and_half_open_revival_match_reference():
    a, b = _pair(16, 16, 16, seed=4)
    events = ["inject", "shadow", "clear"] + ["shadow"] * 9
    jt, tt = _both(events, a, b, cooldown=3, probe_checks=2, on_drift="oracle")
    assert tt == jt
    s = tt[-1][2]
    assert s["quarantines"] == 1 and s["half_opens"] == 1 and s["revivals"] == 1
    assert s["degraded_calls"] >= 1 and not tguard.is_quarantined("matmul")


def test_reopened_breaker_doubles_its_cooldown_as_the_reference():
    jguard.configure(cooldown=4, max_cooldown_doublings=4)
    tguard.configure(cooldown=4, max_cooldown_doublings=4)
    for fails in (0, 1, 2, 3, 5, 99):
        assert (tguard.state()._cooldown_ticks(tguard.OpBreaker(fail_count=fails))
                == jguard.state()._cooldown_ticks(jguard.OpBreaker(fail_count=fails)))
    # a re-tripped breaker: the second trip waits twice as long, event by event
    a, b = _pair(16, 16, 16, seed=5)
    events = ["inject", "shadow"] + ["shadow"] * 5 + ["shadow"] * 9 + ["clear"] + ["shadow"] * 12
    jt, tt = _both(events, a, b, cooldown=2, probe_checks=1, on_drift="oracle")
    assert tt == jt
    assert tt[-1][4][1] >= 2  # the breaker tripped more than once


@pytest.mark.parametrize("scale,seed", [(0.01, 0), (0.1, 1), (0.5, 2), (1.0, 3)])
def test_injected_drift_always_trips_shadow_guard(scale, seed):
    tguard.inject_drift("matmul", scale=scale, seed=seed)
    a, b = _pair(16, 32, 16, seed)
    with tapi.kernel_policy(guard="shadow"):
        with pytest.raises(tguard.KernelDriftError) as ei:
            _tcall(_t(a), _t(b))
    rep = ei.value.report
    assert ei.value.op == "matmul" and rep.shapes == ((16, 16),) and rep.dtype == "float32"
    assert rep.max_ulp > rep.tol.ulps
    assert tguard.is_quarantined("matmul") and tguard.metrics().drift_events == 1


@pytest.mark.parametrize("m,k,n,seed", [(16, 16, 16, 0), (16, 64, 32, 1), (32, 32, 16, 2)])
def test_clean_plain_matmul_never_trips_shadow_guard(m, k, n, seed):
    a, b = _pair(m, k, n, seed)
    with tapi.kernel_policy(guard="shadow"):
        out = _tcall(_t(a), _t(b))
    assert out.shape == (m, n)
    gm = tguard.metrics()
    assert gm.checks == 1 and gm.drift_events == 0 and not tguard.quarantined_ops()


def test_native_fault_quarantines_and_serves_the_oracle():
    tguard.configure(degrade=True)  # the port's default re-raises
    tguard.inject_fault("matmul")
    a, b = (_t(x) for x in _pair(16, 16, 16))
    with tapi.kernel_policy(guard="shadow"):
        with pytest.warns(RuntimeWarning, match="quarantined"):
            out = _tcall(a, b)
    assert torch.equal(out, tref.matmul_ref(a, b))
    gm = tguard.metrics()
    assert gm.faults == 1 and gm.degraded_calls == 1 and tguard.is_quarantined("matmul")
    tguard.configure(degrade=False)
    tguard.revive("matmul")
    with tapi.kernel_policy(guard="shadow"):
        with pytest.raises(RuntimeError, match="injected"):
            _tcall(a, b)


# ---------------------------------------------------------------------------
# no fallback on the card: a call on CUDA tensors runs the kernel or raises
# ---------------------------------------------------------------------------
@pytest.fixture
def on_card(monkeypatch):
    """Treat the CPU tensors of a call as CUDA tensors, so the card's rules
    for the guard's fallbacks are driven here (no CUDA graph is captured)."""
    monkeypatch.setattr(tguard, "_on_card", lambda args: True)
    monkeypatch.setattr(tguard, "tracing", lambda args: False)


def _faulty_matmul(kind: str) -> PlainOp:
    """A plain op whose native path really fails: it raises, or it drifts
    (no chaos injection involved)."""
    op = PlainOp("matmul")

    def native(a, b, *, out_dtype=None):
        if kind == "fault":
            raise RuntimeError("kernel launch failed")
        return tref.matmul_ref(a, b, out_dtype) * 1.5

    op.bind("cuda", native)
    op.bind("torch", lambda a, b, *, out_dtype=None: tref.matmul_ref(a, b, out_dtype))
    return op


@pytest.mark.parametrize("kind", ["fault", "drift"])
def test_a_real_failure_on_the_card_is_never_served_by_the_oracle(on_card, kind):
    """With every fallback switched on, a real fault re-raises and a real
    drift raises; the op is quarantined, and its next call raises instead of
    running the oracle."""
    tguard.configure(degrade=True, on_drift="oracle")
    op = _faulty_matmul(kind)
    a, b = (_t(x) for x in _pair(16, 16, 16))
    want = RuntimeError if kind == "fault" else tguard.KernelDriftError
    with tapi.kernel_policy(backend="cuda", guard="shadow"):
        with pytest.raises(want, match="kernel launch failed|kernel drift"):
            op(a, b)
        assert tguard.is_quarantined("matmul")
        with pytest.raises(tguard.KernelGuardError, match="no torch fallback"):
            op(a, b)
    gm = tguard.metrics()
    assert gm.degraded_calls == 0 and gm.quarantines == 1
    assert (gm.faults, gm.drift_events) == ((1, 0) if kind == "fault" else (0, 1))


def test_injected_failures_still_reach_the_oracle_on_the_card(on_card):
    """The chaos surface keeps the reference's breaker sequence on the card:
    an injected fault (with degrade) and injected drift (with on_drift
    "oracle") are served by the oracle, and so are the calls while open."""
    tguard.configure(degrade=True, on_drift="oracle")
    a, b = (_t(x) for x in _pair(16, 16, 16))
    for inject, clear in ((tguard.inject_fault, tguard.clear_fault),
                          (tguard.inject_drift, tguard.clear_drift)):
        inject("matmul")
        with warnings.catch_warnings(), tapi.kernel_policy(guard="shadow"):
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = [_tcall(a, b) for _ in range(2)]
        assert all(torch.equal(o, tref.matmul_ref(a, b)) for o in outs)
        assert tguard.state().breakers["matmul"].injected
        clear("matmul")
        tguard.revive("matmul")
    assert tguard.metrics().degraded_calls == 4


def test_quarantine_routing_outside_a_check_follows_the_same_rule(on_card):
    """``serves_oracle`` (the routing ``KernelOp`` applies while a CUDA
    graph is captured): closed -> native; quarantined by the chaos surface
    -> oracle; quarantined for a real failure -> raise."""
    a = _t(_pair(4, 4, 4)[0])
    assert not tguard.serves_oracle("matmul", (a,))
    tguard.quarantine("matmul", "engine attribution", injected=True)
    assert tguard.serves_oracle("matmul", (a,))
    tguard.revive("matmul")
    tguard.quarantine("matmul", "engine attribution")
    with pytest.raises(tguard.KernelGuardError, match="quarantined"):
        tguard.serves_oracle("matmul", (a,))


def test_a_real_failure_on_the_cpu_keeps_the_reference_fallbacks():
    """CPU tensors: the same real fault is served by the oracle once
    ``degrade`` asks for it, as in the reference."""
    tguard.configure(degrade=True)
    op = _faulty_matmul("fault")
    a, b = (_t(x) for x in _pair(16, 16, 16))
    with tapi.kernel_policy(backend="cuda", guard="shadow"):
        with pytest.warns(RuntimeWarning, match="quarantined"):
            out = op(a, b)
        assert torch.equal(op(a, b), out)
    assert torch.equal(out, tref.matmul_ref(a, b)) and tguard.metrics().degraded_calls == 2


# ---------------------------------------------------------------------------
# probes, attribution, the verify sweep
# ---------------------------------------------------------------------------
def test_probe_and_attribution_target_the_faulty_op_only_as_the_reference():
    def events(guard):
        seen = [guard.probe("matmul"), guard.probe("axpy")]
        guard.inject_fault("axpy")
        seen += [guard.probe("axpy"), guard.attribute(), guard.is_quarantined("axpy"),
                 guard.is_quarantined("matmul"), guard.attribute()]
        guard.clear_fault("axpy")
        seen.append(guard.probe("axpy"))
        guard.revive("axpy")
        seen += [guard.is_quarantined("axpy"), guard.probe("no_such_op")]
        guard.inject_drift("no_such_op")
        seen.append(guard.probe("no_such_op"))
        summary = guard.metrics().summary()
        return seen, {k: v for k, v in summary.items() if k != "max_saturation_fraction"}

    assert events(tguard) == events(jguard)


def test_verify_ops_sweep_is_clean_and_covers_the_reference_ops():
    treports, jreports = tguard.verify_ops(), jguard.verify_ops()
    assert sorted(treports) == sorted(jreports) == ["axpy", "flash_attention", "matmul"]
    assert all(r.ok for r in treports.values())
    for name, r in treports.items():
        assert (r.shapes, r.dtype, r.checked) == (jreports[name].shapes, jreports[name].dtype,
                                                   jreports[name].checked)
        assert r.backend == tapi.default_backend(tguard.probe_device())


def test_probe_inputs_match_the_references():
    dev = torch.device("cpu")
    for name, jfactory in jguard._PROBES.items():
        (jargs, jkw), (targs, tkw) = jfactory(), tguard._PROBES[name](dev)
        assert jkw == tkw and len(jargs) == len(targs)
        for ja, ta in zip(jargs, targs):
            if isinstance(ja, np.ndarray):
                assert ta.device == dev and np.array_equal(ta.numpy(), ja)
            else:
                assert ta == ja


# ---------------------------------------------------------------------------
# policy scoping, metrics records, run --guard
# ---------------------------------------------------------------------------
def test_policy_guard_nests_inherits_and_restores():
    assert tapi.current_policy().guard is None
    with tapi.kernel_policy(guard="shadow"):
        assert tapi.current_policy().guard == "shadow"
        with tapi.kernel_policy(autotune=True):  # inherits the guard
            assert tapi.current_policy().guard == "shadow"
        with tapi.kernel_policy(guard="off"):
            assert tapi.current_policy().guard == "off"
        with pytest.raises(RuntimeError, match="boom"):
            with tapi.kernel_policy(guard="off"):
                raise RuntimeError("boom")
        assert tapi.current_policy().guard == "shadow"
    assert tapi.current_policy().guard is None


def test_guard_off_and_torch_backend_skip_all_machinery():
    a, b = (_t(x) for x in _pair(16, 16, 16))
    tguard.inject_drift("matmul", scale=0.5)
    with tapi.kernel_policy(guard="off"):
        _tcall(a, b)
    with tapi.kernel_policy(guard="shadow"):
        tapi.matmul(a, b)  # CPU tensors: the torch backend is the oracle itself
    assert tguard.metrics().checks == 0 and tguard.metrics().drift_events == 0
    assert not tguard.tracing((a, b))


def test_guard_config_validation():
    for kw, msg in (({"sample_stride": 0}, "sample_stride"), ({"on_drift": "x"}, "on_drift"),
                    ({"cooldown": 0}, "cooldown"), ({"saturation_threshold": 1.5},
                                                    "saturation_threshold"),
                    ({"probe_checks": 0}, "probe_checks"),
                    ({"max_cooldown_doublings": -1}, "max_cooldown_doublings")):
        with pytest.raises(ValueError, match=msg):
            tguard.GuardConfig(**kw)
        with pytest.raises(ValueError, match=msg):
            jguard.GuardConfig(**kw)
    # the one deliberate difference: the port re-raises a native fault by default
    assert dataclasses.asdict(tguard.GuardConfig()) == {
        **dataclasses.asdict(jguard.GuardConfig()), "degrade": False}


def test_guard_metrics_records_match_reference():
    for g in (jguard, tguard):
        m = g.metrics()
        m.checks, m.drift_events, m.faults, m.quarantines = 7, 2, 1, 3
        m.quarantined_ops.update({"matmul", "axpy"})
    want = [(r.name, r.value, r.unit, r.better, r.metrics, r.x)
            for r in jguard.metrics().to_records("guard", "guard", x="shadow")]
    got = [(r.name, r.value, r.unit, r.better, r.metrics, r.x)
           for r in tguard.metrics().to_records("guard", "guard", x="shadow")]
    assert got == want


@pytest.mark.parametrize("drift", [False, True])
def test_run_guard_exit_codes_match_reference(tmp_path, capsys, monkeypatch, drift):
    """``run --guard``: exit 0 and a clean summary line on a clean run; exit
    1 when the verify sweep sees drift (injected into both guards right after
    the run resets them)."""
    if drift:
        for g in (jguard, tguard):
            orig = g.reset

            def reset(config=None, _g=g, _orig=orig):
                st = _orig(config)
                _g.inject_drift("matmul", scale=0.5)
                return st

            monkeypatch.setattr(g, "reset", reset)
    argv = ["run", "throttle", "--guard", "shadow", "--out"]
    rc_j = jcli.main(argv + [str(tmp_path / "j.json")])
    err_j = capsys.readouterr().err
    rc_t = tcli.main(argv + [str(tmp_path / "t.json"), "--device", "cpu"])
    err_t = capsys.readouterr().err
    assert (rc_t, rc_j) == ((1, 1) if drift else (0, 0))
    line = [ln for ln in err_t.splitlines() if ln.startswith("guard[")]
    assert line == [ln for ln in err_j.splitlines() if ln.startswith("guard[")]
    assert ("drift/saturation detected" in err_t) == drift


def test_run_guard_exits_1_on_a_native_fault(tmp_path, capsys, monkeypatch):
    """A kernel op that faults in the verify sweep fails ``run --guard`` (the
    reference's gate counts only drift and saturation)."""
    orig = tguard.reset

    def reset(config=None):
        st = orig(config)
        tguard.inject_fault("matmul")
        return st

    monkeypatch.setattr(tguard, "reset", reset)
    rc = tcli.main(["run", "throttle", "--guard", "shadow", "--out", str(tmp_path / "t.json"),
                    "--device", "cpu"])
    err = capsys.readouterr().err
    line = [ln for ln in err.splitlines() if ln.startswith("guard[")]
    assert rc == 1 and "0 drift" in line[0] and "1 faults" in line[0]
    assert "faulted on a clean run" in err
