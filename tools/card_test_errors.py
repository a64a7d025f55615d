"""Pytest plugin: the worst float32 error of each card test, as a share of
its tolerance.

    python -m pytest -q -p tools.card_test_errors -m cuda tests/test_torch_cuda.py

Wraps ``torch.testing.assert_close`` for the session.  For every call on
float32 tensors it records max(|got - want| / (atol + rtol |want|)): the
share of the tolerance the worst element used (1.0 is the limit), beside
the max |got - want| and the tolerance.  At the end it prints the largest
share per test and over all, so a tolerance can be tightened from what the
card measured.  Calls on other dtypes are not recorded.
"""
from __future__ import annotations

import json

import pytest
import torch

_WORST: dict = {}
_CURRENT = {"test": None}


def _record(actual, expected, rtol, atol):
    if not (isinstance(actual, torch.Tensor) and isinstance(expected, torch.Tensor)):
        return
    if actual.dtype != torch.float32 or expected.dtype != torch.float32 or rtol is None:
        return
    a, e = actual.detach().double(), expected.detach().double().to(actual.device)
    err = (a - e).abs()
    share = float((err / (atol + rtol * e.abs())).max()) if err.numel() else 0.0
    name = _CURRENT["test"]
    best = _WORST.get(name)
    if best is None or share > best["share"]:
        _WORST[name] = {"share": share, "max_abs_err": float(err.max()) if err.numel() else 0.0,
                        "rtol": rtol, "atol": atol}


@pytest.fixture(autouse=True)
def _which_test(request):
    _CURRENT["test"] = request.node.nodeid
    yield


def pytest_configure(config):
    real = torch.testing.assert_close

    def recording(actual, expected, *args, rtol=None, atol=None, **kw):
        _record(actual, expected, rtol, atol)
        return real(actual, expected, *args, rtol=rtol, atol=atol, **kw)

    torch.testing.assert_close = recording


def pytest_terminal_summary(terminalreporter):
    if not _WORST:
        return
    worst = max(_WORST.items(), key=lambda kv: kv[1]["share"])
    terminalreporter.write_line("card_test_errors: " + json.dumps(
        {"tests": len(_WORST), "worst_test": worst[0], **worst[1]}))
    terminalreporter.write_line("card_test_errors by test: " + json.dumps(_WORST))
