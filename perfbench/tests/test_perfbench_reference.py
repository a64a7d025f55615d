"""The plain references against the program's plain path at its reduced
sizes, in float32 (a test may import both; the references import nothing of
the program)."""
import ast
from pathlib import Path

import pytest
import torch

from perfbench import weights
from perfbench.reference import moe_lm, zamba2
from perfbench.reference.common import Numerics, moe_capacity
from perfbench.tests import tiny  # noqa: F401  (puts the repository on the path)

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def test_references_import_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax", "perfbench"), \
                    f"{path.name} imports {name}"


def test_ssd_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 24, 3, 4, 5
    u = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    a = -torch.rand(b, s, h, generator=g, dtype=torch.float64)
    bm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    cm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    y, hs = zamba2.ssd_scan(u, a, bm, cm, chunk=8)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    for t in range(s):
        state = state * torch.exp(a[:, t])[:, :, None, None] + u[:, t, :, :, None] * bm[:, t,
                                                                                     None, None]
        assert torch.allclose(y[:, t], torch.einsum("bn,bhpn->bhp", cm[:, t], state))
    assert torch.allclose(hs, state)


def _program(name, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(name).reduced().replace(**kw)
    model = build_model(cfg, device="cpu")
    params = weights.build(weights.layout(model.init), 5, "cpu")
    return cfg, model, params


def _sizes(cfg, extra=()):
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
            "n_experts", "experts_per_token", "capacity_factor", "moe_aux_coef", "norm_eps",
            "rope_theta", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv_width",
            "ssm_chunk", "mlp_variant") + tuple(extra)
    return {k: getattr(cfg, k) for k in keys if hasattr(cfg, k)}


def test_moe_reference_equals_the_programs_forward():
    from repro_torch.models.transformer import lm_forward

    cfg, _, params = _program("olmoe-1b-7b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, want_aux = lm_forward(params, tokens, cfg)
        groups = torch.arange(2).repeat_interleave(40)
        caps = torch.full((2,), moe_capacity(40, cfg.experts_per_token, cfg.capacity_factor,
                                             cfg.n_experts))
        got, aux = moe_lm.forward(Numerics(), params, tokens, _sizes(cfg), groups, caps)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(aux, want_aux / cfg.n_layers, atol=1e-6)


def test_moe_reference_drops_past_capacity_as_the_program():
    from repro_torch.models import mlp as port_mlp

    cfg, _, params = _program("olmoe-1b-7b", capacity_factor=0.5)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator().manual_seed(2))
    cap = port_mlp.moe_capacity(cfg, 64)
    with torch.no_grad():
        want, _ = port_mlp.moe_block(layer, x, cfg)
        assert int(port_mlp.moe_drop_count(layer, x, cfg)) > 0  # the case is exercised
        got, _ = moe_lm.moe_layer(Numerics(), layer, x[0], _sizes(cfg), torch.zeros(64).long(),
                                  torch.tensor([cap]))
    assert torch.allclose(got, want[0], atol=1e-5)


def test_zamba2_reference_equals_the_programs_prefill():
    cfg, model, params = _program("zamba2-7b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len=48)
    seen = []

    def visit(kind, i, a, b):
        if kind == "kv":
            assert torch.allclose(cache["k"][i], a, atol=1e-4)
            assert torch.allclose(cache["v"][i], b, atol=1e-4)
        else:
            assert torch.allclose(cache["ssm"][i], a, atol=1e-4)
            assert torch.allclose(cache["conv"][i], b, atol=1e-4)
        seen.append(kind)

    per = cfg.macro_size * cfg.attn_every_k_macro
    sizes = _sizes(cfg)
    got = zamba2.prefill(Numerics(), params, tokens, sizes, visit)
    assert torch.allclose(got, logits, atol=1e-4)
    assert seen.count("ssm") == cfg.n_layers and seen.count("kv") == -(-cfg.n_layers // per)


@pytest.mark.parametrize("quant", [False, True])
def test_numerics_float8_rounds_each_operand(quant):
    from perfbench.reference.common import fake_fp8

    x = torch.linspace(-3, 3, 101)
    q = fake_fp8(x)
    assert (q - x).abs().max() <= 3 / 448 * 16  # e4m3: 3 mantissa bits
    assert torch.equal(fake_fp8(q), q)
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    got = Numerics(quant).einsum("ij,jk->ik", a, b)
    want = (fake_fp8(a) @ fake_fp8(b)) if quant else a @ b
    assert torch.allclose(got, want, atol=1e-6)
