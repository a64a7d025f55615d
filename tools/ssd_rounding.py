"""How rounding the SSD scan's fp32 intermediates to bf16 moves y's rows.

    PYTHONPATH=src python tools/ssd_rounding.py [--seed 0] [--heads 24]

The ssm_scan kernel's wgmma route feeds three fp32 values to bf16 tensor-core
products: W (the decay-masked scores), sdecay * B (the chunk states' operand)
and h (the state entering a chunk).  This runs the plain chunked SSD of
``repro_torch.kernels.ref`` on the CPU with those values rounded as a kernel
would round them (once to bf16, or as a bf16 hi + lo pair), at zamba2-7b's
widths (P = N = 64, S 1024) on a few heads, and prints the largest row error
||y - y_fp32|| / ||y_fp32|| of the bf16 output over the rows, beside y's own
rounding, at the init's decay and at a slow one, chunks 256 and 512.
``chip_smoke.py`` holds the kernel's rows within about twice y's own rounding.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

BF16 = torch.bfloat16
SHIFTS = {"init's decay": 0.0, "slow decay": -5.0}  # a_log = -softplus(N(shift, 1))


def rounded(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x rounded to bf16 once, or as hi + lo (hi = bf16(x), lo = bf16(x - hi))."""
    hi = x.to(BF16).float()
    return hi + (x - hi).to(BF16).float() if split else hi


def ssd_rounded(u, a_log, b, c, chunk, split_w: bool, split_state: bool) -> torch.Tensor:
    """ref.ssd_chunked_ref's y with W rounded (split_w: as a pair) and sdecay B
    and h rounded (split_state: as pairs), the products in fp32."""
    bsz, s, h, p = u.shape
    nc, n = s // chunk, b.shape[-1]
    acum = torch.cumsum(a_log.reshape(bsz, nc, chunk, h), dim=2)  # (B, nc, L, H)
    sdecay = torch.exp((acum[:, :, -1:] - acum).clamp(-60.0, 0.0))
    bs = rounded(sdecay[..., None] * b.float().reshape(bsz, nc, chunk, 1, n), split_state)
    states = torch.einsum("bclhp,bclhn->bhcpn", u.float().reshape(bsz, nc, chunk, h, p), bs)
    acum = acum.permute(0, 3, 1, 2).reshape(bsz, h, s)
    entering, _ = ref.ssd_pass_states(states.contiguous(), acum, chunk)
    entering = rounded(entering, split_state)
    bf, cf = (x.float().reshape(bsz, nc, chunk, n) for x in (b, c))
    ac = acum.reshape(bsz, h, nc, chunk)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    dd = (ac[..., :, None] - ac[..., None, :]).clamp(-60.0, 0.0)
    w = rounded(torch.einsum("bctn,bcsn->bcts", cf, bf)[:, None] * torch.exp(dd) * tri, split_w)
    y = torch.einsum("bhcts,bcshp->bcthp", w, u.float().reshape(bsz, nc, chunk, h, p))
    y = y + torch.einsum("bctn,bhcpn->bcthp", cf, entering) * \
        torch.exp(ac).permute(0, 2, 3, 1)[..., None]
    return y.reshape(bsz, s, h, p)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--heads", type=int, default=24)
    args = parser.parse_args(argv)
    gen = torch.Generator().manual_seed(args.seed)
    bsz, s, p, n = 2, 1024, 64, 64
    variants = {"W once": (False, True), "state once": (True, False), "all pairs": (True, True)}
    for name, shift in SHIFTS.items():
        a = -F.softplus(torch.randn((bsz, s, args.heads), generator=gen) + shift)
        u = (torch.randn((bsz, s, args.heads, p), generator=gen) * 0.5).to(BF16)
        b, c = ((torch.randn((bsz, s, n), generator=gen) * 0.5).to(BF16) for _ in range(2))
        for chunk in (256, 512):
            want, _ = ref.ssd_chunked_ref(u, a, b, c, chunk)
            errs = {"y's own rounding": row_rel_err(want.to(BF16), want)}
            for label, (split_w, split_state) in variants.items():
                got = ssd_rounded(u, a, b, c, chunk, split_w, split_state).to(BF16)
                errs[label] = row_rel_err(got, want)
            print(f"{name}, chunk {chunk}, {bsz * s * args.heads} rows: " +
                  ", ".join(f"{k} {v:.4e}" for k, v in errs.items()), flush=True)


if __name__ == "__main__":
    main()
