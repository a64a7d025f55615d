"""The launch geometry of the axpy and stream_copy kernels, on the CPU.

``axpy_geometry`` and ``copy_plan`` are the Python that sets each launch;
the CUDA kernels (``csrc/axpy.cu``, ``csrc/membw.cu``) run only on the card.
These tests hold the geometry to what the kernels assume, at the block-shape
probe's shapes, the Fig 1.1 sweep's shape and awkward ones: every vector or
byte is covered exactly once, a block has at most 1024 threads, the copy
moves whole 16-byte vectors and leaves fewer than 16 tail bytes, and the
axpy unroll is the same at every access width.  The axpy test also
walks each thread's offsets the way the kernel does (adds, one wrap per tile
row crossed) and checks that they land on the tile's vectors."""
import pytest

from repro_torch.kernels.axpy import AXPY_MAX_THREADS, VEC_BYTES, axpy_geometry
from repro_torch.kernels.membw import (
    COPY_BLOCKS_PER_SM, COPY_ROUND_BYTES, COPY_THREADS, COPY_UNROLL, copy_plan,
)

# (shape, block_rows, block_cols): the probe's 1 MiB arrays at each tile width
# (core/probes.py::probe_block_shape_bandwidth), the sweep's 256 MiB arrays,
# then tiles of odd vector counts, one row, and many rounds
AXPY_CASES = [(((1 << 20) // (4 * c), c), 8, c) for c in (128, 256, 512, 1024, 2048)] + [
    ((32768, 2048), 8, 2048),
    ((6, 2 * 6008), 3, 6008),
    ((10, 96), 5, 48),
    ((1, 64), 1, 64),
    ((16, 65536), 8, 65536),
]


def _walk(geo, tile_vecs: int, row_vecs: int, cols: int, nv: int) -> list:
    """The element offsets, within a tile at offset 0, of every vector the
    kernel's threads touch, found as csrc/axpy.cu::axpy_kernel finds them."""
    step = geo.threads
    drow, dcol = divmod(step, row_vecs)
    doff, wrap = drow * cols + dcol * nv, cols - row_vecs * nv
    offs = []
    for t in range(geo.threads):
        v, col = t, t % row_vecs
        off = (t // row_vecs) * cols + col * nv
        for _ in range(geo.rounds * geo.unroll):
            if v < tile_vecs:
                offs.append(off)
            v, col, off = v + step, col + dcol, off + doff
            if col >= row_vecs:
                col, off = col - row_vecs, off + wrap
    return offs


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("vec_bytes", VEC_BYTES)
@pytest.mark.parametrize("shape,block_rows,block_cols", AXPY_CASES)
def test_axpy_geometry_covers_each_vector_once(shape, block_rows, block_cols, vec_bytes,
                                               itemsize):
    geo = axpy_geometry(shape, block_rows, block_cols, vec_bytes, itemsize)
    nv = vec_bytes // itemsize
    row_vecs = block_cols // nv
    tile_vecs = block_rows * row_vecs
    assert geo.ctas == (shape[0] // block_rows) * (shape[1] // block_cols)
    assert 32 <= geo.threads <= AXPY_MAX_THREADS and geo.threads % 32 == 0
    per_round = geo.threads * geo.unroll
    assert geo.rounds * per_round >= tile_vecs > (geo.rounds - 1) * per_round  # no empty round
    if geo.threads < AXPY_MAX_THREADS:  # then one round, with at most one idle warp's vectors
        assert geo.rounds == 1 and per_round - tile_vecs < 32 * geo.unroll
    if tile_vecs * nv <= 1 << 16:  # the walk itself, where it is quick
        offs = _walk(geo, tile_vecs, row_vecs, shape[1], nv)
        want = [r * shape[1] + c * nv for r in range(block_rows) for c in range(row_vecs)]
        assert sorted(offs) == want


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape,block_rows,block_cols", AXPY_CASES)
def test_axpy_unroll_is_the_same_at_every_width(shape, block_rows, block_cols, itemsize):
    """The unroll is the sweep's constant: bytes in flight scale with the
    access width, which stays the experiment's only variable."""
    unrolls = {axpy_geometry(shape, block_rows, block_cols, vb, itemsize).unroll
               for vb in VEC_BYTES}
    assert len(unrolls) == 1


def _rounds(plan) -> list:
    """(start, stop) bytes of each block's rounds, block by block, taken as
    csrc/membw.cu::copy_kernel takes them: a grid stride of rounds."""
    step = plan.threads * plan.unroll * 16
    return [[(b, min(b + step, plan.bulk_bytes))
             for b in range(c * step, plan.bulk_bytes, plan.ctas * step)]
            for c in range(plan.ctas)]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("nbytes", [
    0, 8, 16, 96000, COPY_ROUND_BYTES - 48, COPY_ROUND_BYTES, COPY_ROUND_BYTES + 16,
    3 * COPY_ROUND_BYTES + 12, 300 * COPY_ROUND_BYTES + 6, 128 << 20, (256 << 20) + 4,
])
def test_copy_plan_covers_each_byte_once(nbytes, sms):
    plan = copy_plan(nbytes, sms)
    assert plan.bulk_bytes % 16 == 0 and plan.threads * plan.unroll * 16 == COPY_ROUND_BYTES
    assert 0 <= plan.tail_bytes < 16 and plan.bulk_bytes + plan.tail_bytes == nbytes
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert 1 <= plan.ctas <= COPY_BLOCKS_PER_SM * sms
    per_block = _rounds(plan)
    assert len(per_block) == plan.ctas
    assert all(per_block) or plan.bulk_bytes == 0  # no idle block
    pieces = sorted(r for block in per_block for r in block)
    assert [p[0] for p in pieces] == list(range(0, plan.bulk_bytes, COPY_ROUND_BYTES))
    for (_, stop), (start, _) in zip(pieces, pieces[1:]):
        assert stop == start  # each 16 bytes in one round of one block
    assert not pieces or pieces[-1][1] == plan.bulk_bytes
    assert all(stop - start == COPY_ROUND_BYTES for start, stop in pieces[:-1])


@pytest.mark.parametrize("sms", [132, 7])
def test_copy_plan_unroll_is_the_kernels(sms):
    """Every size takes the kernel's one unroll and block size; the grid
    grows with the size up to COPY_BLOCKS_PER_SM blocks an SM."""
    plans = [copy_plan(n, sms) for n in (16, 1 << 20, 1 << 30)]
    assert {(p.threads, p.unroll) for p in plans} == {(COPY_THREADS, COPY_UNROLL)}
    assert [p.ctas for p in plans] == [1, min(256, COPY_BLOCKS_PER_SM * sms),
                                      COPY_BLOCKS_PER_SM * sms]
