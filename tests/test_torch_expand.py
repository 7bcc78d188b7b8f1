"""Pair expansion (backends/expand.py) against the JAX package, bitwise.

The same numpy cover meta goes into ``pallas_expand.expand_cells``
(interpret mode), the XLA branch of ``binning.expand_cells_meta`` and the
port's ``expand_cells_plain``. The contract (tests/test_expand_kernel.py:
66-72): cell and triangle ids bitwise on [0, min(total, pair_cap)), the
``num_cells`` sentinel in every cell slot beyond, ``total`` exact even
when it exceeds ``pair_cap``. Besides the seven cases of the JAX
package's own tests: T one past a block of the CUDA kernel (``expand.TRIS``
triangles) and one a few past two, and the uneven case of one triangle
owning 40,000 cells among 4,096 single-cell triangles, within and past
``pair_cap``. T = 0, which neither JAX branch takes (their kernels index
an empty array), is held to the contract alone. The CUDA kernel is held
against the twin only where a card exists."""

import os
import re

import numpy as np
import pytest

from tests.torch_parity import cuda_device, port, tpu  # noqa: F401 (fixtures)

NTX_T, NTY = 8, 96
NUM_CELLS = NTX_T * NTY * 16

# The seven cases of tests/test_expand_kernel.py:33-44.
CASES = [
    (1000, 2, 2048, 0),
    (5000, 3, 8192, 1),
    (3000, 0, 2048, 2),   # everything culled
    (2000, 8, 4096, 3),   # bigger rects
    (4000, 3, 1024, 4),   # overflow: total > cap
    (1024, 2, 2048, 5),   # exact block multiple
    (7, 30, 1024, 6),     # tiny T, large counts
    (1025, 3, 2048, 7),   # one past a CUDA block (expand.TRIS)
    (4101, 3, 8192, 8),   # not a multiple of the block size
    (4097, None, 45056, 9),   # one c = 40,000 among 4,096 c = 1
    (4097, None, 40960, 10),  # the same, total > pair_cap inside it
]


def _meta(T, max_c, seed):
    """(c, rx, x0, y0) as tests/test_expand_kernel.py draws them; for
    ``max_c`` None, T - 1 single-cell triangles and, at a seeded place, one
    whose 200 x 200 cell rectangle holds 40,000 cells."""
    r = np.random.default_rng(seed)
    if max_c is None:
        c = np.ones(T, np.int32)
        rx = np.ones(T, np.int32)
        x0 = r.integers(0, NTX_T * 16, size=T).astype(np.int32)
        y0 = r.integers(0, NTY, size=T).astype(np.int32)
        big = int(r.integers(0, T))
        c[big], rx[big], x0[big], y0[big] = 40_000, 200, 3, 1
        return c, rx, x0, y0
    c = r.integers(0, max_c + 1, size=T).astype(np.int32)
    c[r.random(T) < 0.4] = 0
    rx = np.clip(r.integers(1, 5, size=T), 1, None).astype(np.int32)
    x0 = r.integers(0, NTX_T * 16 - 4, size=T).astype(np.int32)
    y0 = r.integers(0, NTY - 4, size=T).astype(np.int32)
    return c, rx, x0, y0


def _port_expand(port, meta, cap, device="cpu", fn=None):
    t = port.torch
    fn = fn or port.expand.expand_cells
    cell, tri, total = fn(*[t.from_numpy(a).to(device) for a in meta],
                          pair_cap=cap, ntx_t=NTX_T, num_cells=NUM_CELLS)
    assert cell.dtype == t.int32 and tri.dtype == t.int32
    assert cell.shape == (cap,) and tri.shape == (cap,)
    return cell.cpu().numpy(), tri.cpu().numpy(), int(total)


def _check(a, b, cap):
    """a, b: (cell, tri, total); b is held to a's contract."""
    assert b[2] == a[2]
    n = min(a[2], cap)
    np.testing.assert_array_equal(b[0][:n], a[0][:n])
    np.testing.assert_array_equal(b[1][:n], a[1][:n])
    assert (b[0][n:] == NUM_CELLS).all()


@pytest.mark.parametrize("T,max_c,cap,seed", CASES)
def test_twin_vs_pallas_expand(port, tpu, T, max_c, cap, seed):
    meta = _meta(T, max_c, seed)
    a = tpu.pallas_expand.expand_cells(
        *[tpu.jnp.asarray(m) for m in meta], pair_cap=cap, ntx_t=NTX_T,
        num_cells=NUM_CELLS, interpret=True)
    a = (np.asarray(a[0]), np.asarray(a[1]), int(a[2]))
    assert (a[0][min(a[2], cap):] == NUM_CELLS).all()
    _check(a, _port_expand(port, meta, cap), cap)


@pytest.mark.parametrize("T,max_c,cap,seed", CASES)
def test_twin_vs_xla_branch(port, tpu, T, max_c, cap, seed):
    meta = _meta(T, max_c, seed)
    a = tpu.binning.expand_cells_meta(
        *[tpu.jnp.asarray(m) for m in meta], NTX_T, NUM_CELLS, cap,
        interpret=True, use_pallas_expand=False)
    a = (np.asarray(a[0]), np.asarray(a[1]), int(a[2]))
    b = _port_expand(port, meta, cap)
    _check(a, b, cap)
    # The twin and the XLA branch agree on the tail's triangle ids too.
    np.testing.assert_array_equal(b[1], a[1])


def test_binning_dispatches_to_expand(port):
    # binning.expand_cells_meta is the expansion the micro binning runs;
    # CPU tensors take the twin and launch nothing.
    t = port.torch
    meta = _meta(500, 3, 9)
    before = port.tracing.count("launches.expand_cells")
    a = port.binning.expand_cells_meta(*[t.from_numpy(m) for m in meta],
                                       NTX_T, NUM_CELLS, 1024)
    b = _port_expand(port, meta, 1024, fn=port.expand.expand_cells_plain)
    assert port.tracing.count("launches.expand_cells") == before
    _check(b, (a[0].numpy(), a[1].numpy(), int(a[2])), 1024)


def test_block_size_is_the_kernels(port):
    # The wrapper sizes the kernel's block-sum scratch by the source's
    # block: THREADS x ITEMS triangles.
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "compute_renderer_torch", "csrc",
        "expand.cu")
    with open(path) as fh:
        text = fh.read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       text).group(1))
    assert port.expand.TRIS == const("THREADS") * const("ITEMS")


def test_empty_and_other_devices(port):
    t = port.torch
    z = np.zeros((0,), np.int32)
    cell, tri, total = _port_expand(port, (z, z, z, z), 64)
    assert total == 0 and (cell == NUM_CELLS).all() and (tri == 0).all()
    meta = [t.from_numpy(m).to("meta") for m in _meta(10, 2, 0)]
    with pytest.raises(ValueError, match="no kernel"):
        port.expand.expand_cells(*meta, pair_cap=64, ntx_t=NTX_T,
                                 num_cells=NUM_CELLS)


@pytest.mark.cuda
@pytest.mark.parametrize("T,max_c,cap,seed", CASES + [(0, 2, 1024, 11)])
def test_kernel_vs_twin_on_card(port, cuda_device, T, max_c, cap, seed):
    meta = _meta(T, max_c, seed)
    before = port.tracing.count("launches.expand_cells")
    k = _port_expand(port, meta, cap, device=cuda_device)
    assert port.tracing.count("launches.expand_cells") == before + 1
    p = _port_expand(port, meta, cap, fn=port.expand.expand_cells_plain)
    _check(p, k, cap)
    # The kernel writes triangle 0 in the tail.
    assert (k[1][min(k[2], cap):] == 0).all()
