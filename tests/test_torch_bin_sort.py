"""The bin sort (``binning.bin_sort``, kernel ``csrc/sort.cu``) of both
sort layouts, and the deferred mode's vertex stage
(``texture.vertex_stage``, kernel ``vertex_stage_kernel`` of
``csrc/texture.cu``), against their plain versions and the JAX package.

- The kernel's decomposition written in torch
  (``binning.bin_sort_steps_plain``: table chunks, each one's count of
  each bin, the (bin, table chunk) scan, each chunk sorted by bin as the
  kernel sorts it and each pair placed at its bin's base in the table
  chunk, plus the bin's pairs ahead of the chunk there, plus its rank in
  the chunk) against the twin ``bin_sort_plain`` (a stable
  ``torch.sort`` and searchsorted): ``pair_tri`` bitwise on the valid
  prefix, every other output bitwise, on random rects of both layouts, a
  segment of ``LONG`` pairs, an empty frame, and pair and tile overflow,
  at two chunk widths (16, so that every case crosses many chunks, and
  the kernel's, ``SORT_CHUNK``).
- The in-chunk sort on its own (``binning.sort_chunk_plain``, the
  kernel's radix passes, and ``run_ranks_plain``) against a stable
  ``torch.sort``: long runs, one bin, every key distinct, keys out of
  range, one and two passes.
- ``bin_cells_sort_meta`` (the micro layout) and ``bin_triangles_sort``
  (the flat layout, as ``bin_tiles_meta`` reaches it) on CPU tensors
  against the JAX package's ``binning.bin_cells_sort_meta`` /
  ``bin_triangles_sort`` and ``pallas_raster.occupied_worklist``: bitwise
  on the valid prefix of ``pair_tri`` and on every segment, capacity and
  work-list output.
- ``texture.vertex_stage`` on CPU tensors (``common.vertex_stage``)
  against the JAX package's ``common.vertex_stage`` run op by op
  (``jax.disable_jit()``): bitwise without the wave; with it within 1e-6
  world units and 1e-4 in screen space, absolute (the two libraries'
  sinf differ in the last bit).

The ``cuda``-marked tests hold each kernel to its twin on the card,
bitwise, and skip here. Cases are made from numpy seeds.
"""

import numpy as np
import pytest

from tests.torch_bin_cases import (
    LONG, MICRO_SORT_CASES as MICRO_CASES, NTX_T, NTY_T, SORT_CASES,
    sort_case, sort_pairs,
)
from tests.torch_parity import cuda_device, port, tpu  # noqa: F401

CASES = ([("micro", n) for n in MICRO_CASES]
         + [("flat", n) for n in SORT_CASES])


def _sort_inputs(port, layout, name, device="cpu"):
    """(keys, tris, total, num_bins, kwargs of bin_sort) on ``device``."""
    t = port.torch
    meta, ntx, nty, pair_cap, cap = sort_case(layout, name)
    num_bins = ntx * nty
    keys, tris, total = sort_pairs(meta, ntx, num_bins, pair_cap)
    kw = (dict(group=16) if layout == "micro"
          else dict(cap=cap, meta=t.from_numpy(meta).to(device), ntx=ntx))
    return (t.from_numpy(keys).to(device), t.from_numpy(tris).to(device),
            t.tensor(total, dtype=t.int32).to(device), num_bins, kw)


def _assert_bins(a, b, n, what):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for key in a:
        x = a[key][:n] if key == "pair_tri" else a[key]
        y = b[key][:n] if key == "pair_tri" else b[key]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, key)
        assert bool((x.cpu() == y.cpu()).all()), (what, key)


def _exact(port, kw, num_bins):
    """What bin_sort hands its twin as the flat layout's exact counts."""
    if "meta" not in kw:
        return None
    b = port.binning
    return b.exact_tile_counts(b.setup_from_meta(kw["meta"]), kw["ntx"],
                               num_bins // kw["ntx"])


@pytest.mark.parametrize("chunk,wide", [(16, 64), (2048, 0)])
@pytest.mark.parametrize("layout,name", CASES)
def test_sort_steps_equal_stable_sort(port, layout, name, chunk, wide):
    # Tolerance: none; integers. Chunks of 16 slots in table chunks of 64
    # cross many of both; 2048 is the kernel's chunk, in its table chunk.
    keys, tris, total, num_bins, kw = _sort_inputs(port, layout, name)
    b = port.binning
    twin = b.bin_sort(keys, tris, total, num_bins, **kw)
    n = min(int(total), keys.shape[0])
    steps = b.bin_sort_steps_plain(
        keys, tris, total, num_bins, group=kw.get("group", 1),
        cap=kw.get("cap", b.CAP_NONE), exact=_exact(port, kw, num_bins),
        chunk=chunk, wide=wide)
    _assert_bins(twin, steps, n, (layout, name, chunk))
    counts = twin["seg_count"]
    if name == "long":
        assert int(counts.max()) >= LONG > chunk
    if name == "empty":
        assert int(twin["k"]) == 0 and int(twin["total_pairs"]) == 0
    if name == "pair_overflow":
        assert int(twin["pair_needed"]) == int(total) > keys.shape[0]
    if name == "tile_overflow":
        assert int(twin["tile_needed"]) > kw["cap"] == int(counts.max())


def _chunk_keys(name, rng):
    """(keys, span) of an in-chunk sort case: keys rebased to the chunk's
    lowest bin, span the chunk's range of bins."""
    if name == "runs":  # long runs of few bins, then a tail of many
        keys = np.repeat(rng.integers(0, 40, 60), rng.integers(1, 200, 60))
        return np.concatenate([keys, rng.integers(0, 40, 300)]), 40
    if name == "one_bin":
        return np.full(3000, 0), 1
    if name == "distinct":
        return rng.permutation(12288)[:2048], 12288
    if name == "out_of_range":  # become span and sort last
        return rng.integers(-3, 600, 2000), 512
    if name == "two_passes":
        return rng.integers(0, 12288, 2048), 12288
    raise KeyError(name)


@pytest.mark.parametrize("name", ["runs", "one_bin", "distinct",
                                  "out_of_range", "two_passes"])
def test_sort_chunk_plain(port, name):
    # The in-chunk rank step on its own, against a stable torch.sort.
    t = port.torch
    b = port.binning
    keys, span = _chunk_keys(name, np.random.default_rng(len(name)))
    k = t.from_numpy(keys.astype(np.int64))
    vals = t.arange(k.shape[0], dtype=t.int32)
    for warps in (1, b.SORT_WARPS):
        sk, sv = b.sort_chunk_plain(k, vals, span, warps)
        clean = t.where((k >= 0) & (k < span), k, span)
        want_k, order = t.sort(clean, stable=True)
        assert t.equal(sk, want_k) and t.equal(sv, vals[order]), (name,
                                                                  warps)
    rank = b.run_ranks_plain(sk)
    first = {}
    for q, key in enumerate(sk.tolist()):
        first.setdefault(key, q)
        assert int(rank[q]) == q - first[key]


@pytest.mark.parametrize("name", MICRO_CASES)
def test_bin_cells_sort_meta_vs_jax(port, tpu, name):
    meta, ntx, nty, pair_cap, _ = sort_case("micro", name)
    t = port.torch
    rows = [meta[i] for i in (3, 2, 0, 1)]
    a = tpu.binning.bin_cells_sort_meta(
        *(tpu.jnp.asarray(r) for r in rows), NTX_T, NTY_T, pair_cap,
        interpret=True, use_pallas_expand=False)
    wa, ka = tpu.pallas_raster.occupied_worklist(a["tile_count"])
    b = port.binning.bin_cells_sort_meta(*(t.from_numpy(r) for r in rows),
                                         NTX_T, NTY_T, pair_cap)
    assert b["layout"] == "micro"
    n = min(int(a["total_pairs"]), pair_cap)
    np.testing.assert_array_equal(np.asarray(a["pair_tri"])[:n],
                                  b["pair_tri"].numpy()[:n])
    for key in ("seg_start", "seg_count", "win_start", "tile_count",
                "total_pairs", "pair_needed", "tile_needed"):
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(np.asarray(wa), b["worklist"].numpy())
    assert int(ka) == int(b["k"])
    assert b["overflow"].tolist() == [int(a["pair_needed"]), 0]


@pytest.mark.parametrize("name", SORT_CASES)
def test_bin_triangles_sort_vs_jax(port, tpu, name):
    meta, ntx, nty, pair_cap, cap = sort_case("flat", name)
    t = port.torch
    a = tpu.binning.bin_triangles_sort(
        tpu.binning.setup_from_meta(tpu.jnp.asarray(meta)), ntx, nty,
        pair_cap, cap)
    wa, ka = tpu.pallas_raster.occupied_worklist(a["seg_count"])
    b = port.binning.bin_triangles_sort(
        port.binning.setup_from_meta(t.from_numpy(meta)), ntx, nty, pair_cap,
        cap)
    n = min(int(a["total_pairs"]), pair_cap)
    np.testing.assert_array_equal(np.asarray(a["pair_tri"])[:n],
                                  b["pair_tri"].numpy()[:n])
    for key in ("seg_start", "seg_count", "total_pairs", "pair_needed",
                "tile_needed"):
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    wb, kb = port.binning.occupied_worklist(b["seg_count"])
    np.testing.assert_array_equal(np.asarray(wa), wb.numpy())
    assert int(ka) == int(kb)


def _vertex_inputs(wave):
    rng = np.random.default_rng(11)
    pos = rng.uniform(-2, 2, (900, 3)).astype(np.float32)
    vp = np.eye(4, dtype=np.float32)
    vp[:3, :3] = rng.uniform(-1, 1, (3, 3))
    vp[2, 3], vp[3, 2], vp[3, 3] = -0.2, -1.0, 3.0
    eff = np.zeros(6, np.float32)
    if wave is not None:
        eff[:5] = [1.0, 0.4, 3.0, 2.0, wave]  # 0 vertical, 1, 2 radial
    return pos, vp, eff


@pytest.mark.parametrize("wave", [None, 0.0, 1.0, 2.0])
def test_vertex_stage_vs_jax(port, tpu, wave):
    pos, vp, eff = _vertex_inputs(wave)
    with tpu.jax.disable_jit():
        wa, sa = tpu.common.vertex_stage(*(tpu.jnp.asarray(a) for a in
                                           (pos, vp, eff)), 160, 120)
    from compute_renderer_torch.backends import texture

    t = port.torch
    wb, sb = texture.vertex_stage(*(t.from_numpy(a) for a in (pos, vp, eff)),
                                  160, 120)
    assert wb.shape == (900, 3) and sb.shape == (900, 4)
    for a, b, atol in ((wa, wb, 1e-6), (sa, sb, 1e-4)):
        if wave is None:  # bitwise
            np.testing.assert_array_equal(
                np.asarray(a, np.float32).view(np.int32),
                b.numpy().view(np.int32))
        else:
            # XLA:CPU's sinf and torch's differ in the last bit: an absolute
            # bound, since a world coordinate near 0 (x + dx cancelling)
            # makes that bit many ULPs of the result. 1e-6 world units
            # (positions within 2, a wave of 0.4), 1e-4 px in screen.
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=atol)


# ---------------------------------------------------------------------------
# The kernels against their twins, on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout,name", CASES)
def test_card_bin_sort_matches_twin(port, cuda_device, layout, name):
    keys, tris, total, num_bins, kw = _sort_inputs(port, layout, name,
                                                   cuda_device)
    b = port.binning
    before = port.tracing.count("launches.bin_sort")
    got = b.bin_sort(keys, tris, total, num_bins, **kw)
    assert port.tracing.count("launches.bin_sort") == before + 1
    want = b.bin_sort_plain(keys, tris, total, num_bins,
                            group=kw.get("group", 1),
                            cap=kw.get("cap", b.CAP_NONE),
                            exact=_exact(port, kw, num_bins))
    port.torch.cuda.synchronize()
    _assert_bins(want, got, min(int(total), keys.shape[0]), (layout, name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SORT_CASES)
def test_card_bin_tiles_meta_flat_matches_twin(port, cuda_device, name):
    # The flat layout's card path (the expansion in row-major tile ids,
    # then the bin sort) called directly, so that a small tile cap
    # overflows; then the public wrapper's pick of it above the dense
    # rule's limit.
    meta, ntx, nty, pair_cap, cap = sort_case("flat", name)
    b = port.binning
    m = port.torch.from_numpy(meta).to(cuda_device)
    before = port.tracing.count("launches.bin_sort")
    got = b._bin_tiles_flat_cuda(m, ntx, nty, pair_cap, cap)
    want = b._with_worklist(b.bin_triangles_sort(b.setup_from_meta(m), ntx,
                                                 nty, pair_cap, cap))
    assert got["layout"] == want["layout"] == "flat"
    assert port.tracing.count("launches.bin_sort") == before + 1
    n = min(int(want["total_pairs"]), pair_cap)
    _assert_bins({k: v for k, v in want.items() if k != "layout"},
                 {k: v for k, v in got.items() if k != "layout"}, n, name)
    big = b.DENSE_BINNING_OP_LIMIT // (ntx * nty * meta.shape[1]) + 8
    public = b.bin_tiles_meta(m, ntx, nty, pair_cap, big)
    assert public["layout"] == "flat"
    assert port.tracing.count("launches.bin_sort") == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", MICRO_CASES)
def test_card_bin_cells_sort_meta_matches_twin(port, cuda_device, name):
    meta, _, _, pair_cap, _ = sort_case("micro", name)
    t = port.torch
    rows = [t.from_numpy(meta[i]) for i in (3, 2, 0, 1)]
    got = port.binning.bin_cells_sort_meta(
        *(r.to(cuda_device) for r in rows), NTX_T, NTY_T, pair_cap)
    want = port.binning.bin_cells_sort_meta(*rows, NTX_T, NTY_T, pair_cap)
    n = min(int(want["total_pairs"]), pair_cap)
    _assert_bins({k: v for k, v in want.items() if k != "layout"},
                 {k: v for k, v in got.items() if k != "layout"}, n, name)


@pytest.mark.cuda
@pytest.mark.parametrize("wave", [None, 0.0, 1.0, 2.0])
def test_card_vertex_stage_matches_twin(port, cuda_device, wave):
    from compute_renderer_torch.backends import texture

    t = port.torch
    args = [t.from_numpy(a).to(cuda_device) for a in _vertex_inputs(wave)]
    before = port.tracing.count("launches.vertex_stage")
    wk, sk = texture.vertex_stage(*args, 160, 120)
    wp, sp = port.common.vertex_stage(*args, 160, 120)
    assert port.tracing.count("launches.vertex_stage") == before + 1
    assert t.equal(wk.view(t.int32), wp.view(t.int32))
    assert t.equal(sk.view(t.int32), sp.view(t.int32))
