"""The port's own spans and counters, in one place.

- ``span(name)``: a ``torch.profiler`` range while a profiler session is
  recording (torch's own flag), else one shared null context: off a
  session a span costs one flag check, allocates nothing and creates no
  ``RecordFunction``. The ranges land in the same trace as the card's
  kernels, copies and runtime calls, on its clock, so any
  ``torch.profiler`` session (``bench/profiling.trace``, the benchmark's
  traced window) shows them; there is no exporter here.
- Host counters (``counters()``): ints, always on, ticked only at rare
  events: graph ``captures``, ``graph_drops``, ``retries`` (a capacity
  growth after an overflow), ``calibrations``, ``tunes``, ``replays``,
  ``stage.grows`` (a batch's staging buffer allocated or grown) and
  ``stage.waits`` (a refill of one that had to wait for the card), and
  the kernel wrappers' calls as ``launches.<wrapper>`` and
  ``launches.<wrapper>.<mode>`` (a graph's capture and its eager warm-up
  tick them, a replay does not).
- Device frame counts (``frame_counts()``): the frames of the renderer's
  batches rendered while a profiler session was recording, the pairs and
  occupied tiles their bin kernels counted on the card, the coverage
  samples the micro raster tested, the pixels the mip texture tail
  shaded from an image, and on the tile path the tile raster's span
  blocks beyond each tile's first.
- Device frame peaks (``frame_peaks()``): over the same frames, the
  longest bin list the binning's scan kernels found: the triangles of
  the tile whose list the tile raster's last block walks, or on the
  micro path an 8x8 cell's pairs.

Depends on nothing else of the package.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

# The host events of ``counters()``, present from the start.
EVENTS = ("captures", "graph_drops", "retries", "calibrations", "tunes",
          "replays", "stage.grows", "stage.waits")

_NULL_SPAN = contextlib.nullcontext()
_counters: dict = dict.fromkeys(EVENTS, 0)
_frames = 0
# device -> (5,) int64: pairs, occupied tiles, samples, textured pixels,
# span blocks
_sums: dict = {}
_added = 0  # the most words a batch added since the last reset
# device -> (1,) int64: the longest bin list, folded by max
_peaks: dict = {}
_peaked = False  # whether a batch added its peaks since the last reset


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager: ``torch.profiler.record_function(name)`` while a
    profiler session records, else the one shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def tick(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def launch(wrapper: str, mode: str | None = None) -> None:
    """One call of a kernel wrapper (in ``mode``, for the kernels that
    have modes)."""
    tick("launches." + wrapper)
    if mode is not None:
        tick(f"launches.{wrapper}.{mode}")


def count(name: str) -> int:
    """The host counter ``name`` (0 if it never ticked)."""
    return _counters.get(name, 0)


def counters() -> dict:
    """A copy of every host counter."""
    return dict(_counters)


def prepare(device) -> None:
    """Make ``device``'s (an indexed device's) sums of ``frame_counts()``
    and its peaks of ``frame_peaks()``, and run their add and their max
    once, if not yet done: the first launch of a kernel
    loads it (12-15 ms on an H100, the device idle meanwhile), which a
    profiler session's first batch would otherwise pay. The renderer calls
    it when it captures a graph."""
    if device not in _sums:
        acc = torch.zeros((len(COUNTS),), dtype=torch.int64, device=device)
        _sums[device] = acc.add_(acc)
        peak = torch.zeros((1,), dtype=torch.int64, device=device)
        _peaks[device] = torch.maximum(peak, peak, out=peak)


def add_frames(sums, frames: int, peaks=None) -> None:
    """Add a batch's ``frames`` and its int64 device sums to
    ``frame_counts()``: one device add. The sums are the words of
    ``COUNTS`` in order, the first two to all five: pairs and occupied
    tiles, (2,); then samples, (3,); then textured pixels, (4,); then span
    blocks, (5,). The renderer calls it only while ``recording()``, with
    its accumulator's words from the third on: all five on the tile path,
    else four where the frame runs the mip texture tail and three where it
    does not; and with ``peaks``, its (1,) int64 longest-list word, which
    one device max folds into ``frame_peaks()``."""
    global _frames, _added, _peaked
    prepare(sums.device)
    _sums[sums.device][:sums.shape[0]].add_(sums)
    _frames += frames
    _added = max(_added, sums.shape[0])
    if peaks is not None:
        peak = _peaks[sums.device]
        torch.maximum(peak, peaks, out=peak)
        _peaked = True


# The device sums' names; a key past the first two appears in
# ``frame_counts()`` only once a batch has added its word.
COUNTS = ("pairs", "tiles", "samples", "textured", "spans")


def frame_counts() -> dict:
    """{"frames", "pairs", "tiles"} summed over the frames added while a
    profiler session recorded, "samples" once a batch added them,
    "textured" once a batch added those and "spans" once a batch added
    its span blocks (reads the device sums: a synchronisation)."""
    sums = [0] * len(COUNTS)
    for acc in _sums.values():
        sums = [a + b for a, b in zip(sums, acc.tolist())]
    counts = {"frames": _frames}
    counts.update(zip(COUNTS[:max(_added, 2)], sums))
    return counts


def frame_peaks() -> dict:
    """{"list": the longest bin list} over the frames added with their
    peaks while a profiler session recorded, or {} where none was (reads
    the device words: a synchronisation)."""
    if not _peaked:
        return {}
    return {"list": max(int(p.item()) for p in _peaks.values())}


def reset() -> None:
    """Zero every host counter, the frame counts and the frame peaks."""
    global _frames, _added, _peaked
    _counters.clear()
    _counters.update(dict.fromkeys(EVENTS, 0))
    _frames = 0
    _added = 0
    _peaked = False
    for acc in _sums.values():
        acc.zero_()
    for peak in _peaks.values():
        peak.zero_()
