"""On-device histogram model: observe, normalize to 2^B exactly, and the
decode tables, on tensors with an explicit device.

The port of `hsrans_tpu/models/jax_hist.py`, which the JAX package computes
in XLA.  Two functions carry the work of the encoders and have hand-written
CUDA kernels (`csrc/hist.cu`):

  * `observe_segments` — the byte counts of many segments of one input in
    one launch (`hist_count_kernel`); its plain version is a
    `torch.bincount` per segment;
  * `normalize_rows` — each row of counts scaled to 2^B and rebalanced
    exactly as the reference's hist.cpp:16-215 does, heap-sort tie order
    included, one warp a row (`hist_normalize_kernel`); its plain version
    rounds every row at once and hands a row whose sum misses 2^B to
    `models/histogram.py::normalize_hist`.

On a CUDA tensor they launch their kernel or raise; on a CPU tensor they
run their plain version.  `segment_hists` is the two in a row, the one
segment-histogram function of both encoders on every device.  `observe_device`, `normalize_device` and
`make_hist_device` are the one-histogram forms of the JAX module and go
through the same two.  `make_dec3_device` and `make_rank_tables_device`
are searchsorted and cumsum work on one histogram (XLA work in the JAX
package, no Pallas) and stay plain PyTorch on every device.  Counts are
int32 storage of u32 values; freqs and cumuls int16 storage of u16 values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import build
from .histogram import normalize_hist

# bytes of a segment that one CTA of the count kernel reads: 64 tpx tiles of
# 4 MiB fill the card 16 times over, an mt block of 4 KiB is one CTA
COUNT_CHUNK = 64 << 10


def segment_sizes(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Bytes of each segment [start, end); an end below its start is empty."""
    return np.maximum(np.asarray(ends, np.int64) - np.asarray(starts, np.int64), 0)


def segment_divisors(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The normaliser's divisor of each segment: its size, 1 for an empty
    one (whose count is the 1-symbol histogram)."""
    return np.maximum(segment_sizes(starts, ends), 1)


def segment_table(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, int]:
    """The count kernel's int64 [k, 3] rows (start, end, first chunk) and
    its chunks: ceil(size / COUNT_CHUNK) a segment, one for an empty one."""
    starts = np.asarray(starts, np.int64)
    chunks = np.maximum(-(-segment_sizes(starts, ends) // COUNT_CHUNK), 1)
    table = np.stack([starts, np.maximum(np.asarray(ends, np.int64), starts), np.cumsum(chunks) - chunks], axis=1)
    return table.reshape(-1, 3), int(chunks.sum())


def _check_segments(name: str, data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> None:
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if starts.shape != ends.shape or starts.ndim != 1:
        raise ValueError(f"{name}: starts and ends must be 1-d and of one length")
    full = ends > starts
    if (starts[full] < 0).any() or (ends[full] > data.numel()).any():
        raise ValueError(f"{name}: a segment lies outside the input")


def observe_segments_plain(data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version of the count kernel, on any device.

    data uint8 [n], starts and ends int64 host arrays [k] -> int32 [k, 256]:
    row i counts the bytes of data[starts[i] : ends[i]]; an empty segment
    (end <= start) gets the 1-symbol count, row[0] = 1, as
    `ops/tpx.py::make_tile_hist` takes it."""
    _check_segments("observe_segments_plain", data, starts, ends)
    out = torch.zeros((len(starts), 256), dtype=torch.int32, device=data.device)
    for i, (s, e) in enumerate(zip(np.asarray(starts).tolist(), np.asarray(ends).tolist())):
        if e > s:
            out[i] = torch.bincount(data[s:e], minlength=256).to(torch.int32)
        else:
            out[i, 0] = 1
    return out


def observe_segments_cuda(data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> torch.Tensor:
    """The CUDA count kernel (`csrc/hist.cu`) on a CUDA tensor, every
    segment in one launch; same contract as observe_segments_plain.  Raises
    for any other tensor."""
    dev = build.check_cuda("observe_segments_cuda", data, uint8=(0,))
    _check_segments("observe_segments_cuda", data, starts, ends)
    table, chunks = segment_table(starts, ends)
    counts = torch.zeros((len(table), 256), dtype=torch.int32, device=dev)  # multi-chunk rows add into it
    if len(table):
        launch_count(data, _on(table, dev), counts, chunks=chunks)
    return counts


def launch_count(data, table_t, counts, *, chunks: int) -> None:
    """One launch of the count kernel with its segment table on the card
    into `counts` (int32 [k, 256], zero where a segment has several
    chunks); observe_segments_cuda's checks are the caller's."""
    build.launch(
        "hist_count", "hsr_hist_count", data.device,
        data.data_ptr(), table_t.data_ptr(), table_t.shape[0], chunks, COUNT_CHUNK, counts.data_ptr(),
    )


def observe_segments(data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> torch.Tensor:
    """The kernel for a CUDA input, its plain version for a CPU input."""
    fn = observe_segments_plain if data.device.type == "cpu" else observe_segments_cuda
    return fn(data, starts, ends)


def _check_rows(name: str, counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> None:
    if counts.ndim != 2 or counts.shape[1] != 256 or divisors.shape != (counts.shape[0],):
        raise ValueError(f"{name}: counts must be [k, 256] and divisors [k]")
    if not 1 <= bits <= 15:
        raise ValueError(f"{name}: bits must be 1..15")
    if divisors.numel() and (int(divisors.min()) < 1 or int(divisors.max()) >= 1 << 32):
        raise ValueError(f"{name}: every divisor must be a u32 of at least 1")


def round_rows(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> torch.Tensor:
    """The normaliser's first step, int64 [k, 256]: each count times the
    float32 scale 2^B / divisor, plus 0.5 (two roundings, as numpy's), cut
    to a u16, and at least 1 where the count is not 0.  A row whose sum
    misses 2^B then takes the steal or charity passes."""
    c = counts.to(torch.int64) & 0xFFFFFFFF
    mul = torch.tensor(float(1 << bits), dtype=torch.float32, device=c.device) / divisors.to(torch.float32)
    scaled = c.to(torch.float32) * mul[:, None]
    capped = ((scaled + 0.5).to(torch.int64)) & 0xFFFF
    return torch.where((capped == 0) & (c != 0), 1, capped)


def normalize_rows_plain(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the normalise kernel, on any device.

    counts int32 [k, 256] (u32), divisors int64 [k] -> (freq, cumul) int16
    [k, 256] (u16): each row is `models/histogram.py::normalize_hist(row,
    divisor, bits)`: the float32 scale 2^B / divisor, each count times it
    plus 0.5 (two roundings) truncated to a u16, a present symbol at least
    1, then the reference's steal or charity passes where the sum misses
    2^B, and cumul the row's exclusive prefix sum mod 2^16.  The rounding
    runs over all rows at once; a row whose sum misses 2^B is handed whole
    to `normalize_hist`."""
    _check_rows("normalize_rows_plain", counts, divisors, bits)
    capped = round_rows(counts, divisors, bits)
    for r in torch.nonzero(capped.sum(dim=1) != 1 << bits).flatten().tolist():
        row = counts[r].cpu().numpy().view(np.uint32)
        fixed = normalize_hist(row, int(divisors[r]), bits).symbol_count
        capped[r] = torch.from_numpy(fixed.astype(np.int64)).to(capped.device)
    cumul = (torch.cumsum(capped, dim=1) - capped) & 0xFFFF
    return _as_u16(capped), _as_u16(cumul)


def _as_u16(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u16 values -> int16 storage of the same bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def normalize_rows_cuda(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA normalise kernel (`csrc/hist.cu`) on CUDA tensors, every row
    in one launch; same contract as normalize_rows_plain.  Raises for any
    other tensor."""
    dev = build.check_cuda("normalize_rows_cuda", counts, divisors, int64=(1,))
    _check_rows("normalize_rows_cuda", counts, divisors, bits)
    if counts.data_ptr() % 16:
        raise ValueError("normalize_rows_cuda: counts must be 16-byte aligned")
    freq = torch.empty(counts.shape, dtype=torch.int16, device=dev)  # the kernel writes every u16
    cumul = torch.empty(counts.shape, dtype=torch.int16, device=dev)
    if counts.shape[0]:
        launch_normalize(counts, divisors, freq, cumul, bits=bits)
    return freq, cumul


def launch_normalize(counts, divisors, freq, cumul, *, bits: int) -> None:
    """One launch of the normalise kernel into `freq` and `cumul`;
    normalize_rows_cuda's checks are the caller's."""
    build.launch(
        "hist_normalize", "hsr_hist_normalize", counts.device,
        counts.data_ptr(), divisors.data_ptr(), counts.shape[0], bits, freq.data_ptr(), cumul.data_ptr(),
    )


def normalize_rows(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA operands, its plain version for CPU operands."""
    fn = normalize_rows_plain if counts.device.type == "cpu" else normalize_rows_cuda
    return fn(counts, divisors, bits)


def segment_hists(data: torch.Tensor, starts: np.ndarray, ends: np.ndarray, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`ops/tpx.py::make_tile_hist(data[s:e], bits)` of every (s, e) on
    data's device, as (freq, cumul) int16 [k, 256]: one count launch and one
    normalise launch on the card."""
    counts = observe_segments(data, starts, ends)
    divisors = _on(segment_divisors(starts, ends), data.device)
    return normalize_rows(counts, divisors, bits)


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` (from pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dev.type == "cpu" else t.pin_memory().to(dev, non_blocking=True)


def observe_device(data: torch.Tensor) -> torch.Tensor:
    """Byte-frequency count on data's device: int32 [256] (u32)."""
    if data.numel() == 0:
        return torch.zeros(256, dtype=torch.int32, device=data.device)
    return observe_segments(data, np.array([0]), np.array([data.numel()]))[0]


def normalize_device(hist: torch.Tensor, data_bytes: int, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize counts [256] to sum exactly 2^bits with divisor
    `data_bytes`: (freq, cumul) int16 [256] (u16), bit-exact to the host's
    `normalize_hist`."""
    divisor = torch.tensor([int(data_bytes)], dtype=torch.int64, device=hist.device)
    freq, cumul = normalize_rows(hist.to(torch.int32).reshape(1, 256).contiguous(), divisor, bits)
    return freq[0], cumul[0]


def make_hist_device(data: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """observe + normalize on data's device (the reference's make_hist)."""
    return normalize_device(observe_device(data), data.numel(), bits)


def make_dec3_device(freq: torch.Tensor, cumul: torch.Tensor, bits: int) -> dict[str, torch.Tensor]:
    """Slot-indexed decode tables (the flat dec3 layout): at each slot its
    symbol (uint8), freq and cumul (int32), by searchsorted over the
    inclusive freq prefix."""
    f = freq.to(torch.int64) & 0xFFFF
    slots = torch.arange(1 << bits, dtype=torch.int64, device=freq.device)
    inv = torch.searchsorted(torch.cumsum(f, 0), slots, right=True)
    return {
        "sym": inv.to(torch.uint8),
        "freq": f[inv].to(torch.int32),
        "cumul": (cumul.to(torch.int64) & 0xFFFF)[inv].to(torch.int32),
    }


def make_rank_tables_device(freq: torch.Tensor, cumul: torch.Tensor, bits: int) -> dict[str, torch.Tensor]:
    """The rank-bucket decode tables of `ops/tpx.py::make_rank_tables` (c0,
    bm, t1, t2; int32, u32 bits): each 32-slot bucket's first rank and its
    bitmap of symbol starts, and per rank sym | freq << 8 and cumul."""
    dev = freq.device
    f = freq.to(torch.int64) & 0xFFFF
    total = 1 << bits
    slots = torch.arange(total, dtype=torch.int64, device=dev)
    inv = torch.searchsorted(torch.cumsum(f, 0), slots, right=True)
    present = (f > 0).to(torch.int64)
    rank_of_sym = torch.cumsum(present, 0) - present
    first = torch.ones(total, dtype=torch.int64, device=dev)
    first[1:] = (inv[1:] != inv[:-1]).to(torch.int64)
    bm = (first.reshape(total // 32, 32) << torch.arange(32, device=dev)).sum(dim=1)
    at = torch.where(present.bool(), rank_of_sym, 256)
    t1 = torch.zeros(257, dtype=torch.int64, device=dev)
    t2 = torch.zeros(257, dtype=torch.int64, device=dev)
    t1[at] = torch.arange(256, device=dev) | (f << 8)
    t2[at] = cumul.to(torch.int64) & 0xFFFF
    u32 = lambda x: torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)  # noqa: E731
    return {"c0": rank_of_sym[inv][::32].to(torch.int32), "bm": u32(bm), "t1": u32(t1[:256]), "t2": u32(t2[:256])}
