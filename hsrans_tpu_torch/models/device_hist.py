"""On-device histogram model: observe, normalize to 2^B exactly, and the
decode tables, on tensors with an explicit device.

The port of `hsrans_tpu/models/jax_hist.py`, which the JAX package computes
in XLA.  Two functions carry the work of the encoders and have hand-written
CUDA kernels (`csrc/hist.cu`):

  * `observe_segments` — the byte counts of many segments of one input in
    one launch (`hist_count_kernel`: a warp a segment of up to
    COUNT_WARP_MAX bytes, a CTA a COUNT_CHUNK chunk of a longer one); its
    plain version is a `torch.bincount` per segment;
  * `normalize_rows` — each row of counts scaled to 2^B and rebalanced
    exactly as the reference's hist.cpp:16-215 does, heap-sort tie order
    included, one warp a row (`hist_normalize_kernel`); its plain version
    rounds every row at once and takes the rows whose sum misses 2^B
    through the kernel's schedule, batched in torch (`heap_keys`,
    `rebalance_keys`).

On a CUDA tensor they launch their kernel or raise; on a CPU tensor they
run their plain version.  `segment_hists` is the two in a row, the one
segment-histogram function of both encoders on every device; on the card
it makes no wait between its entry and its return.  `observe_device`, `normalize_device` and
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
from ..runtime.device import layer_clock

# bytes of a long segment that one CTA of the count kernel reads: 64 tpx
# tiles of 4 MiB fill the card 16 times over
COUNT_CHUNK = 64 << 10
# a segment of up to this many bytes is counted by one warp, eight a CTA
# (an mt call's 4 KiB blocks; a 16 KiB one is 32 loads a lane); longer ones
# are cut into COUNT_CHUNK chunks, a CTA each
COUNT_WARP_MAX = 16 << 10


def segment_sizes(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Bytes of each segment [start, end); an end below its start is empty."""
    return np.maximum(np.asarray(ends, np.int64) - np.asarray(starts, np.int64), 0)


def segment_divisors(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The normaliser's divisor of each segment: its size, 1 for an empty
    one (whose count is the 1-symbol histogram)."""
    return np.maximum(np.asarray(ends, np.int64) - np.asarray(starts, np.int64), 1)


def segment_table(starts: np.ndarray, ends: np.ndarray, out: np.ndarray | None = None) -> tuple[np.ndarray, int, int]:
    """The count kernel's segment table, int64 [4, k] columns (start, end,
    row, first chunk), written into `out` when given; and its short
    segments and its chunks.  First the segments of up to COUNT_WARP_MAX
    bytes, the empty ones among them (a warp each; first chunk 0), then the
    longer ones, each cut into ceil(size / COUNT_CHUNK) chunks of a CTA,
    numbered in turn.  `row` is the segment's position in `starts`, where
    its counts go; an end below its start stays as it is (empty)."""
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    table = np.empty((4, starts.size), np.int64) if out is None else out
    short = ends - starts <= COUNT_WARP_MAX
    n_short = int(np.count_nonzero(short))
    if n_short == starts.size:  # every segment a warp's (an mt call's blocks): no reordering
        table[0], table[1], table[2], table[3] = starts, ends, np.arange(starts.size), 0
        return table, n_short, 0
    order = np.concatenate([np.flatnonzero(short), np.flatnonzero(~short)])
    chunks = -(-(ends[order[n_short:]] - starts[order[n_short:]]) // COUNT_CHUNK)
    table[0], table[1], table[2] = starts[order], ends[order], order
    table[3, :n_short] = 0
    table[3, n_short:] = np.cumsum(chunks) - chunks
    return table, n_short, int(chunks.sum())


def _check_segments(name: str, data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> None:
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if starts.shape != ends.shape or starts.ndim != 1:
        raise ValueError(f"{name}: starts and ends must be 1-d and of one length")
    if starts.size and (starts.min() < 0 or ends.max() > data.numel()):  # only a segment with bytes must lie inside
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
    host = torch.empty((4, len(starts)), dtype=torch.int64, pin_memory=True)
    _, n_short, chunks = segment_table(starts, ends, host.numpy())
    return _count(data, host.to(dev, non_blocking=True), n_short, chunks)


def _count(data: torch.Tensor, table_t: torch.Tensor, n_short: int, chunks: int) -> torch.Tensor:
    counts = torch.empty((table_t.shape[1], 256), dtype=torch.int32, device=data.device)  # the launch writes each row
    if table_t.shape[1]:
        launch_count(data, table_t, counts, n_short=n_short, chunks=chunks)
    return counts


def launch_count(data, table_t, counts, *, n_short: int, chunks: int) -> None:
    """One launch of the count kernel with its segment table (segment_table's
    [4, k] columns, contiguous) on the card into `counts` (int32 [k, 256]),
    every row written; observe_segments_cuda's checks are the caller's."""
    build.launch(
        "hist_count", "hsr_hist_count", data.device,
        data.data_ptr(), table_t.data_ptr(), n_short, table_t.shape[1] - n_short, chunks, COUNT_CHUNK,
        counts.data_ptr(),
    )


def observe_segments(data: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> torch.Tensor:
    """The kernel for a CUDA input, its plain version for a CPU input."""
    fn = observe_segments_plain if data.device.type == "cpu" else observe_segments_cuda
    return fn(data, starts, ends)


def _check_bits(name: str, bits: int) -> None:
    if not 1 <= bits <= 15:
        raise ValueError(f"{name}: bits must be 1..15")


def _check_divisors(name: str, divisors) -> None:
    """divisors: a host array or a tensor (a CUDA one costs a wait on the card)."""
    if divisors.shape[0] and (int(divisors.min()) < 1 or int(divisors.max()) >= 1 << 32):
        raise ValueError(f"{name}: every divisor must be a u32 of at least 1")


def _check_rows(name: str, counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> None:
    if counts.ndim != 2 or counts.shape[1] != 256 or divisors.shape != (counts.shape[0],):
        raise ValueError(f"{name}: counts must be [k, 256] and divisors [k]")
    _check_bits(name, bits)
    _check_divisors(name, divisors)


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


def _sift(heap: torch.Tensor, r: torch.Tensor, i: torch.Tensor, key: torch.Tensor, n: int,
          live: torch.Tensor | None = None) -> torch.Tensor:
    """The normalise kernel's `sift_down`, batched: each `key` (count << 8 |
    symbol) sinks from node i of heap row r ([m] each; (r, i) pairs head
    disjoint subtrees) of n keys, by count alone, strict >, left child
    before right; each larger child moves up into the hole.  Pairs where
    `live` is False are left as they are.  Returns the key that ends at
    node i."""
    go = torch.ones_like(i, dtype=torch.bool) if live is None else live.clone()
    stored, i0, head, v = go.clone(), i, key, key >> 8
    for _ in range(n.bit_length()):
        left = 2 * i + 1
        go &= left < n
        if not go.any():
            break
        cl, cr = heap[r, torch.clamp(left, max=255)], heap[r, torch.clamp(left + 1, max=256)]
        take = go & ((cl >> 8) > v)
        m, mk = torch.where(take, left, i), torch.where(take, cl, key)
        take = go & (left + 1 < n) & ((cr >> 8) > (mk >> 8))
        m, mk = torch.where(take, left + 1, m), torch.where(take, cr, mk)
        go &= m != i
        heap[r, i] = torch.where(go, mk, heap[r, i])
        head = torch.where(go & (i == i0), mk, head)
        i = torch.where(go, m, i)
    heap[r, i] = torch.where(stored, key, heap[r, i])
    return head


def heap_keys(capped: torch.Tensor, stop: torch.Tensor | None = None) -> torch.Tensor:
    """The normalise kernel's heap sort of each row of u16 counts (int64 [k,
    256]): int64 [k, 256] keys count << 8 | symbol by sorted position, the
    order of hist.cpp:110-144 (and `models/histogram.py::_heap_sort_indices`)
    in the kernel's schedule: the heapify by depth, deepest first, every
    node of a depth at once, then the serial extraction from position 255
    down to stop[row] (default 1, the whole sort).  Below a row's stop lies
    what is left of its heap."""
    k, dev = capped.shape[0], capped.device
    heap = torch.zeros((k, 257), dtype=torch.int64, device=dev)  # a node's right child may be 256
    heap[:, :256] = capped << 8 | torch.arange(256, device=dev)
    rows = torch.arange(k, device=dev)
    for d in range(7, -1, -1):
        nodes = torch.arange((1 << d) - 1, min((2 << d) - 1, 128), device=dev)
        r, i = rows.repeat_interleave(nodes.numel()), nodes.repeat(k)
        _sift(heap, r, i, heap[r, i], 256)
    stop = torch.ones(k, dtype=torch.int64, device=dev) if stop is None else stop
    root, zero = heap[:, 0].clone(), torch.zeros_like(rows)
    for n in range(255, int(stop.min()) - 1, -1):
        live = n >= stop
        last = heap[:, n].clone()
        heap[:, n] = torch.where(live, root, last)
        root = torch.where(live, _sift(heap, rows, zero, last, n, live), root)
    return heap[:, :256]


def _bump(keys: torch.Tensor, hit: torch.Tensor, d: int) -> torch.Tensor:
    """keys whose count moves by d as a u16 where `hit`, the symbol kept."""
    return torch.where(hit, (((keys >> 8) + d) & 0xFFFF) << 8 | (keys & 0xFF), keys)


def rebalance_keys(keys: torch.Tensor, sums: torch.Tensor, total: int) -> torch.Tensor:
    """The steal and charity passes on each row's sorted keys (heap_keys) of
    rounded counts summing to sums[row], as the normalise kernel runs them
    (and `models/histogram.py::normalize_hist`): a pass starts at the first
    sorted position from the last start on whose count is >= 2, and takes
    one from (or gives one to) n consecutive sorted positions, n =
    min(256 - start, the sum's distance to total), the last n for charity."""
    rank = torch.arange(256, device=keys.device)
    mt = torch.zeros_like(sums)
    for sign in (-1, 1):
        while True:
            act = sums > total if sign < 0 else sums < total
            if not act.any():
                break
            ge2 = ((keys >> 8) >= 2) & (rank >= mt[:, None])
            mt = torch.where(act & ge2.any(dim=1), ge2.to(torch.int32).argmax(dim=1).to(mt.dtype), mt)
            n = torch.where(act, torch.minimum(256 - mt, (sums - total).abs()), 0)
            lo = mt if sign < 0 else 256 - n
            keys = _bump(keys, (rank >= lo[:, None]) & (rank < (lo + n)[:, None]), sign)
            sums = sums + sign * n
    return keys


def normalize_rows_plain(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the normalise kernel, on any device.

    counts int32 [k, 256] (u32), divisors int64 [k] -> (freq, cumul) int16
    [k, 256] (u16): each row is `models/histogram.py::normalize_hist(row,
    divisor, bits)`: the float32 scale 2^B / divisor, each count times it
    plus 0.5 (two roundings) truncated to a u16, a present symbol at least
    1, then the reference's steal or charity passes where the sum misses
    2^B, and cumul the row's exclusive prefix sum mod 2^16.  The rows whose
    sum misses 2^B go through the kernel's schedule, all at once: heap_keys
    down to the first count >= 2 (every position when no count reaches 2),
    then rebalance_keys."""
    _check_rows("normalize_rows_plain", counts, divisors, bits)
    capped = round_rows(counts, divisors, bits)
    fix = torch.nonzero(capped.sum(dim=1) != 1 << bits).flatten()
    if fix.numel():
        rows = capped[fix]
        small = (rows <= 1).sum(dim=1)
        keys = heap_keys(rows, torch.where(small == 256, 1, small.clamp(min=1)))
        keys = rebalance_keys(keys, rows.sum(dim=1), 1 << bits)
        capped[fix] = torch.zeros_like(rows).scatter_(1, keys & 0xFF, keys >> 8)
    cumul = (torch.cumsum(capped, dim=1) - capped) & 0xFFFF
    return _as_u16(capped), _as_u16(cumul)


def _as_u16(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u16 values -> int16 storage of the same bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def normalize_rows_cuda(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA normalise kernel (`csrc/hist.cu`) on CUDA tensors, every row
    in one launch; same contract as normalize_rows_plain.  Raises for any
    other tensor."""
    build.check_cuda("normalize_rows_cuda", counts, divisors, int64=(1,))
    _check_rows("normalize_rows_cuda", counts, divisors, bits)
    return _normalize(counts, divisors, bits)


def _normalize(counts: torch.Tensor, divisors: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    if counts.data_ptr() % 16:
        raise ValueError("normalize_rows_cuda: counts must be 16-byte aligned")
    freq = torch.empty(counts.shape, dtype=torch.int16, device=counts.device)  # the kernel writes every u16
    cumul = torch.empty(counts.shape, dtype=torch.int16, device=counts.device)
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


def segment_hists(
    data: torch.Tensor, starts: np.ndarray, ends: np.ndarray, bits: int, split: dict[str, float] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """`ops/tpx.py::make_tile_hist(data[s:e], bits)` of every (s, e) on
    data's device, as (freq, cumul) int16 [k, 256]: on the card one count
    launch and one normalise launch, the divisors checked on the host, the
    segment table and the divisors sent in one copy, and no wait on the
    card before the return.  With `split`, adds the seconds of each step to
    it (checks, table, h2d, count, normalize; the card synchronized at each
    boundary)."""
    if data.device.type == "cpu":
        counts = observe_segments_plain(data, starts, ends)
        return normalize_rows_plain(counts, torch.from_numpy(segment_divisors(starts, ends)), bits)
    dev = build.check_cuda("segment_hists", data, uint8=(0,))
    with layer_clock(split, "checks", dev):
        _check_segments("segment_hists", data, starts, ends)
        _check_bits("segment_hists", bits)
        divisors = segment_divisors(starts, ends)
        _check_divisors("segment_hists", divisors)
    with layer_clock(split, "table", dev):
        host = torch.empty((5, divisors.size), dtype=torch.int64, pin_memory=True)  # the table's 4 columns, divisors
        view = host.numpy()
        _, n_short, chunks = segment_table(starts, ends, view[:4])
        view[4] = divisors
    with layer_clock(split, "h2d", dev):
        both = host.to(dev, non_blocking=True)
    with layer_clock(split, "count", dev):
        counts = _count(data, both[:4], n_short, chunks)
    with layer_clock(split, "normalize", dev):
        return _normalize(counts, both[4], bits)


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
