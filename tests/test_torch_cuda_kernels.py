"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA tensors, and the public round trips against the
numpy wire authorities.  Exact equality throughout: the codec is lossless
integer arithmetic, so the tolerance is zero.

Needs an NVIDIA Hopper card and nvcc; run there with
`python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q`.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hsrans_tpu.ops.mt import mt_decode_py, mt_encode_py
from hsrans_tpu.ops.tpx import TpxParams, _mega_layout, tpx_encode, tpx_encode_adaptive
from hsrans_tpu_torch.kernels import mt_decode as mtd
from hsrans_tpu_torch.kernels import mt_encode as mte
from hsrans_tpu_torch.kernels import tpx_decode as dec
from hsrans_tpu_torch.kernels import tpx_encode as enc
from hsrans_tpu_torch.parallel.sharded import device_plan, uniform_plan
from hsrans_tpu_torch.runtime import build
from tools.gen_inputs import text_like

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# (rows, steps, n_tiles) of each mega: v2 (one geometry, the last mega
# partial), v3 with mixed geometry, and rows not a multiple of 4 (the last
# CTA of each mega has idle warps)
TPX_GEOMS = {
    "v2 multi-mega partial": ((40, 8, 3),) * 3,
    "v3 mixed geometry": ((128, 8, 2), (13, 4, 3), (1024, 32, 1)),
    "rows 37": ((37, 8, 2),) * 2,
}


def _wire_equals_plain(dev, wargs: tuple, wkw: dict, base: int) -> None:
    """The wire writer == its plain version from u16 `base` on, through its
    wrapper and by its launch alone into a 0xAA-filled output, which it
    must write wholly from `base` on and leave alone below."""
    want = enc.write_wire_plain(*wargs, **wkw)
    got = enc.write_wire_cuda(*wargs, **wkw)
    torch.cuda.synchronize()
    assert torch.equal(got[2 * base :], want[2 * base :])
    out = torch.empty(wkw["out_u16"], dtype=torch.int16, device=dev)
    assert chip_smoke.prefilled_equal(chip_smoke.wire_launch(wargs, wkw, out, dev), out, want, base)


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
@pytest.mark.parametrize("case", sorted(TPX_GEOMS))
def test_kernels_equal_plain(cuda, bits, case):
    """The encode kernel, the wire writer and the decode kernel (each every
    mega in one launch; the decode reading the ragged wire) == their plain
    versions, and the blob == the authority's where the wire is v2; the
    last mega is cut short."""
    spans = [rows * steps * 128 * n for rows, steps, n in TPX_GEOMS[case]]
    data = text_like(np.random.default_rng(bits), sum(spans) - 5000)
    bases = np.cumsum([0, *spans[:-1]]).tolist()
    geoms = [(b, rows, steps, n, min(data.size - b, z)) for b, (rows, steps, n), z in zip(bases, TPX_GEOMS[case], spans)]
    data_t = torch.from_numpy(data).to(cuda)
    desc, freqs_t, *tabs = enc.mega_operands(data_t, geoms, bits=bits)
    ops = (data_t, desc, *tabs)
    got = enc.encode_mega_cuda(*ops, bits=bits)
    torch.cuda.synchronize()
    for g, w in zip(got, enc.encode_mega_plain(*ops, bits=bits)):
        assert torch.equal(g, w)
    v3 = case.startswith("v3")
    row_words = torch.cat([c.sum(dim=2).reshape(-1) for _, c, _ in enc.mega_views(*got, desc)]).cpu().numpy()
    wdesc, row_at, out_u16 = enc.wire_layout(desc, row_words, v3=v3, base=chip_smoke.HEAD_U16)
    wargs = (*got, freqs_t, wdesc, row_at)
    _wire_equals_plain(cuda, wargs, {"v3": v3, "out_u16": out_u16}, chip_smoke.HEAD_U16)

    blob = bytearray(b"HSRTPX03" if v3 else b"HSRTPX02")
    blob += data.size.to_bytes(8, "little") + bytes(8)
    for v in (bits, *TPX_GEOMS[case][0][:1], 128, TPX_GEOMS[case][0][1], TPX_GEOMS[case][0][2]):
        blob += v.to_bytes(4, "little")
    blob = enc._encode_megas(bytes(blob), data, geoms, bits=bits, v3=v3, devices=[cuda], layers=None)
    assert blob == enc._encode_megas(blob[:44], data, geoms, bits=bits, v3=v3, devices=[torch.device("cpu")], layers=None)
    if not v3:
        p = TpxParams(bits=bits, rows=geoms[0][1], steps=geoms[0][2], tiles=geoms[0][3])
        assert bytes(blob) == tpx_encode(data, p=p)
    args, kw = chip_smoke.tpx_decode_args(bytes(blob), cuda)
    out = dec.decode_mega_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, dec.decode_mega_plain(*args, **kw))
    assert out[: data.size].cpu().numpy().tobytes() == data.tobytes()
    assert dec.tpx_decode_torch(bytes(blob), device="cuda") == data.tobytes()


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", chip_smoke.TPX_DECODE_EDGES)
def test_tpx_decode_window_edges(cuda, case, bits):
    """The tpx decode kernel == its plain version where its ragged reads and
    shared-memory window meet their edges: slot regions at every even
    16-byte phase, rows cut to w_slots that read past their last slot, rows
    shorter than a window half, one mega of one tile, the v1 wire."""
    for name, args, kw in chip_smoke.tpx_decode_edge_operands(case, bits, cuda):
        got = dec.decode_mega_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, dec.decode_mega_plain(*args, **kw)), name


@pytest.mark.parametrize("case", chip_smoke.TPX_WIRE_EDGES)
def test_tpx_wire_edges(cuda, case):
    """The wire writer == its plain version, every byte of the sections
    written, where it meets its edges: sections at every even 16-byte
    phase, rows with no words and rows of all 32 x 128 words, one mega of
    one tile; on random windows and counts."""
    for name, wargs, wkw, base in chip_smoke.tpx_wire_edge_operands(case, cuda):
        _wire_equals_plain(cuda, wargs, wkw, base)


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_round_trip_equals_authority(cuda, bits):
    p = TpxParams(bits=bits, rows=136, lanes=128, steps=8, tiles=2)
    data = text_like(np.random.default_rng(5), 2 * p.mega_bytes + 777)
    assert len(_mega_layout(data.size, p)) == 3
    blob = enc.tpx_encode_torch(data, p=p, device="cuda")
    assert blob == tpx_encode(data, p=p)
    assert dec.tpx_decode_torch(blob, device="cuda") == data.tobytes()


def test_main_path_64mib_equals_authority(cuda):
    """chip_smoke.py's main path (64 MiB of enwik8-like text, seed 8, B=12,
    four megas at the full 1024-row geometry) held directly against the
    numpy authority, which chip_smoke.py itself may not import."""
    data = text_like(np.random.default_rng(8), 64 << 20)
    blob = enc.tpx_encode_torch(data, 12, device="cuda")
    assert blob == tpx_encode(data, 12)
    assert dec.tpx_decode_torch(blob, device="cuda") == data.tobytes()


def test_adaptive_and_malformed(cuda):
    from pathlib import Path

    arr = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)[: 1 << 20]
    blob = enc.tpx_encode_adaptive_torch(arr, 12, device="cuda")
    assert blob == tpx_encode_adaptive(arr, 12)
    assert dec.tpx_decode_torch(blob, device="cuda") == arr.tobytes()
    rng = np.random.default_rng(3)
    for _ in range(20):
        b = bytearray(blob)
        b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        out = dec.tpx_decode_torch(bytes(b), device="cuda")
        assert out is None or isinstance(out, bytes)
    torch.cuda.synchronize()


def _mt_operands(blob: bytes, bits: int, n: int, dev):
    length, stream, blocks, w_counts = mtd.index_blocks(blob, n)
    index, states, fc = mtd.block_operands(length, stream, blocks, w_counts, bits, n)
    return length, mtd.device_operands(stream, index, states, fc, n, dev)


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (4, 10, 12, 13, 15))
def test_mt_kernel_equals_plain(cuda, bits, n):
    """The mt kernel == its plain version (bytes, final states, cursors) on 61
    blocks, which leave three idle warps in the last CTA, with an odd tail.
    B=4 (six symbols) has a single 16-slot rank bucket."""
    rng = np.random.default_rng(bits)
    size = 61 * 4096 - 3983
    data = text_like(rng, size) if bits > 8 else rng.integers(0, 6, size).astype(np.uint8)
    blob = mt_encode_py(data, bits, n, uniform_plan(data, bits, n, 4096))
    length, args = _mt_operands(blob, bits, n, cuda)
    assert args[1].shape[0] == 61
    got = mtd.decode_blocks_cuda(*args, bits=bits, n=n, length=length)
    torch.cuda.synchronize()
    want = mtd.decode_blocks_plain(*args, bits=bits, n=n, length=length)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mtd.mt_decode_torch(blob, bits, n, device="cuda") == data.tobytes()


def test_mt_main_path_64mib_equals_oracle(cuda):
    """chip_smoke.py's mt main path (64 MiB of x-ray, B=12, n=64, device_plan
    with a 24 KiB cap) held against the numpy oracle `mt_decode_py`, which
    chip_smoke.py itself may not import."""
    from pathlib import Path

    data = np.tile(np.fromfile(Path(__file__).parent / "corpus" / "xray.bin", np.uint8), 8)
    blob = mt_encode_py(data, 12, 64, device_plan(data, 12, 64, 24 << 10))
    got = mtd.mt_decode_torch(blob, 12, 64, device="cuda")
    assert got == data.tobytes()
    assert got == mt_decode_py(blob, 12, 64)


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_mt_annotated_kernels_equal_plain(cuda, bits, n, monkeypatch):
    """The annotate kernel == its plain version (every word) and the
    annotated decode kernel == its plain version and the rank kernel
    (bytes, final states, cursors) on 61 blocks with an odd tail, whole and
    on a word region cut to half, where reads past the cut give word 0 and
    rank 0; then the annotated route of mt_decode_torch."""
    rng = np.random.default_rng(bits + n)
    data = text_like(rng, 61 * 4096 - 3983)
    blob = mt_encode_py(data, bits, n, uniform_plan(data, bits, n, 4096))
    length, (stream, index, states, fc) = _mt_operands(blob, bits, n, cuda)
    kw = {"bits": bits, "n": n, "length": length}
    for cut in (stream.numel(), stream.numel() // 4 * 2):
        words = stream[:cut]
        ann = mtd.annotate_cuda(words, index, fc, bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(ann, mtd.annotate_plain(words, index, fc, bits=bits))
        got = mtd.decode_blocks_annotated_cuda(ann, index, states, fc, **kw)
        torch.cuda.synchronize()
        want = mtd.decode_blocks_annotated_plain(ann, index, states, fc, **kw)
        rank = mtd.decode_blocks_cuda(words, index, states, fc, **kw)
        for g, w, r in zip(got, want, rank):
            assert torch.equal(g, w) and torch.equal(g, r)
    monkeypatch.setattr(mtd, "_PAIR_V2", True)
    assert mtd.mt_decode_torch(blob, bits, n, device="cuda") == data.tobytes()


def test_mt_annotated_main_path_64mib_equals_oracle(cuda, monkeypatch):
    """chip_smoke.py's mt main path through the annotated route, held
    against the numpy oracle `mt_decode_py`."""
    from pathlib import Path

    data = np.tile(np.fromfile(Path(__file__).parent / "corpus" / "xray.bin", np.uint8), 8)
    blob = mt_encode_py(data, 12, 64, device_plan(data, 12, 64, 24 << 10))
    monkeypatch.setattr(mtd, "_PAIR_V2", True)
    got = mtd.mt_decode_torch(blob, 12, 64, device="cuda")
    assert got == data.tobytes()
    assert got == mt_decode_py(blob, 12, 64)


@pytest.mark.parametrize("rule", mte.RULES)
@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (4, 10, 12, 13, 15))
def test_mt_encode_kernels_equal_plain(cuda, bits, n, rule):
    """The mt encode kernel == its plain version (counts, final states, the
    emitted words) and the placement kernel == its plain version (the whole
    blob, every byte written by the launch) on 61 blocks with sizes off the
    64-byte grid, a single-symbol row and an odd tail; 61 blocks leave
    three idle warps in the last CTA.  B=4 codes six symbols."""
    rng = np.random.default_rng(bits + n)
    size = 61 * 4096 - 3983
    data = text_like(rng, size) if bits > 8 else rng.integers(0, 6, size).astype(np.uint8)
    data[::31] = 0  # the byte a partial group's lanes read past a block's end is in every block
    data[:1000] = 0
    plan = mte.uniform_rows(size, 4096)
    plan[5].size, plan[6].start, plan[6].size = 4000, plan[5].start + 4000, plan[6].size + 96
    from hsrans_tpu_torch.ops.planner import BlockPlan

    plan.insert(0, BlockPlan(0, 1000, True, 0, None))
    plan[1].start, plan[1].size = 1000, plan[1].size - 1000
    kinds, ks, index, freqs, bias = mte.plan_operands(data, plan, bits, n, rule)
    assert len(ks) == 61
    ops = (torch.from_numpy(data).to(cuda), torch.from_numpy(index).to(cuda), torch.from_numpy(freqs.view(np.int16)).to(cuda))
    kw = {"bits": bits, "n": n, "rule": rule, "words_cap": int(index[-1, 4])}
    got = mte.encode_blocks_cuda(*ops, **kw)
    torch.cuda.synchronize()
    want = mte.encode_blocks_plain(*ops, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(mte.emitted_words(got[0], ops[1], got[1]), mte.emitted_words(want[0], ops[1], want[1]))
    pargs, pkw = chip_smoke.place_operands(plan, kinds, ks, bias, got[0], ops[1], *got[1:], ops[2], n, data.size)
    assert chip_smoke.place_check("mt place", pargs, pkw, timed=False)["every_byte_written"]
    whole = mte.encode_plan(data, plan, bits, n, rule, [cuda])
    assert whole == mte.encode_plan(data, plan, bits, n, rule, [torch.device("cpu")])
    assert mtd.mt_decode_torch(whole, bits, n, device="cuda") == data.tobytes() == mt_decode_py(whole, bits, n)


def test_mt_encode_main_path_64mib_round_trip(cuda):
    """chip_smoke.py's mt encode main path (a): 64 MiB of x-ray, B=12, n=64,
    device_plan with a 24 KiB cap, encoded on the card, equal to the CPU
    tier, decoded on the card and by the numpy oracle `mt_decode_py`."""
    from pathlib import Path

    data = np.tile(np.fromfile(Path(__file__).parent / "corpus" / "xray.bin", np.uint8), 8)
    plan = device_plan(data, 12, 64, 24 << 10)
    blob = mte.mt_encode_torch(data, 12, plan=plan, device="cuda")
    assert blob == mte.mt_encode_torch(data, 12, plan=plan, device="cpu")
    assert mtd.mt_decode_torch(blob, 12, 64, device="cuda") == data.tobytes() == mt_decode_py(blob, 12, 64)


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", chip_smoke.DECODE_EDGES)
def test_mt_decode_window_edges(cuda, case, bits, n):
    """The mt decode kernel == its plain version (bytes, final states,
    cursors) where its shared-memory window meets its edges: block word
    regions at every 16-byte phase, blocks with fewer words than one window
    half, word regions that run out mid-group (reads past them give 0), and
    one 1 MiB block (~16 Ki groups at n=64, many refills)."""
    for name, args, kw in chip_smoke.decode_edge_operands(case, bits, n, cuda):
        got = mtd.decode_blocks_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = mtd.decode_blocks_plain(*args, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", chip_smoke.DECODE_EDGES)
def test_mt_annotated_window_edges(cuda, case, bits, n):
    """The annotate kernel == its plain version (every word) and the
    annotated decode kernel == its plain version (bytes, final states,
    cursors) on test_mt_decode_window_edges' cases: the annotation's blocks
    at every phase of a u32 word in 16 bytes, blocks with fewer words than
    one window half, word regions that run out mid-group (reads past them
    give word 0 and rank 0), and one 1 MiB block."""
    for name, (words, index, states, fc), kw in chip_smoke.decode_edge_operands(case, bits, n, cuda):
        ann = mtd.annotate_cuda(words, index, fc, bits=bits)
        got = mtd.decode_blocks_annotated_cuda(ann, index, states, fc, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ann, mtd.annotate_plain(words, index, fc, bits=bits)), name
        want = mtd.decode_blocks_annotated_plain(ann, index, states, fc, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_mt_decode_annotated_refuses_unaligned_annotation(cuda):
    """The annotated decode's C entry refuses an annotation that does not
    start on a 4-byte boundary (its window copies 16-byte chunks at the
    block's u32 phase), as the rank decode refuses an odd word region."""
    ann = torch.zeros(64, dtype=torch.int32, device=cuda)
    index = torch.tensor([[0, 32, 0, 64, 1]], dtype=torch.int64, device=cuda)
    states = torch.full((1, 64), 1 << 16, dtype=torch.int32, device=cuda)
    fc = torch.zeros((1, 256), dtype=torch.int32, device=cuda)
    fc[0, 0] = 1 << 12
    out = torch.zeros(64, dtype=torch.uint8, device=cuda)
    fin, cursor = torch.empty_like(states), torch.empty(1, dtype=torch.int64, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    lib = build.load()
    args = (index.data_ptr(), states.data_ptr(), fc.data_ptr(), out.data_ptr(), fin.data_ptr(), cursor.data_ptr(),
            1, 64, 12, 60, 64, stream)
    assert lib.hsr_mt_decode_annotated(ann.data_ptr() + 2, *args) != 0
    assert lib.hsr_mt_decode_annotated(ann.data_ptr() + 4, *args) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("rule", mte.RULES)
@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("case", chip_smoke.ENCODE_EDGES)
def test_mt_encode_window_edges(cuda, case, n, rule):
    """The mt encode kernel == its plain version (counts, final states, the
    emitted words) where its input window meets its edges: blocks starting
    at every 16-byte phase, block sizes off the 64-byte grid (a partial last
    group read as 0 past the block's end) under both rules, and one 1 MiB
    block."""
    for name, (data, index, freqs), kw in chip_smoke.encode_edge_operands(case, n, rule, cuda):
        got = mte.encode_blocks_cuda(data, index, freqs, **kw)
        torch.cuda.synchronize()
        want = mte.encode_blocks_plain(data, index, freqs, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), name
        assert torch.equal(mte.emitted_words(got[0], index, got[1]), mte.emitted_words(want[0], index, want[1])), name


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("case", chip_smoke.MT_PLACE_EDGES)
def test_mt_place_edges(cuda, case, n):
    """The placement kernel == its plain version, every byte of the blob
    written by its launch, where it meets its edges: parts whose words and
    their source in the scratch meet at every pair of u16 phases, the
    scratch ending at an odd u16, and a block far longer than one chunk."""
    for name, pargs, pkw in chip_smoke.place_edge_operands(case, n, cuda):
        assert chip_smoke.place_check(f"{case}, {name}", pargs, pkw, timed=False)["every_byte_written"]


@pytest.mark.parametrize("case", chip_smoke.HIST_EDGES)
def test_hist_kernels_equal_plain_on_edges(cuda, case):
    """The count and normalise kernels == their plain versions on
    chip_smoke.py's HIST_EDGES at B=10, 12 and 15 (hist_check raises on any
    difference)."""
    res = chip_smoke.hist_check(case, *chip_smoke.hist_edge_operands(case, cuda), (10, 12, 15), False)
    assert res["hist_count"]["max_abs_err"] == 0


@pytest.mark.parametrize("bits", (4, 10, 12, 15))
def test_hist_kernels_equal_make_tile_hist(cuda, bits):
    """The card's freqs of ragged segments (any byte phase, empty, one
    byte, several chunks, out of order) == the JAX package's host
    `make_tile_hist` of each, and the cumuls its."""
    from hsrans_tpu.ops.tpx import make_tile_hist
    from hsrans_tpu_torch.models import device_hist as dh

    rng = np.random.default_rng(bits)
    data = text_like(rng, 600_000)
    starts = np.array([0, 3, 4096, 77, 500_000, 100, 9, 131_073, 599_999, 1000], np.int64)
    ends = np.array([4096, 4099, 8192, 77, 600_000, 50, 10, 400_001, 600_000, 200_000], np.int64)
    before = dict(build.LAUNCHES)
    freq, cumul = dh.segment_hists(torch.from_numpy(data).to(cuda), starts, ends, bits)
    assert _hist_launches(before) == 1
    for i, (s, e) in enumerate(zip(starts, ends)):
        want = make_tile_hist(data[s:e], bits)
        assert np.array_equal(freq[i].cpu().numpy().view(np.uint16), want.symbol_count)
        assert np.array_equal(cumul[i].cpu().numpy().view(np.uint16), want.cumul)


def test_segment_hists_makes_no_wait_on_the_card(cuda):
    """segment_hists on the card (mt encode (b)'s 4 KiB blocks and long
    segments in one call) checks on the host and sends its table and
    divisors in one copy: torch's sync debug mode raises on any wait for
    the card between its entry and its return."""
    from hsrans_tpu_torch.models import device_hist as dh

    data = text_like(np.random.default_rng(5), 1 << 22)
    starts = np.concatenate([np.arange(0, 1 << 21, 4096), [1 << 21, 3 << 20]]).astype(np.int64)
    ends = np.concatenate([starts[:-2] + 4096, [3 << 20, 1 << 22]]).astype(np.int64)
    data_t = torch.from_numpy(data).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        freq, cumul = dh.segment_hists(data_t, starts, ends, 12)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = dh.normalize_rows_plain(dh.observe_segments_plain(data_t, starts, ends),
                                   torch.from_numpy(dh.segment_divisors(starts, ends)).to(cuda), 12)
    assert torch.equal(freq, want[0]) and torch.equal(cumul, want[1])


def _hist_launches(before: dict[str, int]) -> int:
    """Launches of each histogram kernel since `before` (a copy of
    build.LAUNCHES); raises if the two differ."""
    count, norm = (build.LAUNCHES[k] - before[k] for k in ("hist_count", "hist_normalize"))
    assert count == norm
    return count


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", sorted(TPX_GEOMS))
def test_tpx_device_tables_equal_authority(cuda, bits, case):
    """tpx encode on the card (`device_tables` either way) == the numpy
    authority (v2) or, for mixed geometry, the CPU tier's v3 megas, which
    the CPU tests hold to the authority; one launch of each histogram
    kernel a call."""
    geom = TPX_GEOMS[case]
    before = dict(build.LAUNCHES)
    if len(set(geom)) == 1:
        rows, steps, tiles = geom[0]
        p = TpxParams(bits=bits, rows=rows, steps=steps, tiles=tiles)
        data = text_like(np.random.default_rng(bits), 2 * p.mega_bytes + 999)
        blob = enc.tpx_encode_torch(data, p=p, device="cuda", device_tables=True)
        assert _hist_launches(before) == 1
        assert blob == tpx_encode(data, p=p) == enc.tpx_encode_torch(data, p=p, device="cuda")
        assert dec.tpx_decode_torch(blob, device="cuda") == data.tobytes()
        assert _hist_launches(before) == 2
    else:  # v3 megas of mixed geometry
        spans = [r * s * 128 * n for r, s, n in geom]
        data = text_like(np.random.default_rng(bits), sum(spans) - 5000)
        bases = np.cumsum([0, *spans[:-1]]).tolist()
        geoms = [(b, r, s, n, min(data.size - b, z)) for b, (r, s, n), z in zip(bases, geom, spans)]
        blob = enc._encode_megas(bytes(44), data, geoms, bits=bits, v3=True, devices=[cuda], layers=None)
        assert _hist_launches(before) == 1
        assert blob == enc._encode_megas(bytes(44), data, geoms, bits=bits, v3=True, devices=[torch.device("cpu")],
                                         layers=None)
        assert _hist_launches(before) == 1


def test_tpx_adaptive_device_tables_equals_authority(cuda):
    from pathlib import Path

    arr = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)[: 1 << 20]
    blob = enc.tpx_encode_adaptive_torch(arr, 12, device="cuda", device_tables=True)
    assert blob == tpx_encode_adaptive(arr, 12)
    assert dec.tpx_decode_torch(blob, device="cuda") == arr.tobytes()


@pytest.mark.parametrize("given", ("none", "every other", "all"))
def test_mt_plan_histograms_on_the_card(cuda, given):
    """mt encode on the card takes the histograms of plan rows without freqs
    with one launch of each histogram kernel (none where every row has
    its freqs), among the given rows; the blob == the CPU tier's == the
    blob of the same plan with every row's freqs taken on the host."""
    from hsrans_tpu.ops.tpx import make_tile_hist
    from hsrans_tpu_torch.ops.planner import BlockPlan

    data = text_like(np.random.default_rng(21), 300_000)
    cuts = [0, 4096, 10_048, 65_536, 65_600, 200_000, 300_000]  # whole lane groups: text holds no byte 0
    full = [BlockPlan(s, e - s, False, 0, make_tile_hist(data[s:e], 12).symbol_count) for s, e in zip(cuts, cuts[1:])]
    keep = {"none": lambda i: False, "every other": lambda i: i % 2 == 1, "all": lambda i: True}[given]
    plan = [r if keep(i) else BlockPlan(r.start, r.size, False, 0, None) for i, r in enumerate(full)]
    before = dict(build.LAUNCHES)
    blob = mte.mt_encode_torch(data, 12, plan=plan, device="cuda")
    assert _hist_launches(before) == int(given != "all")
    assert blob == mte.mt_encode_torch(data, 12, plan=plan, device="cpu") == mte.mt_encode_torch(data, 12, plan=full, device="cpu")
    assert mtd.mt_decode_torch(blob, 12, 64, device="cuda") == data.tobytes()


SCAN_CASES = [(case, n, bits) for case in chip_smoke.SCAN_EDGES for n, bits in chip_smoke.scan_case_shapes(case)]


@pytest.mark.parametrize(("case", "n", "bits"), SCAN_CASES)
def test_scan_kernels_equal_plain(cuda, case, n, bits):
    """The scan decode and encode kernels == their plain versions on
    chip_smoke.SCAN_EDGES, exact: per-stream and shared streams and tables,
    streams cut short (reads before their start wrap, past their end read
    0xFFFF), `__graft_entry__.entry`'s random tables, tables cut short of
    2^B slots (shared memory) and of 2^16 slots (the L1 route), reads that
    run into the stream ring's refills past W, encode divisors over all of
    u16 and states over all of u32."""
    rows = [chip_smoke.scan_check(kind, args, kw) for kind, args, kw in chip_smoke.scan_edge_operands(case, n, bits, cuda)]
    assert all(r["max_abs_err"] == 0 for r in rows)
    if case in ("short streams", "refills past W"):
        assert rows[0]["streams_read_past_w"] > 0


@pytest.mark.parametrize("n", (16, 32, 64))
def test_raw_round_trip_equals_authority(cuda, n):
    """raw_encode_torch on the card == the JAX package's numpy raw wire and
    the port's CPU tier; raw_decode_torch returns the input, and gives the
    CPU tier's outcome on a blob cut short with its header patched."""
    from hsrans_tpu.models.histogram import make_hist
    from hsrans_tpu.ops.reference import raw_encode_16w
    from hsrans_tpu_torch import raw_decode_torch, raw_encode_torch

    data = text_like(np.random.default_rng(n), (1 << 18) + 7)
    hist = make_hist(data, 12)
    before = dict(build.LAUNCHES)
    blob = raw_encode_torch(data, hist, n, device="cuda")
    assert blob == raw_encode_16w(data, hist, n) == raw_encode_torch(data, hist, n, device="cpu")
    assert raw_decode_torch(blob, 12, n, device="cuda") == data.tobytes()
    assert build.LAUNCHES["scan_encode"] - before["scan_encode"] == 1
    short = bytearray(blob[: len(blob) // 2])
    short[8:16] = len(short).to_bytes(8, "little")
    assert raw_decode_torch(bytes(short), 12, n, device="cuda") == raw_decode_torch(bytes(short), 12, n, device="cpu")


@pytest.mark.parametrize("n", (16, 32, 64))
def test_mt_device_chain_on_the_card(cuda, n):
    """mt_encode_device then mt_decode_device on the card, split over one
    and two devices (the card named twice): the input, the CPU tier's
    blob, and None for a coded block whose freqs do not sum to 2^B."""
    from hsrans_tpu_torch.parallel import sharded as psh

    data = text_like(np.random.default_rng(90 + n), 5 * 4096 + 301)
    plan = psh.uniform_plan(data, 12, n, 4096)
    blob = psh.mt_encode_device(data, 12, n, plan=plan, device="cuda")
    assert blob == psh.mt_encode_device(data, 12, n, plan=plan, device="cpu")
    assert psh.mt_encode_device(data, 12, n, plan=plan, devices=[cuda, cuda]) == blob
    for devices in ([cuda], [cuda, cuda]):
        assert psh.mt_decode_device(blob, 12, n, devices=devices) == data.tobytes()
        assert psh.scan_decode_blob(blob, 12, n, psh.resolve_all("cuda", devices)) == data.tobytes()
    bad = bytearray(blob)
    lo = 32 + 4 * n  # the first block's freqs
    freq = np.frombuffer(bytes(bad[lo : lo + 512]), "<u2").copy()
    freq[np.argmax(freq)] += 1
    bad[lo : lo + 512] = freq.astype("<u2").tobytes()
    assert psh.mt_decode_device(bytes(bad), 12, n, device="cuda") is None


def test_tpx_split_on_the_card(cuda):
    from hsrans_tpu_torch.parallel import tpx_sharded as ptpx

    p = TpxParams(bits=12, rows=8, lanes=128, steps=8, tiles=2)
    data = text_like(np.random.default_rng(17), 9 * p.mega_bytes + 777)
    blob = tpx_encode(data, p=p)
    for devices in ([cuda], [cuda, cuda], [cuda] * 3):
        assert ptpx.tpx_encode_device(data, p=p, devices=devices) == blob
        assert ptpx.tpx_decode_device(blob, devices=devices) == data.tobytes()


def test_cli_cuda_tier_on_the_card(cuda, tmp_path):
    """`python -m hsrans_tpu_torch.cli <file> --test` at B=12 on the card:
    every row OK, the tpx and mt dev rows through their kernels, the host
    rows through none, and every row's blob equal to the torch tier's."""
    from hsrans_tpu_torch import cli

    data = text_like(np.random.default_rng(13), (1 << 20) + 77)
    path = tmp_path / "t.bin"
    data.tofile(path)
    rc, rows, table = chip_smoke.cli_run([str(path), "--test", "--hist-min", "12", "--hist-max", "12"])
    assert rc == 0 and len(rows) == 12 and all(r["ok"] for r in rows), table
    for r in rows:
        kind = chip_smoke.cli_row_kind(r["name"])
        assert chip_smoke.CLI_ROW_KERNELS[kind] <= set(r["launches"]) if kind else not r["launches"], r
    argv = [str(path), "--test", "--hist-min", "12", "--hist-max", "12", "--backend"]
    card = cli._build_codecs(cli.parse_args(argv + ["device"]))
    cpu = {c["name"]: c for c in cli._build_codecs(cli.parse_args(argv + ["interpret"]))}
    head = data[: 1 << 18]
    for c in card:
        assert c["enc"](head) == cpu[c["name"]]["enc"](head), c["name"]
