"""mt encode in the PyTorch port (`hsrans_tpu_torch.mt_encode_torch` and
`parallel.sharded.mt_encode_device` on the CPU tier, i.e. the kernels' plain
versions) against the JAX package: the Pallas encoder in interpret mode
(`mt64_encode_tpu(..., interpret=True)`), the XLA scan encoder
(`mt_encode_device(mesh=None)`), the numpy group encoder
(`ops/reference.py::encode_groups`) and the mt decoders.  Exact equality
throughout: the codec is lossless, so the tolerance is zero."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu.kernels.mt64_encode import mt64_encode_tpu
from hsrans_tpu.models.histogram import complete_hist as j_complete_hist
from hsrans_tpu.ops import mt as jmt
from hsrans_tpu.ops.planner import BlockPlan as JPlan
from hsrans_tpu.ops.planner import plan_blocks
from hsrans_tpu.ops.reference import encode_groups as j_encode_groups
from hsrans_tpu.parallel import sharded as jsh
from hsrans_tpu_torch import mt_decode_torch, mt_encode_torch
from hsrans_tpu_torch.kernels import mt_encode as penc
from hsrans_tpu_torch.ops.planner import BlockPlan
from hsrans_tpu_torch.parallel import sharded as psh
from tools.gen_inputs import text_like

TESTS = Path(__file__).parent
CORPUS = TESTS / "corpus" / "corpus.bin"
XRAY = TESTS / "corpus" / "xray.bin"


def _port_plan(plan):
    return [BlockPlan(r.start, r.size, r.is_single, r.symbol, r.freq) for r in plan]


def _jax_plan(plan):
    return [JPlan(r.start, r.size, r.is_single, r.symbol, r.freq) for r in plan]


def _decodes(blob: bytes, data: np.ndarray, bits: int, n: int = 64) -> bool:
    """The blob decodes back to `data` under the JAX package's numpy decoder
    and under the port's CPU tier."""
    want = data.tobytes()
    return jmt.mt_decode(blob, bits, n) == want and mt_decode_torch(blob, bits, n, device="cpu") == want


@pytest.mark.parametrize(
    "name,size,block,oracle",
    [
        ("text", 200_000, 4096, "pallas"),
        ("odd-tail", 123_457, 4096, "scan"),
        ("8k-blocks", 100_000, 8192, "pallas"),
        ("sub-block", 700, 4096, "pallas"),
        ("empty", 0, 4096, "pallas"),
        ("136-blocks", 136 * 4096 + 100, 4096, "scan"),
        ("16k-blocks", 150_000, 16384, "scan"),
        ("32k-blocks", 150_000, 32768, "scan"),
    ],
)
def test_uniform_equals_pallas_encoder(name, size, block, oracle):
    """The cases of tests/test_mt64_encode_kernel.py: the port's blob equals
    the Pallas encoder's (interpret mode) and decodes.  Where a new Pallas
    shape would cost seconds of interpret-mode compile, the oracle is the
    XLA scan encoder on the same uniform plan, which that file holds equal
    to the Pallas encoder."""
    data = text_like(np.random.default_rng(13), size) if size else np.zeros(0, np.uint8)
    blob = mt_encode_torch(data, 12, block_size=block, device="cpu")
    if oracle == "pallas":
        assert blob == mt64_encode_tpu(data, 12, block_size=block, interpret=True)
    else:
        assert blob == jsh.mt_encode_device(data, 12, 64, plan=jsh.uniform_plan(data, 12, 64, block))
    assert _decodes(blob, data, 12)


@pytest.mark.parametrize("bits", (13, 15))
def test_high_bits_equal_pallas_encoder(bits):
    data = np.fromfile(CORPUS, np.uint8)[:150_000]
    blob = mt_encode_torch(data, bits, device="cpu")
    assert blob == mt64_encode_tpu(data, bits, interpret=True)
    assert _decodes(blob, data, bits)


def test_rle_input_equals_pallas_encoder():
    data = np.concatenate([np.full(60_000, 7, np.uint8), np.arange(5000, dtype=np.int64).astype(np.uint8)])
    blob = mt_encode_torch(data, 12, block_size=4096, device="cpu")
    assert blob == mt64_encode_tpu(data, 12, block_size=4096, interpret=True)
    assert _decodes(blob, data, 12)


def test_planner_plan_equals_pallas_encoder():
    """The reference planner's blocks (2^16-multiples, the last one not)."""
    data = np.fromfile(CORPUS, np.uint8)[: 512 * 1024]
    plan = plan_blocks(data, 12, "mt", 64)
    assert max(r.size for r in plan) >= 1 << 16
    blob = mt_encode_torch(data, 12, plan=_port_plan(plan), device="cpu")
    assert blob == mt64_encode_tpu(data, 12, interpret=True, plan=plan)
    assert _decodes(blob, data, 12)


def test_plan_with_rle_rows_equals_pallas_encoder():
    rng = np.random.default_rng(41)
    data = np.concatenate([text_like(rng, 8192), np.full(4096, 7, np.uint8), text_like(rng, 9000)])
    rows = [(0, 8192, False, 7), (8192, 4096, True, 7), (12288, 9000, False, 0)]
    blob = mt_encode_torch(data, 12, plan=[BlockPlan(s, z, r, y, None) for s, z, r, y in rows], device="cpu")
    assert blob == mt64_encode_tpu(data, 12, interpret=True, plan=[JPlan(s, z, r, y, None) for s, z, r, y in rows])
    assert _decodes(blob, data, 12)


def test_device_plan_equals_pallas_encoder():
    """A `device_plan` slice of x-ray mixes the Pallas kernel's size buckets
    with its host route (the final block, off-grid sizes) and an RLE row;
    the port takes every coded block in one launch and gives the same
    bytes."""
    from hsrans_tpu.kernels.mt64_encode import _kernel_block_ok

    data = np.fromfile(XRAY, np.uint8)[:600_000]
    plan = jsh.device_plan(data, 12, 64, 8 << 10)
    assert any(_kernel_block_ok(r.size) for r in plan[:-1] if not r.is_single)
    assert not _kernel_block_ok(plan[-1].size) and any(r.is_single for r in plan)
    blob = mt_encode_torch(data, 12, plan=_port_plan(plan), device="cpu")
    assert blob == mt64_encode_tpu(data, 12, interpret=True, plan=plan)
    assert _decodes(blob, data, 12)


def _odd_plan(length: int) -> list[tuple[int, int]]:
    cuts = [0, 1000, 5003, 9000, 20001, 33333, length]
    return [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(len(cuts) - 1)]


def test_odd_sizes_follow_the_pallas_encoders_host_route():
    """Non-final blocks whose sizes are not multiples of 64: the last group's
    lanes past the block's end code the byte 0 while they lie below the
    input's end, as mt64_encode_tpu's host route (ops/mt.py::_lane_groups)
    codes them.  Where byte 0 is in every block, the blob decodes and the
    port gives the same bytes.  Where a block's freqs give 0 no slot, the
    JAX package returns a blob that does not decode (a fault of the
    reference); the port raises ValueError instead."""
    text = text_like(np.random.default_rng(1), 50_000)
    zeros = text.copy()
    zeros[::97] = 0
    for data, round_trips in ((text, False), (zeros, True)):
        rows = _odd_plan(data.size)
        want = mt64_encode_tpu(data, 12, interpret=True, plan=[JPlan(s, z, False, 0, None) for s, z in rows])
        assert (jmt.mt_decode(want, 12, 64) == data.tobytes()) == round_trips
        plan = [BlockPlan(s, z, False, 0, None) for s, z in rows]
        if round_trips:
            blob = mt_encode_torch(data, 12, plan=plan, device="cpu")
            assert blob == want
            assert mt_decode_torch(blob, 12, 64, device="cpu") == data.tobytes()
        else:
            with pytest.raises(ValueError, match="plan row 0: .* would not decode"):
                mt_encode_torch(data, 12, plan=plan, device="cpu")


@pytest.mark.parametrize("n", (32, 64))
def test_device_encoder_equals_jax_on_odd_sizes(n):
    """mt_encode_device masks a partial group at the block's end, so the same
    odd plan round-trips there."""
    from hsrans_tpu_torch.ops.tpx import make_tile_hist

    data = text_like(np.random.default_rng(2), 50_000)
    plan = [BlockPlan(s, z, False, 0, make_tile_hist(data[s : s + z], 12).symbol_count) for s, z in _odd_plan(data.size)]
    blob = psh.mt_encode_device(data, 12, n, plan=plan, device="cpu")
    assert blob == jsh.mt_encode_device(data, 12, n, plan=_jax_plan(plan))
    assert _decodes(blob, data, 12, n)


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_device_encoder_equals_jax(bits, n):
    """The port's mt_encode_device == JAX mt_encode_device(mesh=None): uniform
    blocks (given as a plan and as uniform_block) and the reference planner's
    blocks, on text with single-symbol runs."""
    rng = np.random.default_rng(bits + n)
    data = np.concatenate([text_like(rng, 70_000), np.full(70_000, 9, np.uint8), text_like(rng, 40_001)])
    plan = jsh.uniform_plan(data, bits, n, 16384)
    cases = [
        (psh.mt_encode_device(data, bits, n, plan=_port_plan(plan), device="cpu"), jsh.mt_encode_device(data, bits, n, plan=plan)),
        (psh.mt_encode_device(data, bits, n, uniform_block=16384, device="cpu"), jsh.mt_encode_device(data, bits, n, uniform_block=16384)),
        (psh.mt_encode_device(data, bits, n, device="cpu"), jsh.mt_encode_device(data, bits, n)),
    ]
    for got, want in cases:
        assert got == want
        assert _decodes(got, data, bits, n)


def test_device_encoder_empty_and_tiny():
    for data in (np.zeros(0, np.uint8), text_like(np.random.default_rng(3), 70)):
        for n in (32, 64):
            assert psh.mt_encode_device(data, 12, n, device="cpu") == jsh.mt_encode_device(data, 12, n)


@pytest.mark.parametrize("rule", penc.RULES)
@pytest.mark.parametrize("n", (32, 64))
def test_plain_encoder_equals_encode_groups(n, rule):
    """encode_blocks_plain == ops/reference.py::encode_groups block by block
    (words, emit mask, final states), with the valid masks of each JAX
    encoder: up to the input's end ("groups") or the block's ("section")."""
    rng = np.random.default_rng(n)
    data = text_like(rng, 30_011)
    data[::50] = 0
    rows = [(0, 4096), (4096, 5000), (9096, 10_000), (19_096, 10_915)]
    plan = [BlockPlan(s, z, False, 0, None) for s, z in rows]
    kinds, ks, index, freqs, bias = penc.plan_operands(data, plan, 12, n, rule)
    assert bias.tolist() == [1, 1, 1, 2]
    words, count, fin = penc.encode_blocks_plain(
        torch.from_numpy(data), torch.from_numpy(index), torch.from_numpy(freqs.view(np.int16)),
        bits=12, n=n, rule=rule, words_cap=int(index[-1, 4]),
    )
    words = words.numpy().view(np.uint16)
    for i, (s, z) in enumerate(rows):
        end = s + z
        groups, valid = jmt._lane_groups(data, s, end, data.size, n)
        if rule == "section":
            valid = valid & ((s + np.arange(groups.shape[0])[:, None] * n + jmt.IDX2IDX[n][None, :]) < end)
        st = np.full(n, 1 << 15, np.uint32)
        w, e, st = j_encode_groups(st, groups, valid, j_complete_hist(freqs[i], 12))
        region_end = int(index[i, 4])
        assert int(count[i]) == int(e.sum())
        assert np.array_equal(words[region_end - int(count[i]) : region_end], w[e])
        assert np.array_equal(fin[i].numpy().view(np.uint32), st)


def test_place_plain_writes_the_coded_parts():
    """part_layout lays the blob out as its head, then each plan row's part
    (a coded block's header and words, a single-symbol row's indicator), and
    place_blocks_plain writes every u16 of it: the head's input length and
    blob bytes, size, offset, states, freqs and words at each block's u16
    offset, each indicator's u64."""
    n = 32
    index = torch.tensor([[0, 1, 32, 32, 32], [4128, 1, 4160, 4160, 64]], dtype=torch.int64)
    words = torch.arange(64, dtype=torch.int16)
    count = torch.tensor([2, 3], dtype=torch.int64)
    fin = torch.full((2, n), 0x12345678, dtype=torch.int32)
    freqs = torch.ones((2, 256), dtype=torch.int16)
    hdr = penc.coded_header_u16(n)
    plan = [BlockPlan(0, 32, False, 0, None), BlockPlan(32, 4096, True, 7, None), BlockPlan(4128, 32, False, 0, None)]
    kinds, ks, bias = np.array([2, 1, 2], np.int8), np.array([0, 2]), np.array([1, 2])
    place, out_u16 = penc.part_layout(plan, kinds, ks, bias, count.numpy(), n, 4160)
    ind = np.array([4096 | 1 << 63 | 7 << 54], np.uint64).view(np.int64)[0]
    assert out_u16 == 8 + 2 * hdr + 5 + 4
    assert place.tolist() == [[0, 4160, -1, 0], [4, 2 * out_u16, -1, 0], [8, 32, 0, 1], [8 + hdr + 2, ind, -1, 0],
                              [8 + hdr + 6, 32, 1, 2]]
    out = penc.place_blocks_plain(words, index, count, fin, freqs, torch.from_numpy(place), n=n, out_u16=out_u16)
    u16 = out.numpy().view(np.uint16)
    assert u16[:4].view(np.uint64)[0] == 4160 and u16[4:8].view(np.uint64)[0] == 2 * out_u16
    assert u16[8 + hdr + 2 : 8 + hdr + 6].view(np.int64)[0] == ind
    for b, (dest, w) in enumerate(((8, 2), (8 + hdr + 6, 3))):
        part = u16[dest : dest + hdr + w]
        assert part[:4].view(np.uint64)[0] == 32
        assert part[4:8].view(np.uint64)[0] == 2 * n + 256 + w - (1 + b)
        assert (part[8 : 8 + 2 * n].view(np.uint32) == 0x12345678).all()
        assert (part[8 + 2 * n : hdr] == 1).all()
        assert part[hdr:].tolist() == list(range(32 * (b + 1) - w, 32 * (b + 1)))


@pytest.mark.parametrize(
    "rows",
    [
        [(0, 4096, True, 3), (4096, 8192, False, 0), (12288, 9024, False, 0), (21312, 5000, True, 9)],
        [(0, 8192, False, 0), (8192, 4096, True, 7), (12288, 4096, True, 200), (16384, 9000, False, 0)],
    ],
    ids=["single first and last", "singles between"],
)
def test_blob_with_single_symbol_rows_equals_pallas_encoder(rows):
    """The placement writes the head and the single-symbol indicators with
    the coded parts: the blob equals the Pallas encoder's (interpret mode),
    the numpy parser finds each indicator where the plan has it, and the
    numpy decoder returns the input."""
    rng = np.random.default_rng(len(rows) + rows[0][1])
    parts = [np.full(z, y, np.uint8) if single else text_like(rng, z) for _, z, single, y in rows]
    data = np.concatenate(parts)
    blob = mt_encode_torch(data, 12, plan=[BlockPlan(s, z, r, y, None) for s, z, r, y in rows], device="cpu")
    assert blob == mt64_encode_tpu(data, 12, interpret=True, plan=[JPlan(s, z, r, y, None) for s, z, r, y in rows])
    length, _, blocks = jmt.block_index(blob, 64)
    assert length == data.size and int.from_bytes(blob[8:16], "little") == len(blob)
    assert [(b.is_single, b.symbol if b.is_single else 0) for b in blocks] == [(r, y if r else 0) for _, _, r, y in rows]
    assert _decodes(blob, data, 12)


def test_bad_arguments_raise():
    data = np.zeros(10, np.uint8)
    for bad in (1000, 12288, 768):  # the Pallas encoder's rejections
        with pytest.raises(ValueError):
            mt64_encode_tpu(data, 12, block_size=bad)
        with pytest.raises(ValueError):
            mt_encode_torch(data, 12, block_size=bad, device="cpu")
    for bits in (0, 16):
        with pytest.raises(ValueError):
            mt_encode_torch(data, bits, device="cpu")
    freq = np.zeros(256, np.uint16)
    freq[0] = 100  # does not sum to 2^12
    with pytest.raises(ValueError, match="plan row 0"):
        mt_encode_torch(data, 12, plan=[BlockPlan(0, 10, False, 0, freq)], device="cpu")


def test_magic_table_equals_div_magic():
    """The encode kernel's magic table holds the JAX package's
    `kernels/tpx_encode.py::div_magic` m for every divisor d in 1..2^15;
    d = 0 (a symbol of freq 0, coded as d = 1) holds d = 1's."""
    from hsrans_tpu.kernels.tpx_encode import div_magic

    table = penc.magic_table()
    assert table.shape == (penc.MAGIC_D_MAX + 1,) and table.dtype == np.uint32
    d = np.arange(1, penc.MAGIC_D_MAX + 1, dtype=np.int64)
    want = np.concatenate([div_magic(row)[0] for row in d.reshape(-1, 256)])
    assert np.array_equal(table[1:], want)
    assert table[0] == table[1] == 1 << 31


@pytest.mark.parametrize("xs", ("boundaries", "seeded"))
def test_magic_table_divides_exactly(xs):
    """(m * x) >> (31 + l) == x // d, l = ceil(log2 d), for every d in
    1..2^15 at x in {0, d - 1, d, 2^31 - 1} and at 64 seeded random x < 2^31
    per d: the kernel's quotient for every state x < 2^31."""
    table = penc.magic_table().astype(np.uint64)
    d = np.arange(1, penc.MAGIC_D_MAX + 1, dtype=np.uint64)
    l = np.array([int(v - 1).bit_length() for v in d], np.uint64)
    if xs == "boundaries":
        x = np.stack([np.zeros_like(d), d - 1, d, np.full_like(d, (1 << 31) - 1)], axis=1)
    else:
        x = np.random.default_rng(5).integers(0, 1 << 31, (d.size, 64), dtype=np.uint64)
    q = (table[1:, None] * x) >> (np.uint64(31) + l[:, None])
    assert np.array_equal(q, x // d[:, None])


@pytest.mark.parametrize("given", ("none", "every other"))
def test_plan_rows_without_freqs_give_the_same_bytes(given):
    """Plan rows without freqs get the histogram of their bytes: the blob
    == the same plan with every row's freqs taken by the host's
    make_tile_hist, and == the Pallas encoder's on the plan as given."""
    from hsrans_tpu.ops.tpx import make_tile_hist

    data = text_like(np.random.default_rng(21), 90_000)
    cuts = [0, 4096, 10_048, 40_000, 40_064, 90_000]  # whole lane groups: text holds no byte 0
    full = [BlockPlan(s, e - s, False, 0, make_tile_hist(data[s:e], 12).symbol_count) for s, e in zip(cuts, cuts[1:])]
    plan = [r if given == "every other" and i % 2 else BlockPlan(r.start, r.size, False, 0, None) for i, r in enumerate(full)]
    blob = mt_encode_torch(data, 12, plan=plan, device="cpu")
    assert blob == mt_encode_torch(data, 12, plan=full, device="cpu")
    assert blob == mt64_encode_tpu(data, 12, plan=_jax_plan(plan), interpret=True)
    assert _decodes(blob, data, 12)
