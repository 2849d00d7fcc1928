"""tpx encode of the PyTorch port (CPU tier: the kernels' plain versions)
against the JAX package's Pallas kernels in interpret mode and the numpy
wire authority.  Exact equality: the codec is lossless, so the tolerance
is zero."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hsrans_tpu.kernels import tpx_encode as jx
from hsrans_tpu.ops import tpx as jtpx
from hsrans_tpu.ops.tpx import MAGIC3, TpxParams, _mega_layout, tpx_decode, tpx_encode, tpx_encode_adaptive
from hsrans_tpu_torch.kernels import tpx_encode as pt
from hsrans_tpu_torch.kernels.tpx_decode import tpx_decode_torch
from tools.gen_inputs import text_like

CORPUS = Path(__file__).parent / "corpus" / "corpus.bin"
# the adversarial divisors of tests/test_tpx_encode_kernel.py
DIVISORS = [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 255, 256, 257, 1023, 1024, 4095, 4096, 32767, 32768]


def small(bits: int) -> TpxParams:
    return TpxParams(bits=bits, rows=8, lanes=128, steps=8, tiles=2)


def _case(name: str, bits: int) -> tuple[np.ndarray, TpxParams]:
    """The geometries of tests/test_tpx_encode_kernel.py."""
    p = small(bits)
    rng = np.random.default_rng(11)
    if name == "partial-tile":
        return text_like(rng, 777), p
    if name == "one-mega-exact":
        return text_like(rng, p.mega_bytes), p
    if name == "multi-mega":
        return text_like(rng, 2 * p.mega_bytes + 333), p
    if name == "empty":
        return np.zeros(0, np.uint8), p
    if name == "rle-heavy":
        return np.concatenate([np.full(p.mega_bytes // 2, 7, np.uint8), np.arange(999).astype(np.uint8)]), p
    assert name == "rows-136"  # rows that 128 does not divide
    p = TpxParams(bits=bits, rows=136, lanes=128, steps=4, tiles=1)
    return text_like(np.random.default_rng(33), p.mega_bytes), p


def _operands(data: np.ndarray, geoms: list, bits: int) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """`mega_operands` on the CPU, as numpy: (desc, wire freqs uint16 [T,
    256], the encode tables {fc, m, l} int32 [T, 256])."""
    desc, freqs, *tabs = pt.mega_operands(torch.from_numpy(data), geoms, bits=bits)
    return desc, freqs.numpy().view(np.uint16), dict(zip(("fc", "m", "l"), (t.numpy() for t in tabs)))


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("name", ("partial-tile", "one-mega-exact", "multi-mega", "empty", "rle-heavy", "rows-136"))
def test_encode_equals_pallas_and_authority(name, bits):
    data, p = _case(name, bits)
    got = pt.tpx_encode_torch(data, p=p, device="cpu")
    assert got == tpx_encode(data, p=p)
    assert got == jx.tpx_encode_tpu(data, p=p, interpret=True)
    assert tpx_decode_torch(got, device="cpu") == data.tobytes()


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_encode_mega_and_concat_plain_equal_pallas_kernels(bits):
    """Phase A: windows, counts and final states of the one-call plain
    version, reading the input as it is, equal the Pallas encode kernel's on
    the zero-padded mega (counts after _unpack_counts).  Phase B: the plain
    wire writer's section equals the JAX package's from the same windows:
    the Pallas concat kernel's rectangular streams, then `_write_mega`."""
    p = small(bits)
    n_tiles, rows, steps = p.tiles, p.rows, p.steps
    data = text_like(np.random.default_rng(bits), p.mega_bytes - 1000)
    desc, freqs, tabs = _operands(data, [(0, rows, steps, n_tiles, data.size)], bits)
    n_valid = int(desc[0, pt.ENCODE_FIELDS.index("vlen")])
    packed = np.zeros(p.mega_bytes, np.uint8)
    packed[: data.size] = data
    packed = packed.view(np.int32).reshape(n_tiles, rows, steps // 4 * 128)

    def chunks(tab):  # [T, 256] -> the Pallas kernel's (lo, hi) [T, 8, 128] operands
        lo, hi = np.zeros((2, n_tiles, 8, 128), np.int32)
        lo[:, 0], hi[:, 0] = tab[:, :128], tab[:, 128:]
        return lo, hi

    win_j, cntp_j, st_j = jx._encode_mega(
        np.array([[n_valid]], np.int32), *chunks(tabs["fc"]), *chunks(tabs["m"]), *chunks(tabs["l"]), packed,
        rows=rows, s4c=steps // 4, n_tiles=n_tiles, bits=bits, interpret=True,
    )
    cnt_j = jx._unpack_counts(cntp_j, s4c=steps // 4)
    outs = pt.encode_mega_plain(torch.from_numpy(data), desc, *(torch.from_numpy(tabs[k]) for k in ("fc", "m", "l")), bits=bits)
    ((win, cnt, st),) = pt.mega_views(*outs, desc)
    assert np.array_equal(win.numpy(), np.asarray(win_j))
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_j)[:, :, :steps])
    assert np.array_equal(st.numpy().view(np.uint32), np.asarray(st_j))

    counts = cnt.sum(dim=2).numpy()
    w_slots = pt.wire_w_slots(int(counts.max()))
    wcap = steps * 128 // 2
    stream_j = np.asarray(
        jx._concat_mega(np.array([[wcap // 128]], np.int32), win_j, cnt_j, rows=rows, rc=rows, steps=steps, wcap=wcap, n_tiles=n_tiles, interpret=True)
    )
    assert not stream_j[:, :, w_slots:].any()
    want = bytearray()
    jtpx._write_mega(want, n_tiles, w_slots, np.asarray(st_j), freqs, counts, stream_j[:, :, :w_slots])
    wdesc, row_at, out_u16 = pt.wire_layout(desc, counts.reshape(-1).astype(np.int64), v3=False, base=0)
    got = pt.write_wire_plain(*outs, torch.from_numpy(freqs.view(np.int16)), wdesc, row_at, v3=False, out_u16=out_u16)
    assert got.numpy().tobytes() == bytes(want)


# (v3, [(rows, steps, n_tiles)] of each mega): v2 with a last mega of fewer
# tiles, partly past the data; v3 with mixed geometry and a 13-row mega,
# whose section's length is 2 mod 4, so the section after it starts at an
# offset of 2 mod 4
WIRE_CASES = {
    "v2 multi-mega partial": (False, ((40, 8, 3), (40, 8, 3), (40, 8, 2))),
    "v3 mixed geometry 13 rows": (True, ((16, 8, 2), (13, 4, 3), (8, 8, 1))),
}


def _pallas_sections(win, cnt, states, desc, freqs, v3: bool) -> bytes:
    """The megas' wire sections as the JAX package writes them from the
    same windows: the Pallas concat kernel (interpret mode), then
    `_write_mega`, with v3 each after its u32 rows | u32 steps."""
    out = bytearray()
    for (_, rows, steps, n_tiles, _, tab0, *_), (w, c, st) in zip(desc.tolist(), pt.mega_views(win, cnt, states, desc)):
        counts = c.sum(dim=2).numpy()
        w_slots = pt.wire_w_slots(int(counts.max()))
        wcap = steps * 64
        cpad = np.zeros((n_tiles, rows, 128), np.int32)
        cpad[:, :, :steps] = c.numpy()
        stream = np.asarray(jx._concat_mega(np.array([[wcap // 128]], np.int32), w.numpy(), cpad, rows=rows, rc=rows,
                                            steps=steps, wcap=wcap, n_tiles=n_tiles, interpret=True))
        if v3:
            out += rows.to_bytes(4, "little") + steps.to_bytes(4, "little")
        jtpx._write_mega(out, n_tiles, w_slots, st.numpy().view(np.uint32), freqs[tab0 : tab0 + n_tiles], counts,
                         stream[:, :, :w_slots])
    return bytes(out)


@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_writer_equals_pallas_concat_and_write_mega(case, bits):
    """The plain wire writer, every mega in one call behind the 44-byte
    header, writes the bytes the JAX package writes from the same encode
    outputs (the Pallas concat kernel, then `_write_mega`), and the whole
    blob equals the numpy authority's (`tpx_encode`; for v3,
    `_encode_mega_into` mega by mega)."""
    v3, geom = WIRE_CASES[case]
    spans = [rows * steps * 128 * n for rows, steps, n in geom]
    data = text_like(np.random.default_rng(bits), sum(spans) - 3000)
    if v3:
        bases = np.cumsum([0, *spans[:-1]]).tolist()
        geoms = [(b, rows, steps, n, min(data.size - b, z)) for b, (rows, steps, n), z in zip(bases, geom, spans)]
        head = MAGIC3 + data.size.to_bytes(8, "little") + bytes(8)
        head += b"".join(v.to_bytes(4, "little") for v in (bits, geom[0][0], 128, geom[0][1], geom[0][2]))
    else:
        p = TpxParams(bits=bits, rows=geom[0][0], steps=geom[0][1], tiles=geom[0][2])
        geoms = [(b, p.rows, p.steps, n, valid) for b, n, valid in _mega_layout(data.size, p)]
        assert [g[3] for g in geoms] == [n for _, _, n in geom]
        head = bytes(jtpx.tpx_header(data.size, p))
    desc, freqs, tabs = _operands(data, geoms, bits)
    win, cnt, states = pt.encode_mega_plain(torch.from_numpy(data), desc, *(torch.from_numpy(tabs[k]) for k in ("fc", "m", "l")),
                                            bits=bits)
    row_words = torch.cat([c.sum(dim=2).reshape(-1) for _, c, _ in pt.mega_views(win, cnt, states, desc)]).numpy()
    wdesc, row_at, out_u16 = pt.wire_layout(desc, row_words, v3=v3, base=len(head) // 2)
    got = pt.write_wire_plain(win, cnt, states, torch.from_numpy(freqs.view(np.int16)), wdesc, row_at, v3=v3,
                              out_u16=out_u16).numpy()
    assert not got[: len(head)].any()
    assert got[len(head) :].tobytes() == _pallas_sections(win, cnt, states, desc, freqs, v3)
    if v3:
        assert (2 * wdesc[:, pt.WIRE_FIELDS.index("sec_off")] % 4 == 2).any()
    blob = pt._encode_megas(head, data, geoms, bits=bits, v3=v3, devices=[torch.device("cpu")], layers=None)
    if v3:
        want = bytearray(head)
        for base, rows, steps, n_tiles, valid in geoms:
            want += rows.to_bytes(4, "little") + steps.to_bytes(4, "little")
            jtpx._encode_mega_into(want, data, base, n_tiles, valid, bits, rows, steps)
        want[16:24] = len(want).to_bytes(8, "little")
    else:
        want = tpx_encode(data, p=p)
    assert blob == bytes(want)
    assert tpx_decode_torch(blob, device="cpu") == data.tobytes()


def test_copied_div_magic_equals_original():
    """The port's form of `div_magic`, the mt encoder's magic and shift
    tables read at each freq (`enc_tables_device` gathers m and l so), ==
    the JAX package's `div_magic`, and the magic is exact for those
    divisors over u31 states."""
    from hsrans_tpu_torch.kernels.mt_encode import magic_table, shift_table

    freq = np.zeros(256, dtype=np.uint16)
    freq[: len(DIVISORS)] = DIVISORS
    d = np.maximum(freq, 1)
    m, l = magic_table()[d], shift_table()[d]
    jm, jl = jx.div_magic(freq)
    assert np.array_equal(m, jm) and np.array_equal(l.astype(np.uint32), jl)
    ns = np.concatenate([np.random.default_rng(0).integers(0, 1 << 31, 20_000), [0, 1, (1 << 31) - 1, 1 << 15, 1 << 16, 1 << 30]])
    for i, d in enumerate(DIVISORS):
        q = (ns.astype(object) * int(m[i])) >> (31 + int(l[i]))
        assert np.array_equal(q.astype(np.int64), ns // d), d


@pytest.mark.parametrize("bits", (10, 12, 13, 15))
def test_copied_enc_tables_equal_original(bits):
    """`mega_operands` (the tiles' histograms and tables, on the CPU) ==
    the JAX package's host path: `make_tile_hist` of each tile, then
    `make_enc_tables_batch`, on two megas, the second a run of one byte
    whose last tile lies wholly past the input (the 1-symbol histogram)."""
    from hsrans_tpu.ops.tpx import make_tile_hist

    p = small(bits)
    tile = p.rows * p.steps * 128
    rng = np.random.default_rng(bits)
    data = np.concatenate([text_like(rng, p.mega_bytes), np.full(tile // 2, 9, np.uint8)])
    geoms = [(0, p.rows, p.steps, 2, p.mega_bytes), (p.mega_bytes, p.rows, p.steps, 2, tile // 2)]
    desc, freqs, tabs = _operands(data, geoms, bits)
    _, starts, ends = pt.mega_segments(geoms)
    assert (ends <= starts).any()
    hists = [make_tile_hist(data[s:e], bits) for s, e in zip(starts, ends)]
    want = jx.make_enc_tables_batch(np.stack([h.symbol_count for h in hists]), np.stack([h.cumul for h in hists]), bits)
    assert np.array_equal(freqs, np.stack([h.symbol_count for h in hists]))
    assert tabs.keys() == want.keys()
    for k in tabs:
        assert tabs[k].dtype == want[k].dtype and np.array_equal(tabs[k], want[k]), k


def test_adaptive_encode_equals_authority():
    arr = np.fromfile(CORPUS, np.uint8)[: 1 << 20]
    got = pt.tpx_encode_adaptive_torch(arr, 12, device="cpu")
    assert got == tpx_encode_adaptive(arr, 12)
    assert tpx_decode(got) == arr.tobytes()


def test_encode_rejects_bad_geometry():
    with pytest.raises(ValueError):
        pt.tpx_encode_torch(b"abc", p=TpxParams(bits=12, rows=8, lanes=64, steps=8, tiles=1), device="cpu")
    with pytest.raises(ValueError):
        pt.tpx_encode_torch(b"abc", p=TpxParams(bits=12, rows=8, lanes=128, steps=6, tiles=1), device="cpu")
    with pytest.raises(ValueError):
        pt.tpx_encode_torch(b"abc", bits=16, device="cpu")
    with pytest.raises(ValueError):
        pt.tpx_encode_adaptive_torch(b"abc", bits=9, device="cpu")


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_device_tables_equals_pallas_device_tables(bits):
    """The port's blob (the per-tile histograms, their normalization and
    the encode tables made by models/device_hist.py's plain versions on the
    CPU) == the JAX package's `tpx_encode_tpu(..., device_tables=True)`
    (models/jax_hist, Pallas in interpret mode) == the numpy authority's,
    with `device_tables` either way, on tests/test_tpx_encode_kernel.py's
    geometry."""
    p = small(bits)
    data = text_like(np.random.default_rng(17), 2 * p.mega_bytes + 333)
    got = pt.tpx_encode_torch(data, p=p, device="cpu", device_tables=True)
    assert got == jx.tpx_encode_tpu(data, p=p, interpret=True, device_tables=True)
    assert got == pt.tpx_encode_torch(data, p=p, device="cpu", device_tables=False) == tpx_encode(data, p=p)
    assert tpx_decode_torch(got, device="cpu") == data.tobytes()


def test_adaptive_device_tables_equals_pallas_device_tables():
    arr = np.fromfile(CORPUS, np.uint8)[:60_000]
    got = pt.tpx_encode_adaptive_torch(arr, 12, device="cpu", device_tables=True)
    assert got == jx.tpx_encode_adaptive_tpu(arr, 12, interpret=True, device_tables=True)
    assert got == tpx_encode_adaptive(arr, 12)


def test_device_tables_layers():
    """The histogram layer is kernel_hist, after the input's h2d, with
    `device_tables` either way, and the blob is the authority's (v2 and
    v3)."""
    data = text_like(np.random.default_rng(3), 70_000)
    host, dev = {}, {}
    assert pt.tpx_encode_torch(data, device="cpu", layers=host) == pt.tpx_encode_torch(
        data, device="cpu", layers=dev, device_tables=True) == tpx_encode(data)
    assert list(dev) == list(host) == ["h2d", "kernel_hist", "kernel_encode", "host_layout", "kernel_concat",
                                       "host_mux", "d2h"]
    v3 = {}
    assert pt.tpx_encode_adaptive_torch(data, device="cpu", layers=v3, device_tables=True) == tpx_encode_adaptive(data)
    assert set(v3) == set(dev)
