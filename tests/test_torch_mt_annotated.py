"""The annotated-stream route of mt decode in the PyTorch port (the module
flag `_PAIR_V2` of `hsrans_tpu_torch.kernels.mt_decode`, on the CPU tier,
i.e. the plain versions of its two kernels) against the JAX package: the
Pallas `_annotate_pairs` and `_decode_pairs_v2` in interpret mode, the rank
route, the numpy oracle `mt_decode_py` and the C++ reference's golden blobs.
Exact equality throughout: the codec is lossless, so the tolerance is zero.

The JAX package's own `_PAIR_V2` route does not run as it stands: its
`_decode_pairs_v2` lacks the `same_tab` and `cb16` keywords that
`build_pair_arrays` hands it, and where `cb16` is on (B=10, and B=11 with
one table for both blocks of a pair) its `_annotate_pairs` reads the packed
16-slot table as 32-slot c0.  So it is held against the port only through a
wrapper that drops the two keywords, at B=12 and at B=11 with a table per
block; the last two tests pin the fault (ROADMAP queue 3)."""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hsrans_tpu.kernels import mt64_decode as jdec
from hsrans_tpu.ops import mt as jmt
from hsrans_tpu.parallel import sharded as jsh
from hsrans_tpu_torch import mt_decode_torch
from hsrans_tpu_torch.kernels import mt_decode as pdec
from hsrans_tpu_torch.ops import mt as pmt
from hsrans_tpu_torch.parallel import sharded as psh
from tools.gen_inputs import text_like

from .test_torch_mt_decode import _case_input, _case_plan, _golden_blobs, _golden_case, _malformed, _operands

# 15 blocks of 4 KiB and 300 bytes: 14 kernel blocks pair into seven rows
PAIR_SIZE = 15 * 4096 + 300


@pytest.fixture
def annotated(monkeypatch):
    monkeypatch.setattr(pdec, "_PAIR_V2", True)


@pytest.fixture
def jax_pair_v2(monkeypatch):
    """The JAX package's `_PAIR_V2` route, its `_decode_pairs_v2` wrapped
    to drop the two keywords it lacks; gives the list of the `cb16` each
    call was handed."""
    calls = []
    v2 = jdec._decode_pairs_v2

    def wrapped(*args, same_tab=None, cb16=None, **kw):
        calls.append(cb16)
        return v2(*args, **kw)

    monkeypatch.setattr(jdec, "_PAIR_V2", True)
    monkeypatch.setattr(jdec, "_decode_pairs_v2", wrapped)
    return calls


def _pair_blob(bits: int) -> tuple[np.ndarray, bytes]:
    data = text_like(np.random.default_rng(PAIR_SIZE), PAIR_SIZE)
    return data, jmt.mt_encode_py(data, bits, 64, jsh.uniform_plan(data, bits, 64, 4096))


def _pallas_annotate(arrs: list[np.ndarray], kw: dict) -> np.ndarray:
    """`_annotate_pairs` under the grid and specs of `_decode_pairs_v2`
    (hsrans_tpu/kernels/mt64_decode.py:1412-1423), in interpret mode."""
    c0a, c0b, bma, bmb, stream = (jnp.asarray(arrs[i]) for i in (0, 1, 2, 3, 8))
    g_rows, n_groups, w_chunks, bits = kw["g_rows"], kw["n_groups"], kw["w_chunks"], kw["bits"]
    row_spec = pl.BlockSpec((g_rows, 128), lambda g, c: (g, 0), memory_space=pltpu.VMEM)
    ca = 2 * w_chunks
    ann = pl.pallas_call(
        functools.partial(jdec._annotate_pairs, g_rows=g_rows, bits=bits),
        grid=(n_groups, ca),
        in_specs=[pl.BlockSpec((1, g_rows, 128), lambda g, c: (c // 2, g, 0), memory_space=pltpu.VMEM)]
        + [row_spec] * 4,
        out_specs=pl.BlockSpec((1, g_rows, 128), lambda g, c: (c, g, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ca, n_groups * g_rows, 128), jnp.int32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True,
    )(stream, c0a, c0b, bma, bmb)
    return np.asarray(ann)


@pytest.mark.parametrize("bits", (11, 12))
def test_annotate_plain_equals_pallas_annotate_pairs(bits):
    """Pallas #6 against the port's annotate_plain on a pair bucket's
    operands: ann[c, p, 64*hi + j] is word 64c + j of block 2p + hi; the
    lanes past a block's words are padding and are not compared."""
    _, blob = _pair_blob(bits)
    length, stream, blocks = jmt.block_index(blob, 64)
    coded = [b for b in blocks if not b.is_single]
    kernel_blocks = coded[: (len(coded) - 1) // 2 * 2]
    w_counts = jdec.block_word_counts(blocks, kernel_blocks, stream, 64)
    arrs, kw = jdec.build_pair_arrays(kernel_blocks, w_counts, stream, bits)
    assert not kw["cb16"] and not kw["same_tab"] and len(kernel_blocks) == 14
    want = _pallas_annotate(arrs, kw)

    _, _, pcoded, index, (words, index_t, _, fc_t) = _operands(blob, bits, 64)
    got = pdec.annotate_plain(words, index_t, fc_t, bits=bits).numpy()
    for i, (b, w) in enumerate(zip(kernel_blocks, w_counts)):
        assert pcoded[i].word_start == b.word_start and int(index[i, 1] - index[i, 0]) == w
        p, hi = divmod(i, 2)
        lanes = want[:, p, 64 * hi : 64 * hi + 64].reshape(-1)[:w]
        assert np.array_equal(got[b.word_start : b.word_start + w], lanes), i


@pytest.mark.parametrize("bits", (11, 12))
def test_route_equals_jax_pair_v2(bits, annotated, jax_pair_v2):
    """Pallas #6 + #7 through `mt64_decode_tpu` with `_PAIR_V2` on, and the
    port's annotated route, on uniform 4 KiB blocks: both give the input."""
    data, blob = _pair_blob(bits)
    want = jdec.mt64_decode_tpu(blob, bits, interpret=True)
    assert jax_pair_v2 == [False]  # one pair bucket, through _decode_pairs_v2, cb16 off
    assert want == data.tobytes()
    assert mt_decode_torch(blob, bits, 64, device="cpu") == want


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("kind", ("uniform", "odd-tail", "rle", "device-plan"))
@pytest.mark.parametrize("bits", range(10, 16))
def test_route_equals_rank_route_and_oracle(bits, kind, n, annotated, monkeypatch):
    """Uniform and device_plan blocks, odd tails and single-symbol runs at
    every depth and width: the rank route's bytes, and mt_decode_py's."""
    data = _case_input(kind, np.random.default_rng(bits * 5 + n))
    blob = pmt.mt_encode_py(data, bits, n, _case_plan(kind, data, bits, n))
    got = mt_decode_torch(blob, bits, n, device="cpu")
    assert got == data.tobytes()
    assert got == jmt.mt_decode_py(blob, bits, n)
    monkeypatch.setattr(pdec, "_PAIR_V2", False)
    assert mt_decode_torch(blob, bits, n, device="cpu") == got


@pytest.mark.parametrize("path", _golden_blobs(), ids=lambda p: p.stem)
def test_route_decodes_golden_blobs(path, annotated):
    data, bits, n = _golden_case(path)
    blob = path.read_bytes()
    got = mt_decode_torch(blob, bits, n, device="cpu")
    assert got == data.tobytes()
    assert got == jmt.mt_decode_py(blob, bits, n)


@pytest.mark.parametrize("bits,n", [(12, 64), (14, 32)])
def test_malformed_none_where_rank_route_none(bits, n, monkeypatch):
    """The annotated route gives None exactly where the rank route does, and
    otherwise the same bytes."""
    rng = np.random.default_rng(bits)
    data = text_like(rng, 9 * 4096 + 50)
    blob = pmt.mt_encode_py(data, bits, n, psh.uniform_plan(data, bits, n, 4096))
    seen = set()
    for name, bad in _malformed(blob, n, rng):
        monkeypatch.setattr(pdec, "_PAIR_V2", False)
        want = mt_decode_torch(bad, bits, n, device="cpu")
        monkeypatch.setattr(pdec, "_PAIR_V2", True)
        got = mt_decode_torch(bad, bits, n, device="cpu")
        assert got == want, name
        seen.add(got is None)
    assert seen == {True, False}


@pytest.mark.parametrize("bits,n", [(10, 64), (12, 32), (13, 64), (15, 32)])
def test_annotated_plain_equals_rank_plain(bits, n):
    """decode_blocks_annotated_plain(annotate_plain(...)) == decode_blocks_plain
    in out, final states and cursors: on device_plan blocks, with every
    other block's word_end cut short, and on a word region cut to a third,
    where reads past the end give word 0 and rank 0 (rank_of(0) = 0)."""
    rng = np.random.default_rng(bits + n)
    data = text_like(rng, 120_000)
    blob = pmt.mt_encode_py(data, bits, n, psh.device_plan(data, bits, n, 8 << 10))
    length, _, coded, index, (words, index_t, states, fc) = _operands(blob, bits, n)
    assert len(coded) > 4
    cut_ends = index_t.clone()
    cut_ends[::2, 1] -= (cut_ends[::2, 1] - cut_ends[::2, 0]) // 3
    kw = {"bits": bits, "n": n, "length": length}
    for ix, region in ((index_t, words), (cut_ends, words), (index_t, words[: words.numel() // 6 * 2])):
        ann = pdec.annotate_plain(region, ix, fc, bits=bits)
        got = pdec.decode_blocks_annotated_plain(ann, ix, states, fc, **kw)
        want = pdec.decode_blocks_plain(region, ix, states, fc, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
@pytest.mark.parametrize("case", [c for c in chip_smoke.DECODE_EDGES if c != "one 1 MiB block"])
def test_annotated_plain_equals_rank_plain_at_window_edges(case, bits, n):
    """annotate_plain then decode_blocks_annotated_plain == decode_blocks_plain
    (bytes, final states, cursors) on the cases that hold the kernels'
    shared-memory windows at their edges (`chip_smoke.decode_edge_operands`,
    which the card runs against the kernels): word regions shifted by 0..7
    words (every phase of a u32 annotation word in 16 bytes), blocks shorter
    than a window half, word regions cut mid-group.  The 1 MiB block is
    left to the card for time."""
    for name, (words, index, states, fc), kw in chip_smoke.decode_edge_operands(case, bits, n, torch.device("cpu")):
        ann = pdec.annotate_plain(words, index, fc, bits=bits)
        got = pdec.decode_blocks_annotated_plain(ann, index, states, fc, **kw)
        want = pdec.decode_blocks_plain(words, index, states, fc, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_annotation_marks_block_words_only():
    """Words of coded blocks carry word | rank << 16, every other word (the
    headers, single-symbol blocks) is 0; rank is the present symbol's
    index, as `make_rank_tables` defines it."""
    from hsrans_tpu.models.histogram import complete_hist
    from hsrans_tpu.ops.tpx import make_cumul_inv

    rng = np.random.default_rng(4)
    data = np.concatenate([text_like(rng, 30_000), np.full(20_000, 9, np.uint8), text_like(rng, 30_001)])
    blob = pmt.mt_encode_py(data, 12, 64, psh.device_plan(data, 12, 64, 8 << 10))
    length, stream, coded, index, (words, index_t, _, fc) = _operands(blob, 12, 64)
    ann = pdec.annotate_plain(words, index_t, fc, bits=12).numpy().view(np.uint32)
    seen = np.zeros(ann.size, bool)
    for b, (ws, we) in zip(coded, index[:, :2]):
        w = stream[ws:we].astype(np.uint32)
        inv = make_cumul_inv(complete_hist(b.freq, 12))
        rank = np.cumsum(b.freq != 0)[inv[w & 0xFFF]] - 1
        assert np.array_equal(ann[ws:we], w | rank.astype(np.uint32) << 16)
        seen[ws:we] = True
    assert not ann[~seen].any() and (~seen).sum() > 4 * 64
    assert pdec.annotate(words[:0], index_t, fc, bits=12).numel() == 0


def test_layers_and_empty(annotated):
    """The annotated route clocks the annotate launch apart; a blob of
    single-symbol blocks only and an empty one decode as on the rank route."""
    data = text_like(np.random.default_rng(2), 50_000)
    blob = pmt.mt_encode_py(data, 12, 64)
    layers = {}
    assert mt_decode_torch(blob, 12, 64, device="cpu", layers=layers) == data.tobytes()
    assert set(layers) == {"host_index", "host_tables", "h2d", "kernel_annotate", "kernel", "d2h", "host_assemble"}
    runs = np.full(300_000, 42, np.uint8)
    assert mt_decode_torch(pmt.mt_encode_py(runs, 12, 64), 12, 64, device="cpu") == runs.tobytes()
    assert mt_decode_torch(pmt.mt_encode_py(b"", 12, 64), 12, 64, device="cpu") == b""
    z = torch.zeros((0, 256), dtype=torch.int32)
    ann = pdec.annotate(torch.zeros(10, dtype=torch.uint8), torch.zeros((0, 5), dtype=torch.int64), z, bits=12)
    assert ann.shape == (5,) and not ann.any()
    out, fin, cursor = pdec.decode_blocks_annotated(
        ann, torch.zeros((0, 5), dtype=torch.int64), torch.zeros((0, 64), dtype=torch.int32), z, bits=12, n=64, length=10
    )
    assert out.shape == (10,) and not out.any() and fin.shape == (0, 64) and cursor.shape == (0,)


# ------------------------------------------------- the reference's fault, pinned


def test_reference_pair_v2_lacks_table_keywords(monkeypatch):
    """ROADMAP queue 3: with `_PAIR_V2` on, `mt64_decode_tpu` raises, since
    `_decode_pairs_v2` takes neither `same_tab` nor `cb16`.  A fix in the
    JAX package makes this test fail: then hold the route without the
    wrapper."""
    monkeypatch.setattr(jdec, "_PAIR_V2", True)
    _, blob = _pair_blob(12)
    with pytest.raises(TypeError, match="unexpected keyword argument"):
        jdec.mt64_decode_tpu(blob, 12, interpret=True)


def test_reference_pair_v2_misreads_cb16_at_b10(jax_pair_v2, annotated):
    """ROADMAP queue 3: at B=10 `build_pair_arrays` puts the packed cb16
    table in c0a, which `_annotate_pairs` and the v2 kernel still read as
    32-slot c0, so the JAX route's bytes differ from the input from byte 0.
    The port's route gives the input."""
    data, blob = _pair_blob(10)
    got = jdec.mt64_decode_tpu(blob, 10, interpret=True)
    assert jax_pair_v2 == [True]
    diff = np.nonzero(np.frombuffer(got, np.uint8) != data)[0]
    assert len(got) == data.size and diff[0] == 0
    assert mt_decode_torch(blob, 10, 64, device="cpu") == data.tobytes()
