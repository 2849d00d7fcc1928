"""The port's device fan-out (`hsrans_tpu_torch.parallel.sharded`,
`parallel.tpx_sharded`) against the JAX package's `parallel/sharded.py`
and `parallel/tpx_sharded.py` (mesh None, Pallas in interpret mode), on the
CPU tier, byte for byte; the split over `devices=["cpu"] * k`; and the
deliberate differences, each showing both results.

At import this module also builds the native library of the JAX package
once, under a file lock: the test workers import every test module before
any test runs, so every later `make` of `hsrans_tpu.runtime.native.load()`
finds the library up to date and none relinks it while another worker
loads it.
"""

import fcntl
import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _build_native_once() -> None:
    lock = REPO / "build" / "native.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", str(REPO / "native"), "-s"], capture_output=True, timeout=600)
        except (OSError, subprocess.SubprocessError):
            pass  # no toolchain: the JAX package falls back to numpy, as it does without the lock


_build_native_once()

import hsrans_tpu.parallel.sharded as jsh  # noqa: E402
from hsrans_tpu.ops.mt import mt_decode_py as jax_mt_decode_py  # noqa: E402
from hsrans_tpu.ops.mt import mt_encode_py  # noqa: E402
from hsrans_tpu.ops.tpx import TpxParams, tpx_encode  # noqa: E402
from hsrans_tpu.parallel import tpx_sharded as jtpx  # noqa: E402
from hsrans_tpu_torch.ops import mt as port_mt  # noqa: E402
from hsrans_tpu_torch.parallel import sharded as psh  # noqa: E402
from hsrans_tpu_torch.parallel import tpx_sharded as ptpx  # noqa: E402
from tools.gen_inputs import text_like  # noqa: E402

SMALL = TpxParams(bits=12, rows=8, lanes=128, steps=8, tiles=2)
SPLITS = (1, 2, 3, 8)


def _bad_freq_blob() -> tuple[np.ndarray, bytes]:
    """3 * 4096 + 100 bytes of text at B=12, n=64, uniform 4 KiB blocks, the
    first block's largest freq raised by 1: its freqs sum to 2^12 + 1."""
    data = text_like(np.random.default_rng(1), 3 * 4096 + 100)
    blob = bytearray(jsh.mt_encode_device(data, 12, 64, plan=jsh.uniform_plan(data, 12, 64, 4096)))
    lo = 16 + 16 + 4 * 64  # the first coded block's freqs
    freq = np.frombuffer(bytes(blob[lo : lo + 512]), "<u2").copy()
    freq[np.argmax(freq)] += 1
    blob[lo : lo + 512] = freq.astype("<u2").tobytes()
    return data, bytes(blob)


@pytest.mark.parametrize("n", (16, 32, 64))
def test_mt_decode_device_equals_jax(n):
    """Uniform blocks with an odd tail and the reference planner's blocks
    (single-symbol runs among them): the port's whole chain == JAX's; at
    n=16 both take step (c), the batched scan decode."""
    rng = np.random.default_rng(50 + n)
    data = np.concatenate([text_like(rng, 9000), np.full(3000, 7, np.uint8), text_like(rng, 2 * 4096 + 77)])
    for plan in (jsh.uniform_plan(data, 12, n, 4096), None):
        blob = mt_encode_py(data, 12, n, plan)
        want = jsh.mt_decode_device(blob, 12, n)
        assert want == data.tobytes()
        assert psh.mt_decode_device(blob, 12, n, device="cpu") == want
        if n == 16:
            assert psh.scan_decode_blob(blob, 12, n, [psh.resolve_all("cpu")[0]]) == want


@pytest.mark.parametrize(("n", "bits"), ((16, 12), (32, 14), (64, 10), (16, 9)))
def test_mt_decode_device_malformed_equals_jax(n, bits):
    """Truncations and bit flips in the headers, states, freqs and words:
    the port's outcome (None or bytes) == JAX's, except where a coded
    block's freqs do not sum to 2^B, where JAX gives the coded blocks as
    zeros and the port gives None, as `mt_decode_py` does.  B=9 takes no
    native step in either chain."""
    rng = np.random.default_rng(60 + n + bits)
    data = text_like(rng, 3 * 4096 + 333)
    blob = mt_encode_py(data, bits, n, jsh.uniform_plan(data, bits, n, 4096))
    cases = [blob[:cut] for cut in (0, 15, 16, 100, len(blob) // 2, len(blob) - 1)]
    hdr = 16 + 2 * n + 256  # u16s of a coded block's header
    for lo, hi in ((0, 3), (16, 32), (32, 32 + 4 * n), (32 + 4 * n, 32 + 4 * n + 512), (2 * hdr + 32, len(blob))):
        for _ in range(3):
            b = bytearray(blob)
            b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
            cases.append(bytes(b))
    outcomes = {"none": 0, "bytes": 0, "bad_freq": 0}
    for b in cases:
        want = jsh.mt_decode_device(b, bits, n)
        got = psh.mt_decode_device(b, bits, n, device="cpu")
        if got is None and want is not None:
            idx = port_mt.block_index(b, n)
            coded = [blk for blk in idx[2] if not blk.is_single]
            assert coded and psh.gather_blocks(idx[2], bits, n) is None and jax_mt_decode_py(b, bits, n) is None
            outcomes["bad_freq"] += 1
            continue
        assert got == want
        outcomes["none" if got is None else "bytes"] += 1
    assert outcomes["bytes"] and outcomes["none"], outcomes


def test_mt_decode_device_bad_freq_is_none_where_jax_gives_zeros():
    """The reference's fault, pinned: on a blob whose first block's freqs sum
    to 2^B + 1, the JAX package's mt_decode_device returns the 12,388 bytes
    as zeros (gather_blocks gives None, every coded block is skipped); the
    host decoders and the port give None."""
    _, blob = _bad_freq_blob()
    want = jsh.mt_decode_device(blob, 12, 64)
    assert want == bytes(12388)
    assert jax_mt_decode_py(blob, 12, 64) is None and port_mt.mt_decode_py(blob, 12, 64) is None
    assert psh.mt_decode_device(blob, 12, 64, device="cpu") is None


@pytest.mark.parametrize("plan_kind", ("uniform", "planner", "odd sizes"))
def test_mt_encode_device_n16_equals_jax(plan_kind):
    """n=16 (the scan encode kernel's plain version) == JAX's
    mt_encode_device, and decodes back through both chains."""
    rng = np.random.default_rng(70)
    data = np.concatenate([text_like(rng, 7000), np.full(2500, 3, np.uint8), text_like(rng, 5000)])
    plan = {
        "uniform": jsh.uniform_plan(data, 12, 16, 4096),
        "planner": None,
        "odd sizes": jsh.uniform_plan(data, 12, 16, 1000 + 17),
    }[plan_kind]
    want = jsh.mt_encode_device(data, 12, 16, plan=plan)
    got = psh.mt_encode_device(data, 12, 16, plan=plan, device="cpu")
    assert got == want
    assert psh.mt_decode_device(got, 12, 16, device="cpu") == data.tobytes()


def test_mt_encode_device_n16_empty_and_tiny_equal_jax():
    for size in (0, 5, 16, 17):
        data = text_like(np.random.default_rng(size), size)
        plan = jsh.uniform_plan(data, 12, 16, 4096) if size else []
        assert psh.mt_encode_device(data, 12, 16, plan=plan, device="cpu") == jsh.mt_encode_device(data, 12, 16, plan=plan)


@pytest.mark.parametrize("k", SPLITS)
def test_mt_split_over_devices_keeps_the_bytes(k):
    """devices=["cpu"] * k: mt encode at n = 16 and 32 and the decode chain's
    steps (a) and (c) give the bytes of one device."""
    rng = np.random.default_rng(80)
    data = np.concatenate([text_like(rng, 5 * 4096 + 50), np.full(700, 1, np.uint8), text_like(rng, 3000)])
    devices = ["cpu"] * k
    for n in (16, 32):
        plan = psh.uniform_plan(data, 12, n, 2048)
        one = psh.mt_encode_device(data, 12, n, plan=plan, device="cpu")
        assert psh.mt_encode_device(data, 12, n, plan=plan, devices=devices) == one
        assert psh.mt_decode_device(one, 12, n, devices=devices) == data.tobytes()
    blob = mt_encode_py(data, 12, 64, psh.uniform_plan(data, 12, 64, 2048))
    assert psh.scan_decode_blob(blob, 12, 64, psh.resolve_all("cpu", devices)) == data.tobytes()


TPX_CASES = (("one tile", 100), ("partial mega", SMALL.mega_bytes // 3), ("multi-mega+tail", 9 * SMALL.mega_bytes + 777),
             ("exact-megas", 4 * SMALL.mega_bytes))


@pytest.mark.parametrize(("name", "size"), TPX_CASES)
def test_tpx_device_equals_jax(name, size):
    """tpx_encode_device and tpx_decode_device == the JAX package's (mesh
    None, interpret mode) and the numpy authority, on one device and split
    over 2, 3 and 8."""
    data = text_like(np.random.default_rng(size), size)
    want = jtpx.tpx_encode_device(data, p=SMALL, interpret=True)
    assert want == tpx_encode(data, p=SMALL)
    assert jtpx.tpx_decode_device(want, interpret=True) == data.tobytes()
    for k in SPLITS:
        assert ptpx.tpx_encode_device(data, p=SMALL, devices=["cpu"] * k) == want
        assert ptpx.tpx_decode_device(want, devices=["cpu"] * k) == data.tobytes()


def test_tpx_decode_device_takes_rows_the_jax_device_path_refuses():
    """The deliberate difference: a v2 blob of 13 rows decodes with the port
    (it follows the numpy authority, as tpx_decode_torch does), where the
    JAX package's tpx_decode_device gives None (rows % 8 != 0)."""
    p = TpxParams(bits=12, rows=13, lanes=128, steps=8, tiles=2)
    data = text_like(np.random.default_rng(13), 2 * p.mega_bytes + 99)
    blob = tpx_encode(data, p=p)
    assert jtpx.tpx_decode_device(blob, interpret=True) is None
    assert ptpx.tpx_decode_device(blob, device="cpu") == data.tobytes()
    assert ptpx.tpx_encode_device(data, p=p, devices=["cpu"] * 2) == blob


@pytest.mark.parametrize("n", (32, 64))
def test_encode_blocks_scan_equals_the_mt_encode_kernel(n):
    """The n=16 route of encode_plan (`encode_blocks_scan`, the scan encode
    kernel's plain version) keeps the mt encode kernel's contract: at n = 32
    and 64, under the section rule, the same scratch words, counts and final
    states as `encode_blocks_plain` on the same blocks."""
    import torch

    from hsrans_tpu_torch.kernels import mt_encode as mte

    rng = np.random.default_rng(120 + n)
    data = np.concatenate([text_like(rng, 6000), np.full(900, 5, np.uint8), text_like(rng, 3333)])
    plan = psh.uniform_plan(data, 12, n, 1500)
    kinds, ks, index, freqs, bias = mte.plan_operands(data, plan, 12, n, "section")
    ops = (torch.from_numpy(data), torch.from_numpy(index), torch.from_numpy(freqs.view(np.int16)))
    kw = {"bits": 12, "n": n, "rule": "section", "words_cap": int(index[-1, 4])}
    got, want = mte.encode_blocks_scan(*ops, **kw), mte.encode_blocks_plain(*ops, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", SPLITS)
def test_mt_decode_torch_split_puts_each_share_in_place(k):
    """mt_decode_torch over k devices, on a blob whose single-symbol blocks
    open, split and close the coded ones (blocks of 2 KiB, one of 1 KiB):
    each share's byte range lands in place, the input back as
    `mt_decode_py` gives it."""
    from hsrans_tpu.ops.planner import BlockPlan
    from hsrans_tpu.ops.tpx import make_tile_hist
    from hsrans_tpu_torch.kernels.mt_decode import mt_decode_torch

    rng = np.random.default_rng(130)
    parts = [(9, 5000), (None, 7 * 1024), (2, 4000), (None, 6 * 1024), (4, 3000)]
    data = np.concatenate([np.full(size, sym, np.uint8) if sym is not None else text_like(rng, size)
                           for sym, size in parts])
    plan, at = [], 0
    for sym, size in parts:
        if sym is not None:
            plan.append(BlockPlan(at, size, True, sym, None))
        else:
            for s in range(at, at + size, 2048):
                e = min(s + 2048, at + size)
                plan.append(BlockPlan(s, e - s, False, 0, make_tile_hist(data[s:e], 12).symbol_count))
        at += size
    for n in (32, 64):
        blob = mt_encode_py(data, 12, n, plan)
        assert mt_decode_torch(blob, 12, n, devices=["cpu"] * k) == port_mt.mt_decode_py(blob, 12, n) == data.tobytes()
