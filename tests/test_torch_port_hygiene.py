"""The PyTorch port stands apart from JAX and never hides the device: it
imports and runs with jax and the JAX package unimportable, no source of it
imports either, and `device="cuda"` without a card raises instead of running
elsewhere."""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "hsrans_tpu_torch"


def test_import_and_cpu_round_trip_without_jax():
    """With jax and every module of `hsrans_tpu` unimportable, the port
    imports and round-trips (tpx plain v2 and adaptive v3, mt, the raw wire,
    mt at n=16, the device splits, the CLI's host codecs: the block and
    32blk wires on the native loader, and the numpy tpx codec) on the CPU,
    and its blobs equal the JAX package's encoders."""
    from hsrans_tpu.ops.blk32 import blk32_encode_host
    from hsrans_tpu.ops.block import block_encode
    from hsrans_tpu.ops.mt import mt_encode_py
    from hsrans_tpu.ops.tpx import tpx_encode, tpx_encode_adaptive
    from hsrans_tpu.parallel.sharded import mt_encode_device, uniform_plan

    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hsrans_tpu'] = None\n"
        "import hashlib\n"
        "import numpy as np\n"
        "import hsrans_tpu_torch as h\n"
        "data = np.random.default_rng(0).integers(0, 40, 20_000).astype(np.uint8)\n"
        "for blob in (h.tpx_encode_torch(data, device='cpu'), h.tpx_encode_adaptive_torch(data, device='cpu')):\n"
        "    assert h.tpx_decode_torch(blob, device='cpu') == data.tobytes()\n"
        "    print(hashlib.sha256(blob).hexdigest())\n"
        "from hsrans_tpu_torch.ops.mt import mt_encode_py\n"
        "blob = mt_encode_py(data, 12, 64)\n"
        "assert h.mt_decode_torch(blob, 12, 64, device='cpu') == data.tobytes()\n"
        "print(hashlib.sha256(blob).hexdigest())\n"
        "from hsrans_tpu_torch.parallel.sharded import mt_encode_device\n"
        "for blob, n in ((h.mt_encode_torch(data, 12, device='cpu'), 64), (mt_encode_device(data, 12, 32, device='cpu'), 32)):\n"
        "    assert h.mt_decode_torch(blob, 12, n, device='cpu') == data.tobytes()\n"
        "    print(hashlib.sha256(blob).hexdigest())\n"
        "from hsrans_tpu_torch.models.histogram import Hist, normalize_hist, observe_hist\n"
        "hist = normalize_hist(observe_hist(data), data.size, 12)\n"
        "for n in (16, 32, 64):\n"
        "    raw = h.raw_encode_torch(data, hist, n, device='cpu')\n"
        "    assert h.raw_decode_torch(raw, 12, n, device='cpu') == data.tobytes()\n"
        "blob16 = mt_encode_device(data, 12, 16, uniform_block=4096, device='cpu')\n"
        "from hsrans_tpu_torch.parallel.sharded import mt_decode_device\n"
        "assert mt_decode_device(blob16, 12, 16, devices=['cpu', 'cpu']) == data.tobytes()\n"
        "from hsrans_tpu_torch.parallel.tpx_sharded import tpx_decode_device, tpx_encode_device\n"
        "assert tpx_decode_device(tpx_encode_device(data, devices=['cpu'] * 3), device='cpu') == data.tobytes()\n"
        "from hsrans_tpu_torch import cli\n"
        "assert cli.parse_args(['f', '--test'])['blk32']\n"
        "for blob in (h.block_encode(data, 12, 64), h.blk32_encode_host(data, 12, 16)):\n"
        "    print(hashlib.sha256(blob).hexdigest())\n"
        "assert h.block_decode(h.block_encode(data, 12, 64), 12, 64) == data.tobytes()\n"
        "assert h.blk32_decode_host(h.blk32_encode_host(data, 12, 16), 12, 16) == data.tobytes()\n"
        "from hsrans_tpu_torch.ops.tpx import tpx_encode_adaptive\n"
        "for blob in (h.tpx_encode(data), tpx_encode_adaptive(data)):\n"
        "    assert h.tpx_decode(blob) == h.tpx_decode(blob, use_rank_tables=True) == data.tobytes()\n"
        "    print(hashlib.sha256(blob).hexdigest())\n"
        "assert not any(m.split('.')[0] in ('jax', 'hsrans_tpu') for m, v in sys.modules.items() if v is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    data = np.random.default_rng(0).integers(0, 40, 20_000).astype(np.uint8)
    want = [hashlib.sha256(f(data)).hexdigest() for f in (tpx_encode, tpx_encode_adaptive)]
    want.append(hashlib.sha256(mt_encode_py(data, 12, 64)).hexdigest())
    want.append(hashlib.sha256(mt_encode_device(data, 12, 64, plan=uniform_plan(data, 12, 64, 4096))).hexdigest())
    want.append(hashlib.sha256(mt_encode_device(data, 12, 32)).hexdigest())
    want.append(hashlib.sha256(block_encode(data, 12, 64)).hexdigest())
    want.append(hashlib.sha256(blk32_encode_host(data, 12, 16)).hexdigest())
    want += [hashlib.sha256(f(data)).hexdigest() for f in (tpx_encode, tpx_encode_adaptive)]
    assert res.stdout.split() == want


@pytest.mark.parametrize("package", ("jax", "hsrans_tpu"))
def test_no_port_source_imports_jax(package):
    """Neither the port nor its card scripts (chip_smoke.py, chip_ab.py)
    name jax or the JAX package in an import (the `hsrans_tpu_torch`
    package itself is the port)."""
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py", REPO / "chip_ab.py"]
    assert len(files) >= 10 and PORT / "models" / "device_hist.py" in files
    assert {PORT / "kernels" / "scan.py", PORT / "ops" / "raw_scan.py", PORT / "models" / "tables.py",
            PORT / "parallel" / "tpx_sharded.py", PORT / "cli.py", PORT / "ops" / "blk32.py", PORT / "ops" / "block.py",
            PORT / "runtime" / "native.py", PORT / "utils" / "profiling.py", PORT / "ops" / "tpx.py"} <= set(files)
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] == ["import"]:
                assert not any(w.strip(",").split(".")[0] == package for w in words[1:]), (f, line)
            if words[:1] == ["from"] and len(words) > 1:
                assert words[1].split(".")[0] != package, (f, line)


def test_every_entry_point_is_bound_and_reports_its_launch():
    """Each C entry point of `csrc/*.cu` has a ctypes signature in
    `runtime/build.py`, each signature an entry point, and every kernel
    launch is followed by `cudaGetLastError()` before its function returns,
    so `build.launch` sees a refused launch."""
    import re

    from hsrans_tpu_torch.runtime import build

    entries = set()
    for src in sorted((PORT / "csrc").glob("*.cu")):
        text = src.read_text()
        entries |= set(re.findall(r'extern "C" int (hsr_\w+)\(', text))
        launches = [m.end() for m in re.finditer(r"<<<", text)]
        assert launches, src
        for at in launches:
            body = text[at : text.index("\n}", at)]  # to the end of the launching function
            assert "cudaGetLastError()" in body, (src.name, text[at - 80 : at])
    assert entries == set(build._SIGNATURES)
    assert {"hsr_hist_count", "hsr_hist_normalize", "hsr_scan_decode", "hsr_scan_encode"} <= entries
    assert {"mt_annotate", "mt_decode_annotated", "hist_count", "hist_normalize", "scan_decode",
            "scan_encode"} <= set(build.LAUNCHES)


def test_cuda_sources_stand_alone():
    """The CUDA sources include neither PyTorch's headers nor any file
    outside the toolkit and csrc/ (a plain C interface, built in seconds)."""
    import re

    sources = sorted((PORT / "csrc").glob("*.cu*"))
    assert PORT / "csrc" / "hist.cu" in sources
    for src in sources:
        text = src.read_text()
        for inc in re.findall(r"#include\s+[<\"]([^>\"]+)[>\"]", text):
            assert not inc.startswith(("torch", "ATen", "c10")), (src.name, inc)
            assert "/" not in inc or (PORT / "csrc" / inc).exists(), (src.name, inc)


def test_cuda_wrappers_never_take_the_plain_version():
    """No `*_cuda` wrapper or `launch*` entry of the port calls a plain
    version: on CUDA operands it launches its kernel or raises."""
    import ast

    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and (fn.name.endswith("_cuda") or fn.name.startswith("launch")):
                called = {n.func.id if isinstance(n.func, ast.Name) else getattr(n.func, "attr", "")
                          for n in ast.walk(fn) if isinstance(n, ast.Call)}
                assert not any(c.endswith("_plain") or c in ("bincount", "make_tile_hist") for c in called), (
                    path.name, fn.name)


def test_cuda_without_a_card_raises():
    from hsrans_tpu_torch import mt_decode_torch, mt_encode_torch, tpx_decode_torch, tpx_encode_torch
    from hsrans_tpu_torch.parallel.sharded import mt_encode_device
    from hsrans_tpu_torch.runtime.device import resolve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be shown here")
    for fn, arg in ((tpx_encode_torch, b"abc"), (tpx_decode_torch, b"HSRTPX02")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(arg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt_decode_torch(bytes(16), 12, 64, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt_encode_torch(b"abc", 12, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt_encode_device(b"abc", 12, 32, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpx_encode_torch(b"abc", device="cuda", device_tables=True)
    from hsrans_tpu_torch import raw_decode_torch, raw_encode_torch
    from hsrans_tpu_torch.models.histogram import normalize_hist
    from hsrans_tpu_torch.parallel.sharded import mt_decode_device
    from hsrans_tpu_torch.parallel.tpx_sharded import tpx_decode_device, tpx_encode_device

    hist = normalize_hist(np.ones(256, np.uint32), 256, 12)
    for call in (
        lambda: raw_encode_torch(b"abc", hist, 16, device="cuda"),
        lambda: raw_decode_torch(bytes(1000), 12, 16, device="cuda"),
        lambda: mt_decode_device(bytes(16), 12, 16, device="cuda"),
        lambda: mt_decode_device(bytes(16), 12, 64, devices=["cpu", "cuda"]),
        lambda: mt_encode_device(b"abc", 12, 16, device="cuda"),
        lambda: tpx_encode_device(b"abc", device="cuda"),
        lambda: tpx_decode_device(b"HSRTPX02", devices=["cuda"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError):
        resolve("mps")
    assert resolve("cpu") == torch.device("cpu")


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU operands are refused,
    not routed to the plain version."""
    from hsrans_tpu_torch.kernels import mt_decode as mt
    from hsrans_tpu_torch.kernels import mt_encode as mte
    from hsrans_tpu_torch.kernels import tpx_decode as dec
    from hsrans_tpu_torch.kernels import tpx_encode as enc
    from hsrans_tpu_torch.models import device_hist as dh

    t = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dh.observe_segments_cuda(torch.zeros(64, dtype=torch.uint8), np.array([0]), np.array([64]))
    with pytest.raises(ValueError, match="CUDA"):
        dh.normalize_rows_cuda(t, torch.ones(1, dtype=torch.int64), 12)
    u8 = torch.zeros(4096, dtype=torch.uint8)
    desc = np.array([[0, 8, 8, 1, 128, 0, 0, 0, 0, 0, 1]], np.int64)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_mega_cuda(u8, desc, torch.zeros(9, dtype=torch.int64), torch.zeros((8, 128), dtype=torch.int32),
                             torch.zeros((1, 4096), dtype=torch.uint8), t, bits=12, out_len=4)
    with pytest.raises(ValueError, match="CUDA"):
        enc.encode_mega_cuda(u8, np.array([[0, 8, 8, 1, 0, 0, 1, 0, 0]], np.int64), t, t, t, bits=12)
    wdesc, row_at, out_u16 = enc.wire_layout(np.array([[0, 8, 8, 1, 0, 0, 0, 0, 0]], np.int64), np.zeros(8, np.int64),
                                             v3=False, base=0)
    with pytest.raises(ValueError, match="CUDA"):
        enc.write_wire_cuda(torch.zeros(8 * 8 * 128, dtype=torch.int32), torch.zeros(64, dtype=torch.int32),
                            torch.zeros(8 * 128, dtype=torch.int32), torch.zeros((1, 256), dtype=torch.int16), wdesc,
                            row_at, v3=False, out_u16=out_u16)
    with pytest.raises(ValueError, match="CUDA"):
        mt.decode_blocks_cuda(
            torch.zeros(64, dtype=torch.uint8), torch.zeros((1, 5), dtype=torch.int64),
            torch.zeros((1, 64), dtype=torch.int32), t, bits=12, n=64, length=64,
        )
    with pytest.raises(ValueError, match="CUDA"):
        mt.annotate_cuda(torch.zeros(64, dtype=torch.uint8), torch.zeros((1, 5), dtype=torch.int64), t, bits=12)
    with pytest.raises(ValueError, match="CUDA"):
        mt.decode_blocks_annotated_cuda(
            torch.zeros(32, dtype=torch.int32), torch.zeros((1, 5), dtype=torch.int64),
            torch.zeros((1, 64), dtype=torch.int32), t, bits=12, n=64, length=64,
        )
    from hsrans_tpu_torch.kernels import scan

    st = torch.zeros((1, 16), dtype=torch.int32)
    i32 = torch.zeros(1, dtype=torch.int32)
    tab = torch.zeros(4096, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        scan.decode_section_cuda(st, torch.zeros(8, dtype=torch.int16), i32, torch.zeros(4096, dtype=torch.uint8), tab,
                                 tab, i32, bits=12, num_steps=1, tail=True)
    with pytest.raises(ValueError, match="CUDA"):
        scan.encode_section_cuda(st, torch.zeros((1, 1, 16), dtype=torch.uint8), torch.ones((1, 1, 16), dtype=torch.bool),
                                 tab[:256], tab[:256], bits=12, num_steps=1)
    index = torch.tensor([[0, 1, 64, 64, 64]], dtype=torch.int64)
    freqs = torch.ones((1, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        mte.encode_blocks_cuda(torch.zeros(64, dtype=torch.uint8), index, freqs, bits=8, n=64, rule="groups", words_cap=64)
    with pytest.raises(ValueError, match="CUDA"):
        mte.place_blocks_cuda(
            torch.zeros(64, dtype=torch.int16), index, torch.zeros(1, dtype=torch.int64),
            torch.zeros((1, 64), dtype=torch.int32), freqs, torch.zeros((1, 4), dtype=torch.int64), n=64, out_u16=400,
        )


def test_dispatch_takes_plain_version_for_cpu_operands():
    """The dispatchers pick the plain version for CPU operands."""
    from hsrans_tpu_torch.kernels import mt_encode as mte
    from hsrans_tpu_torch.kernels import tpx_encode as enc

    # one mega of one tile, 2 rows of 4 steps: 3 words in each row's first
    # step, so each row has 2 slots, its last with a high half of 0
    win = torch.zeros((1, 4, 2, 128), dtype=torch.int32)
    win[0, 0, :, :3] = torch.tensor([1, 2, 3])
    cnt = torch.zeros((1, 2, 4), dtype=torch.int32)
    cnt[0, :, 0] = 3
    desc = np.array([[0, 2, 4, 1, 0, 0, 0, 0, 0]], np.int64)
    wdesc, row_at, out_u16 = enc.wire_layout(desc, np.array([3, 3]), v3=False, base=0)
    freqs = torch.zeros((1, 256), dtype=torch.int16)
    out = enc.write_wire(win.reshape(-1), cnt.reshape(-1), torch.zeros(256, dtype=torch.int32), freqs, wdesc, row_at,
                         v3=False, out_u16=out_u16)
    assert out.shape == (2 * (4 + 2 * 2 * 128 + 256 + 2 + 2 * 4),)
    u32 = out.numpy().view(np.uint32)
    assert u32[:2].tolist() == [1, 128] and u32[-4:].tolist() == [1 | 2 << 16, 3] * 2
    # one block of one group, all 64 lanes on byte 0 of freq 2^8: from the
    # fresh state 2^15 no lane emits, and each ends at 2^15 >> 8 << 8 == 2^15
    index = torch.tensor([[0, 1, 64, 64, 64]], dtype=torch.int64)
    freqs = torch.zeros((1, 256), dtype=torch.int16)
    freqs[0, 0] = 256
    words, count, fin = mte.encode_blocks(torch.zeros(64, dtype=torch.uint8), index, freqs, bits=8, n=64, rule="groups", words_cap=64)
    assert count.tolist() == [0] and (fin == 1 << 15).all() and not words.any()
    # two segments of bytes 1, 1, 2 and none: the count and 1-symbol count; at B=2 the
    # first normalizes to 3, 1 (scale 4/3 rounds 2.67 to 3 and 1.33 to 1), the second to 4
    from hsrans_tpu_torch.models import device_hist as dh

    counts = dh.observe_segments(torch.tensor([1, 1, 2], dtype=torch.uint8), np.array([0, 3]), np.array([3, 3]))
    assert counts[0, 1:3].tolist() == [2, 1] and counts[1, 0] == 1 and counts.sum() == 4
    freq, cumul = dh.normalize_rows(counts, torch.tensor([3, 1]), 2)
    assert freq[0, 1:3].tolist() == [3, 1] and freq[1, 0] == 4 and cumul[0, :4].tolist() == [0, 0, 3, 4]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there is
    no card, and alone in a directory without the rest of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((REPO / "chip_smoke.py").read_bytes())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_entry_points_take_bytes_or_arrays():
    """Public entry points take bytes or a uint8 array alike."""
    from hsrans_tpu_torch import mt_encode_torch, tpx_decode_torch, tpx_encode_torch

    data = np.random.default_rng(4).integers(0, 9, 3000).astype(np.uint8)
    assert tpx_encode_torch(data, device="cpu") == tpx_encode_torch(data.tobytes(), device="cpu")
    assert mt_encode_torch(data, 12, device="cpu") == mt_encode_torch(data.tobytes(), 12, device="cpu")
    assert tpx_decode_torch(np.frombuffer(tpx_encode_torch(data, device="cpu"), np.uint8), device="cpu") == data.tobytes()


def test_entry_points_write_their_output_once():
    """The seven card entry points take their output from `Output` and make
    no second host copy of it (`tobytes`, `bytes(bytearray)`) on the way
    out; tpx and mt encode through `_encode_megas` and `encode_plan`."""
    import inspect

    from hsrans_tpu_torch.kernels import mt_decode, mt_encode, tpx_decode, tpx_encode
    from hsrans_tpu_torch.ops import raw_scan
    from hsrans_tpu_torch.parallel import sharded

    for fn in (tpx_decode.tpx_decode_torch, mt_decode.mt_decode_torch, raw_scan.raw_decode_torch,
               tpx_encode._encode_megas, mt_encode.encode_plan, raw_scan.raw_encode_torch, sharded.scan_decode_blob):
        src = inspect.getsource(fn)
        assert "Output(" in src and "tobytes" not in src and "bytearray" not in src, fn.__name__
    for fn in (tpx_encode.tpx_encode_torch, mt_encode.mt_encode_torch):
        assert "tobytes" not in inspect.getsource(fn), fn.__name__


def test_only_the_device_module_crosses_between_host_and_card():
    """No module of the port but `runtime/device.py` pins memory, copies
    without a host wait, uploads a host array itself or copies a tensor
    into a returned output: every such crossing goes through `to_card`,
    `table_to_card` or `Output`.  The helpers these replaced are gone, and
    the Python planner is called only as the native planner's fallback and
    by the numpy tier's codecs, which load no native library."""
    import re

    banned = re.compile(r"pin_memory|non_blocking|fresh_output\(|zero_outside\(|\.copy_\(|from_numpy\([^\n]*\)\.to\("
                        r"|\bdesc_on\b|\b_input_tensor\b|\braw_decode_operands\b")
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        src = path.read_text()
        if rel != "runtime/device.py":
            assert not banned.search(src), (rel, banned.search(src).group(0))
        if rel not in ("ops/planner.py", "ops/block.py", "ops/mt.py", "ops/tpx.py"):
            assert "plan_blocks_py(" not in src, rel


def test_layer_split_leaves_the_result_alone():
    """`layers=` adds each layer's seconds and changes no byte."""
    from hsrans_tpu_torch import mt_encode_torch, tpx_decode_torch, tpx_encode_torch

    data = np.random.default_rng(6).integers(0, 30, 50_000).astype(np.uint8)
    enc, dec, mt = {}, {}, {}
    blob = tpx_encode_torch(data, device="cpu", layers=enc)
    assert blob == tpx_encode_torch(data, device="cpu")
    assert tpx_decode_torch(blob, device="cpu", layers=dec) == data.tobytes()
    assert mt_encode_torch(data, 12, device="cpu", layers=mt) == mt_encode_torch(data, 12, device="cpu")
    assert set(enc) == {"h2d", "kernel_hist", "kernel_encode", "host_layout", "kernel_concat", "d2h", "host_mux"}
    assert set(dec) == {"host_parse", "host_tables", "h2d", "kernel", "d2h", "host_assemble"}
    assert set(mt) == {"host_index", "h2d", "kernel_hist", "kernel_encode", "host_layout", "kernel_place", "d2h",
                       "host_mux"}
    dt = {}
    assert tpx_encode_torch(data, device="cpu", layers=dt, device_tables=True) == blob
    assert set(dt) == set(enc)
    assert all(v >= 0 for v in (*enc.values(), *dec.values(), *mt.values()))


def test_build_dir_override_and_read_only_fallback(tmp_path, monkeypatch):
    """The kernel library goes to $HSRANS_TPU_TORCH_BUILD_DIR when set, to
    the checkout's build/ when writable, and to a per-user cache when the
    package sits in a read-only tree."""
    from hsrans_tpu_torch.runtime import build

    monkeypatch.delenv("HSRANS_TPU_TORCH_BUILD_DIR", raising=False)
    assert build.build_dir() == REPO / "build" / "hsrans_tpu_torch"
    monkeypatch.setenv("HSRANS_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert build.library_path().parent == tmp_path / "b"
    monkeypatch.delenv("HSRANS_TPU_TORCH_BUILD_DIR")
    site = tmp_path / "site"
    monkeypatch.setattr(build, "_PKG", site / "hsrans_tpu_torch")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(build.os, "access", lambda path, mode: Path(path) != site)
    site.mkdir()
    assert build.build_dir() == tmp_path / "home" / ".cache" / "hsrans_tpu_torch"
