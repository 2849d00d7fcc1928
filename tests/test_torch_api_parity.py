"""Every name of the JAX package has its counterpart in the port, or a
stated reason why it has none.

The check reads both packages' sources with `ast` and imports nothing of
either.  It covers every public top-level function and class of every
module of `hsrans_tpu`, and every top-level name, private ones too, of its
modules that import no jax: the host tier, which the port copies whole.
A counterpart is a top-level definition of the port under the same name,
under the `_tpu` -> `_torch` name, or under the name `RENAMED` gives it in
the module it gives.  Anything else stands in `UNPORTED` with its reason,
one of two kinds: a Pallas call builder or TPU table layout (ROADMAP, "Don't
port the TPU table-layout variants": the Hopper kernels make the same bytes
from the layouts that suit the card), or a hook of the JAX runtime.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "hsrans_tpu"
PORT = REPO / "hsrans_tpu_torch"

# JAX name -> the port's "module::name" where it has another name
RENAMED = {
    "mt64_decode_tpu": "kernels/mt_decode.py::mt_decode_torch",
    "mt64_encode_tpu": "kernels/mt_encode.py::mt_encode_torch",
    "raw_decode_jax": "ops/raw_scan.py::raw_decode_torch",
    "raw_encode_jax": "ops/raw_scan.py::raw_encode_torch",
    "make_enc_tables_batch": "kernels/tpx_encode.py::enc_tables_device",
    "_build": "runtime/native.py::_compile",
    "_codec_encode": "runtime/native.py::_encode",
    "_codec_decode": "runtime/native.py::_decode",
}

LAYOUT = "Pallas call builder or TPU table layout: "
RUNTIME = "JAX-runtime hook: "
UNPORTED = {
    "build_bucket_arrays": LAYOUT + "mt64 kernel operands padded to 128-lane buckets",
    "decode_bucket": LAYOUT + "the mt64 kernel's pallas_call over one bucket",
    "build_pair_arrays": LAYOUT + "pair-packed mt64 tables (same_tab, rank64, cb16)",
    "build_pair_arrays_hb": LAYOUT + "pair-packed mt64 tables of the high-B gbits cascade",
    "decode_bucket_paired": LAYOUT + "the pair kernels' pallas_call over one bucket",
    "build_quad_arrays": LAYOUT + "quad-packed mt32 tables",
    "decode_bucket_quad": LAYOUT + "the mt32 quad kernel's pallas_call over one bucket",
    "chunk_major": LAYOUT + "tpx stream slots reordered into 128-lane chunks for the window DMA",
    "mega_dec_tables": LAYOUT + "tpx rank tables split into [8, 128] lane-shuffle operands",
    "div_magic": LAYOUT + "per-symbol division magics in the Pallas encode's table (the port's: kernels/scan.py::magic_table)",
    "make_enc_tables": LAYOUT + "one histogram's depth-packed fc/m/l table (the port builds it batched, enc_tables_device)",
    "gather256": LAYOUT + "a 256-entry lookup from two 128-lane table halves",
    "unpack_enc_fields": LAYOUT + "fields of the depth-packed fc table inside the Pallas encode",
    "divisor_le": LAYOUT + "Mosaic block sizes (sublane multiples of 8) for pallas_call grids",
    "__getattr__": RUNTIME + "imports the jax entry points lazily (the port's import no jax)",
}

# what the port copied last from the JAX package: never an exception
BROUGHT_ACROSS = {
    "tpx_encode", "tpx_encode_adaptive", "tpx_decode", "make_rank_tables", "_encode_mega_into",
    "_write_mega_segs", "_popcount", "make_enc_table", "make_dec_pack", "fnv1a", "observe_hist",
    "normalize_hist", "hist_blocks", "codec_call_len", "axis_size",
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _imports_jax(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(a.name.split(".")[0] == "jax" for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").split(".")[0] == "jax":
            return True
    return False


def _defined(tree: ast.Module) -> list[str]:
    """Top-level functions, classes and assigned names, in order."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return out


def _checked(tree: ast.Module) -> list[str]:
    """The names of one JAX module the parity covers."""
    every = not _imports_jax(tree)
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and (every or not node.name.startswith("_"))]


def _port_names() -> dict[str, set[str]]:
    return {str(p.relative_to(PORT)): set(_defined(_tree(p))) for p in PORT.rglob("*.py")}


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py") if _checked(_tree(p)))


def _counterpart(name: str, port: dict[str, set[str]]) -> str | None:
    if name in RENAMED:
        module, other = RENAMED[name].split("::")
        return RENAMED[name] if other in port.get(module, ()) else None
    for candidate in (name, name.replace("_tpu", "_torch")):
        for module, names in sorted(port.items()):
            if candidate in names:
                return f"{module}::{candidate}"
    return None


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_name_has_a_counterpart(module):
    """Each covered name of the module has its counterpart in the port, or
    stands in UNPORTED."""
    port = _port_names()
    missing = [n for n in _checked(_tree(JAX / module)) if _counterpart(n, port) is None and n not in UNPORTED]
    assert not missing, f"{module}: no counterpart in hsrans_tpu_torch and no reason in UNPORTED: {missing}"


def test_unported_names_are_real_gaps_with_a_reason_of_the_two_kinds():
    """Each exception names a covered JAX name that the port lacks (no stale
    entry), with a one-line reason of one of the two kinds; none is a name
    this PR brought across, and each of those has its counterpart."""
    covered = {n for m in JAX_MODULES for n in _checked(_tree(JAX / m))}
    port = _port_names()
    for name, reason in UNPORTED.items():
        assert name in covered and _counterpart(name, port) is None, name
        assert reason.startswith((LAYOUT, RUNTIME)) and "\n" not in reason and len(reason) > len(LAYOUT) + 10, name
    assert not BROUGHT_ACROSS & set(UNPORTED)
    assert BROUGHT_ACROSS <= covered
    assert all(_counterpart(n, port) for n in BROUGHT_ACROSS)
    for name, where in RENAMED.items():
        assert name in covered and _counterpart(name, port) == where, name


def test_package_exports_every_name_of_the_jax_package():
    """Each name of `hsrans_tpu.__all__` is in `hsrans_tpu_torch.__all__`,
    under its own name or its counterpart's (the `*_tpu` entry points as
    the `*_torch` ones)."""

    def all_of(path: Path) -> set[str]:
        for node in _tree(path).body:
            if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                return {ast.literal_eval(e) for e in node.value.elts}
        raise AssertionError(f"{path} has no __all__")

    jax_all, port_all = all_of(JAX / "__init__.py"), all_of(PORT / "__init__.py")
    assert {"tpx_encode", "tpx_decode", "mt64_decode_tpu"} <= jax_all
    for name in sorted(jax_all):
        own = RENAMED[name].split("::")[1] if name in RENAMED else name.replace("_tpu", "_torch")
        assert own in port_all, name
