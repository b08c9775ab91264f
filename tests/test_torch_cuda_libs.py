"""The port's CUDA library table and launch tallies (moca_tpu_torch/ops/cuda_libs.py).

Every kernel source belongs to one library; each library's table entry
declares exactly the C entry points its sources export, with argtypes that
match their C parameters; every entry point a caller names is declared; the
op modules reach the libraries only through cuda_libs; and the one
`reset_launch_counts` empties every wrapper's tally, whose keys are the
shape with "fp32" or "fp16" appended for those types.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import flash_attention as tfa
from moca_tpu_torch.ops import geglu as tg
from moca_tpu_torch.ops import moca_scan as tms
from moca_tpu_torch.ops import norms as tn

ROOT = Path(__file__).resolve().parent.parent
OPS = ROOT / "moca_tpu_torch" / "ops"
_EXTERN = re.compile(r'extern "C" (?:int|const char\*) (moca_\w+)\(([^)]*)\)')


def _ctype(param: str):
    """The ctypes type of one C parameter, e.g. "const void* q" or "long long N"."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(None, 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[kind]


def _exports(sources):
    """{C entry point: [ctypes of its parameters]} that `sources` export."""
    out = {}
    for src in sources:
        for name, params in _EXTERN.findall((cuda_libs.CSRC / src).read_text()):
            out[name] = [_ctype(p.strip()) for p in params.split(",")]
    return out


@pytest.mark.parametrize("src", sorted(p.name for p in cuda_libs.CSRC.glob("*.cu")))
def test_every_source_is_in_exactly_one_library(src):
    owners = [name for name, lib in cuda_libs.LIBRARIES.items() if src in lib.sources]
    assert len(owners) == 1, owners


@pytest.mark.parametrize("name", sorted(cuda_libs.LIBRARIES))
def test_library_entries_are_its_sources_exports(name):
    """The table's entries are what the library's sources export (its error
    string aside, which `load_library` binds for every library), each with
    the argtypes of its C parameters."""
    lib = cuda_libs.LIBRARIES[name]
    assert all((cuda_libs.CSRC / src).is_file() for src in lib.sources)
    exports = _exports(lib.sources)
    assert exports.pop("moca_cuda_error_string") == [ctypes.c_int]
    assert exports == {sym: list(argtypes) for sym, argtypes in lib.entries.items()}


def _named_entry_points():
    """The C entry points the op modules and chip_smoke.py name: attributes
    `lib.moca_*` of both, and the op modules' "moca_*" strings."""
    names = set()
    for path in sorted(OPS.glob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr.startswith("moca_"):
                names.add(node.attr)
            elif (path.parent == OPS and isinstance(node, ast.Constant)
                  and isinstance(node.value, str) and re.fullmatch(r"moca_[a-z0-9_]+", node.value)):
                names.add(node.value)
    return names


def test_every_entry_point_a_caller_names_is_declared():
    declared = {sym for lib in cuda_libs.LIBRARIES.values() for sym in lib.entries}
    named = _named_entry_points()
    assert {"moca_group_norm", "moca_layer_norm", "moca_geglu", "moca_packed_empty",
            "moca_flash_attention", "moca_packed_attention_plan"} <= named
    assert named - {"moca_cuda_error_string"} <= declared, sorted(named - declared)
    # K1-K4's wrappers add "_f32" (float32) and "_plan" (K1's and K4's design) to their
    # library's entry point
    for name, sym in tfa._SYMBOLS.items():
        entries = cuda_libs.LIBRARIES[name].entries
        assert sym in entries and sym + "_f32" in entries
        assert (sym + "_plan" in entries) == (name in ("flash", "onepass", "packed"))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, None) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from ((node.module, a.name) for a in node.names)


@pytest.mark.parametrize("module", ["flash_attention", "norms", "geglu", "attention",
                                    "moca_scan"])
def test_op_modules_reach_the_libraries_only_through_cuda_libs(module):
    """No op module imports ctypes, subprocess or hashlib, another op module's
    private name, or (norms, GEGLU, the MoCA scan) the attention module; nor reads another op
    module's private attribute."""
    path = OPS / f"{module}.py"
    imports = list(_imports(path))
    assert not {m for m, _ in imports} & {"ctypes", "subprocess", "hashlib"}
    for mod, name in imports:
        if mod and mod.startswith("moca_tpu_torch.ops") and name:
            assert not name.startswith("_"), (mod, name)
        if module in ("norms", "geglu", "moca_scan"):
            assert "flash_attention" not in (mod or "") and name != "flash_attention"
    aliases = {alias.asname or alias.name for node in ast.walk(ast.parse(path.read_text()))
               if isinstance(node, ast.ImportFrom) and node.module == "moca_tpu_torch.ops"
               for alias in node.names}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            assert not node.attr.startswith("_"), (node.value.id, node.attr)


def test_one_reset_empties_every_tally():
    """K1-K4, both norms, GEGLU and the MoCA scan are registered once each;
    the attention module's `reset_launch_counts` (which the benchmark calls)
    is the one reset, and empties all eight."""
    wrappers = {tfa.flash_attention, tfa.packed_attention, tfa.fused_qkv_attention,
                tfa.flash_attention_onepass, tn.group_norm, tn.layer_norm, tg.geglu,
                tms.moca_scan}
    assert set(cuda_libs.TALLIED) == wrappers and len(cuda_libs.TALLIED) == len(wrappers)
    assert tfa.KERNELS == (tfa.flash_attention, tfa.packed_attention,
                           tfa.fused_qkv_attention, tfa.flash_attention_onepass)
    assert tfa.reset_launch_counts is cuda_libs.reset_launch_counts
    defs = [path.name for path in (ROOT / "moca_tpu_torch").rglob("*.py")
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.FunctionDef) and node.name == "reset_launch_counts"]
    assert defs == ["cuda_libs.py"]
    for fn in wrappers:
        cuda_libs.tally(fn, (1, 2), torch.bfloat16)
    tfa.reset_launch_counts()
    assert all(fn.launches == {} for fn in wrappers)


@pytest.mark.parametrize("dtype,tag", [(torch.bfloat16, ()), (torch.float32, ("fp32",)),
                                       (torch.float16, ("fp16",))], ids=["bf16", "fp32", "fp16"])
def test_tally_keys_the_shape_and_the_dtype(dtype, tag):
    """A launch is tallied under its shape, with "fp32" or "fp16" appended for
    those types and nothing for bfloat16 (the keys K1-K4 and the norms kept
    before they shared the helper); each launch adds one."""
    def wrapper():
        pass

    cuda_libs.tallied(wrapper)
    try:
        for _ in range(3):
            cuda_libs.tally(wrapper, (4, 320), dtype)
        cuda_libs.tally(wrapper, (2, 320), dtype)
        assert wrapper.launches == {(4, 320) + tag: 3, (2, 320) + tag: 1}
        assert cuda_libs.launch_key((4, 320), dtype) == (4, 320) + tag
    finally:
        cuda_libs.TALLIED.remove(wrapper)
