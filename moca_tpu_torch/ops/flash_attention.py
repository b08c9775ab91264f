"""Hand-written Hopper attention kernels, their plain versions and their build.

Port of moca_tpu/ops/flash_attention.py. Its seven Pallas kernels are served
by four CUDA kernels here (sources in `moca_tpu_torch/csrc/`, each with a note
on what it replaces, what bounds it and how it is designed):

  * K1 `flash_attention(q, k, v)` — attention of q [B, Sq, H, D] over
    k, v [B, Sk, H, D], D in {64, 128}, online softmax on wgmma with TMA
    loads, a producer warpgroup and two ping-ponged consumer warpgroups
    (csrc/flash_hopper.cuh), or on mma.sync at the shapes where that is
    faster; serves `_fa_kernel` and `_fa_small_kernel`
    (csrc/flash_attention.cu);
  * K2 `packed_attention(q, k, v, heads)` — [N, S, H*d] tiny-S attention on
    packed heads, S in {8, 16, 24, 32}, any head width d, as the reference's
    `_packed_tiny_kernel` takes: a warp a head on tiles of whole 16-byte
    chunks at d % 8 == 0 from 16 to 128, else CTAs that stage spans of whole
    heads (the library picks by d); serves `_packed_slice_kernel`,
    `_packed_lane_kernel` and `_packed_tiny_kernel`
    (csrc/packed_attention.cu, the span design in csrc/packed_span.cu);
  * K3 `fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)` — q/k/v
    projections, tiny-S attention and the out projection of [N, S, C] in one
    kernel, d = 64: the weights streamed by TMA into wgmma (fp32: by
    cp.async into 3xTF32 on mma.sync), a tile's heads split over a cluster
    where `fused_qkv_head_split` says so; serves `_fused_qkv_kernel`
    (csrc/fused_qkv_attention.cu);
  * K4 `flash_attention_onepass(q, k, v)` — K1's function with the row max
    taken before any exponent and nothing rescaled, D in {64, 128}: two
    sweeps over KV on K1's wgmma pipeline (or on mma.sync where that is
    faster); serves `_fa_onepass_kernel` (csrc/flash_onepass.cu).

Each kernel takes bfloat16 or float32, as the Pallas bodies take either: the
fp32 path of each library (a separate C entry point, `<name>_f32`) computes
what the Pallas body computes on fp32 refs, one design at every shape: K1,
K3 and K4 with 3xTF32 products on the tensor cores (K1 and K4 in
csrc/attention_f32.cuh, K3 in its own source), K2 with scalar FFMAs.
`--precision fp32` runs through them.

The Hopper pieces (mbarriers, TMA, wgmma, named barriers, setmaxnreg,
clusters) are in csrc/hopper.cuh, used by K1, K3 and K4; the tensor maps are
encoded inside each library's C entry point through the runtime's driver
entry point, so no library links -lcuda. K1 and K4 choose their design and kv
tile by shape inside the library (`attention_path` names the choice), K2 its
design by head width and a CTA's heads (`packed_attention_path` names the
design).

Each wrapper runs its plain PyTorch version only when handed CPU tensors. On
CUDA tensors it launches the kernel or raises — there is no fallback — and
adds one to its `launches` tally, keyed by shape (with "fp32" appended for
the fp32 path), per launch. Each plain
version rounds where its Pallas body rounds.

The norms' kernels (ops/norms.py, csrc/norms.cu) and the feed-forward's
GEGLU (ops/geglu.py, csrc/geglu.cu) are built here beside them, as two more
libraries.

The kernels are compiled from the repository's sources with `nvcc` for
`sm_90a` (one process per source, started together, then linked into one
library per kernel) into `build/kernels/` beside the package, at first use,
and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# library -> its sources; K2's two designs are two units so that they compile
# in parallel (the span design alone took nvcc longer than any other library);
# "norms" is the GroupNorm and LayerNorm kernels' library (ops/norms.py loads it),
# "geglu" the feed-forward's GEGLU (ops/geglu.py)
_SOURCES = {"flash": ("flash_attention.cu",),
            "packed": ("packed_attention.cu", "packed_span.cu"),
            "fused": ("fused_qkv_attention.cu",), "onepass": ("flash_onepass.cu",),
            "norms": ("norms.cu",), "geglu": ("geglu.cu",)}
_HEADERS = ("mma.cuh", "hopper.cuh", "flash_hopper.cuh", "attention_f32.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOG2E = 1.4426950408889634

_libs: dict = {}
build_log: dict = {}  # name -> {"seconds": .., "ptxas": ..} of the last build


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels must reproduce)
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v on [B, S, H, D], softmax in fp32.

    The reference's `_xla_attention` (moca_tpu/ops/attention.py:25-36):
    fp32 logits, probabilities cast to v's type before the PV product."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def packed_attention_plain(q, k, v, heads: int):
    """[N, S, H*D] packed-heads self-attention via the plain path."""
    n, s, c = q.shape
    d = c // heads
    split = lambda t: t.reshape(n, s, heads, d)
    return attention_plain(split(q), split(k), split(v)).reshape(n, s, c)


def flash_attention_onepass_plain(q, k, v):
    """`_fa_onepass_kernel`'s arithmetic on [B, S, H, D] (flash_attention.py:184-207):
    q scaled by scale*log2(e) in fp32 and rounded to its type; fp32 logits;
    p = exp2(s - row max), unnormalised, cast to v's type for PV with fp32
    accumulation; divided by the fp32 row sum and rounded once."""
    qs = (q.float() * (q.shape[-1] ** -0.5 * _LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads: int):
    """`_fused_qkv_kernel`'s arithmetic (flash_attention.py:447-497) on x
    [N, S, C] with nn.Linear-layout weights [out, in] and bias [C]: q, k, v
    rounded to x's type after fp32 accumulation; fp32 softmax, probabilities
    rounded before PV; each head's output rounded; the out projection
    accumulated in fp32 and rounded, then bo added in x's type."""
    n, s, c = x.shape
    d = c // heads
    x2 = x.reshape(n * s, c).float()

    def proj(w):
        return (x2 @ w.float().t()).to(x.dtype).reshape(n, s, heads, d)

    q, k, v = proj(wq), proj(wk), proj(wv)
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * d ** -0.5
    p = torch.softmax(logits, dim=-1).to(x.dtype)
    attn = torch.einsum("nhqk,nkhd->nqhd", p.float(), v.float()).to(x.dtype)
    out = (attn.reshape(n * s, c).float() @ wo.float().t()).to(x.dtype)
    return (out + bo.to(x.dtype)).reshape(n, s, c)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the attention kernels are built from source at first use")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in tuple(sources) + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict:
    """Compile every kernel library that has no up-to-date file yet.

    One nvcc per source, all started together, then one link per library;
    returns {name: library path}. A library's file name carries a digest of
    its sources and flags, so an edited source is rebuilt and a stale
    library is never loaded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: BUILD_DIR / f"libmoca_{name}_{_digest(srcs)}.so"
               for name, srcs in _SOURCES.items()}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            procs[name] = []
            for src in _SOURCES[name]:
                obj = path.with_name(f"{path.stem}.{Path(src).stem}.{os.getpid()}.o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
                       str(_CSRC / src)]
                procs[name].append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True), obj))
        failed = []
        for name, units in procs.items():
            logs = [proc.communicate()[0] for proc, _ in units]
            ok = all(proc.returncode == 0 for proc, _ in units)
            if ok:
                tmp = todo[name].with_suffix(f".{os.getpid()}.tmp")
                link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                       *(str(obj) for _, obj in units)],
                                      capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                ok = link.returncode == 0
                if ok:
                    os.replace(tmp, todo[name])
            for _, obj in units:
                obj.unlink(missing_ok=True)
            build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": "\n".join(logs)}
            if not ok:
                failed.append(f"{', '.join(_SOURCES[name])}:\n" + "\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
def _with_f32(fn: str, argtypes) -> dict:
    """K1-K4's entries: `fn` (bfloat16) and "<fn>_f32", which takes the same."""
    return {fn: argtypes, fn + "_f32": argtypes}


_ENTRY = {  # library -> {C entry point: its argtypes}
    "flash": _with_f32("moca_flash_attention", [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _p]),
    "packed": _with_f32("moca_packed_attention", [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i, _p]),
    "fused": _with_f32("moca_fused_qkv_attention",
                       [_p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _f, _p]),
    "onepass": _with_f32("moca_flash_onepass", [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i, _p]),
    "norms": {"moca_group_norm": [_p, _p, _p, _p, _p, _i, _i, _ll, _ll, _i, _i, _i, _i, _i,
                                  _ll, _f, _i, _p],
              "moca_layer_norm": [_p, _p, _p, _p, _i, _i, _ll, _i, _i, _f, _p]},
    "geglu": {"moca_geglu": [_p, _p, _i, _ll, _ll, _i, _i, _i, _p]},
}
# K1's and K4's designs, as their libraries number them (`plan` in the .cu):
# mma.sync, then wgmma (persistent CTAs) with kv tiles of 64 and of 128 rows
# (64 at D = 128).
ATTENTION_PATHS = ("mma_sync", "wgmma_kv64", "wgmma_kv128")


def load_library(name: str):
    """Library `name` of `_SOURCES`, built and loaded at first use, with
    every entry's argtypes set."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_kernels()[name]))
        for sym, argtypes in _ENTRY[name].items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = _i
        lib.moca_cuda_error_string.argtypes = [_i]
        lib.moca_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _entry(name: str, dtype=torch.bfloat16):
    """The C entry point of K1-K4's library `name` for `dtype` (bfloat16, or
    float32: the `_f32` symbol)."""
    lib = load_library(name)
    return lib, getattr(lib, next(iter(_ENTRY[name])) + ("_f32" if dtype == torch.float32 else ""))


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_inputs(q, *rest, what: str):
    """One CUDA device, one dtype that the kernels take (bfloat16 or
    float32), contiguous and 16-byte aligned (the kernels copy 16-byte
    chunks)."""
    for t in (q, *rest):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: all inputs must lie on one CUDA device")
        if t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{what}: the kernel takes bfloat16 or float32 inputs of one "
                             f"dtype, got {t.dtype} beside {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be 16-byte aligned")


def _count(fn, key, dtype):
    key = key + ("fp32",) if dtype == torch.float32 else key
    fn.launches[key] = fn.launches.get(key, 0) + 1


def _raise_on(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.moca_cuda_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def attention_path(name: str, b: int, sq: int, sk: int, h: int, d: int) -> str:
    """The design K1 (`name` "flash") or K4 ("onepass") takes at q [b, sq, h, d]
    over k, v [b, sk, h, d], one of ATTENTION_PATHS: the library's own plan."""
    lib, entry = _entry(name)
    fn = getattr(lib, entry.__name__ + "_plan")
    fn.argtypes, fn.restype = [_i] * 5, _i
    return ATTENTION_PATHS[fn(b, sq, sk, h, d)]


def _attention_call(wrapper, name: str, q, k, v, path: str | None = None):
    """Launch K1 or K4 (library `name`) on q [B, Sq, H, D] and k, v
    [B, Sk, H, D]: the two take the same arguments and shapes. `path` (one of
    ATTENTION_PATHS) overrides the library's choice of design, for timing
    the designs against each other; the fp32 path has one design."""
    what = wrapper.__name__
    _check_inputs(q, k, v, what=what)
    if path is not None and q.dtype == torch.float32:
        raise ValueError(f"{what}: the fp32 path has one design, no `path` to choose")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128) or k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"{what}: unsupported shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{what}: batch and heads must be < 65536")
    lib, fn = _entry(name, q.dtype)
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, d,
             d ** -0.5 * _LOG2E, -1 if path is None else ATTENTION_PATHS.index(path),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, what)
    _count(wrapper, (b, sq, sk, h, d), q.dtype)
    return o


def flash_attention(q, k, v):
    """K1: attention of q [B, Sq, H, D] over k, v [B, Sk, H, D] (D in
    {64, 128}), bfloat16 or float32; softmax in fp32.

    CPU tensors take `attention_plain`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _attention_call(flash_attention, "flash", q, k, v)


def packed_attention(q, k, v, heads: int):
    """K2: self-attention on packed heads [N, S, heads*d], S in {8,16,24,32},
    any d, bfloat16 or float32.

    CPU tensors take `packed_attention_plain`; CUDA tensors launch the
    kernel."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, heads)
    return _packed_call(q, k, v, heads)


def _packed_call(q, k, v, heads: int, path: str | None = None):
    """Launch K2 on [N, S, heads*d]. `path` (one of PACKED_PATHS) overrides
    the library's choice of design, for timing the designs against each
    other; the library refuses a design that does not take d."""
    _check_inputs(q, k, v, what="packed_attention")
    n, s, c = q.shape
    if (not packed_kernel_takes(s, c, heads) or k.shape != q.shape
            or v.shape != q.shape):
        raise ValueError(f"packed_attention: unsupported shape {tuple(q.shape)} "
                         f"with {heads} heads (needs S in 8/16/24/32, C a "
                         f"multiple of the heads and S * C < 2^31)")
    d = c // heads
    lib, fn = _entry("packed", q.dtype)
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, s, heads, d,
             d ** -0.5 * _LOG2E, -1 if path is None else PACKED_PATHS.index(path),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "packed_attention")
    _count(packed_attention, (n, s, c, heads), q.dtype)
    return o


def packed_kernel_takes(seq_len: int, channels: int, heads: int) -> bool:
    """The shapes K2 takes: S in {8,16,24,32} and C = heads * d, any d (a
    row's slab indexed in 32 bits, S * C < 2^31)."""
    return (seq_len in (8, 16, 24, 32) and heads > 0 and channels > 0
            and channels % heads == 0 and seq_len * channels < 2 ** 31)


# K2's designs, as its library numbers them (`plan` in the .cu): a warp a
# (row, head) on a tile of the head's whole 16-byte chunks (d % 8 == 0 up to
# 128), and CTAs that stage the chunks covering a span of whole heads of a row
# (any d).
PACKED_PATHS = ("head_tile", "span")


def packed_attention_path(d: int) -> str:
    """The design K2 takes at head width d, one of PACKED_PATHS: the
    library's own plan."""
    lib, _ = _entry("packed")
    fn = lib.moca_packed_attention_plan
    fn.argtypes, fn.restype = [_i], _i
    return PACKED_PATHS[fn(d)]


# K3's head split: a cluster of `split` CTAs shares one tile and splits its
# heads and output blocks. The bf16 path splits at C = 1280 only (one weight
# block a stage), where the tiles leave most of the card's SMs idle, so that
# the grid fills up to one wave. The fp32 path (one CTA an SM, 128-token
# tiles) splits where that shortens the waves of CTAs a launch takes, at any
# width whose heads divide: a grid of 1.2 waves takes two.
FUSED_SPLIT_MAX_CTAS = 132  # one wave on an H100 SXM (132 SMs, one CTA each)
FUSED_F32_TILE = 128        # token rows of an fp32 tile (whole sequences: 120 at S = 24)


def fused_qkv_head_split(n: int, s: int, c: int, dtype=torch.bfloat16) -> int:
    """CTAs that split one tile's heads at x [n, s, c]. bfloat16: at C = 1280
    the largest of 4 and 2 that divides the heads and keeps tiles * split
    within FUSED_SPLIT_MAX_CTAS, else 1. float32: of 1, 2, 4 and 5 (C = 320's
    heads) dividing the heads, the one that takes the fewest waves of CTAs
    for the tile's work (ceil(tiles * split / FUSED_SPLIT_MAX_CTAS) / split),
    each larger split only for more than a tenth fewer."""
    if dtype == torch.float32:
        tiles = -(-(n * s) // (FUSED_F32_TILE // s * s))
        waves = lambda k: -(-(tiles * k) // FUSED_SPLIT_MAX_CTAS) / k
        best = 1
        for split in (2, 4, 5):
            if (c // 64) % split == 0 and waves(split) < 0.9 * waves(best):
                best = split
        return best
    if c <= 640:
        return 1
    tiles = -(-(n * s) // ((64 // s) * s))
    for split in (4, 2):
        if (c // 64) % split == 0 and tiles * split <= FUSED_SPLIT_MAX_CTAS:
            return split
    return 1


def fused_qkv_attention(x, wq, wk, wv, wo, bo, heads: int):
    """K3: to_out(attention(x wq^T, x wk^T, x wv^T)) + bo on x [N, S, C],
    S in {8,16,24,32}, C = heads * 64 <= 1280; weights in nn.Linear's [out, in]
    layout [C, C], bias [C], bfloat16 or float32. Each tile's heads are split
    over clusters of `fused_qkv_head_split` CTAs. The wrapper passes the
    kernel a scratch of x's shape and dtype: the heads' outputs go through
    device memory.

    CPU tensors take `fused_qkv_attention_plain`; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads)
    _check_inputs(x, wq, wk, wv, wo, bo, what="fused_qkv_attention")
    n, s, c = x.shape
    if (s not in (8, 16, 24, 32) or c != heads * 64 or c > 1280
            or any(w.shape != (c, c) for w in (wq, wk, wv, wo)) or bo.shape != (c,)):
        raise ValueError(f"fused_qkv_attention: unsupported shapes x {tuple(x.shape)} "
                         f"with {heads} heads (needs d = 64, C <= 1280, S in 8/16/24/32, "
                         f"[C, C] weights and a [C] bias)")
    lib, fn = _entry("fused", x.dtype)
    o = torch.empty_like(x)
    scratch = torch.empty_like(x)  # the heads' outputs, read back by the out projection
    split = fused_qkv_head_split(n, s, c, x.dtype)
    err = fn(x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
             bo.data_ptr(), o.data_ptr(), scratch.data_ptr(), n, s, c, split,
             64 ** -0.5 * _LOG2E, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "fused_qkv_attention")
    _count(fused_qkv_attention, (n, s, c), x.dtype)
    return o


def flash_attention_onepass(q, k, v):
    """K4: attention of q [B, Sq, H, D] over k, v [B, Sk, H, D] (D in
    {64, 128}), bfloat16 or float32, with the row max taken over the whole
    row before any exponent.

    CPU tensors take `flash_attention_onepass_plain`; CUDA tensors launch the
    kernel."""
    if q.device.type == "cpu":
        return flash_attention_onepass_plain(q, k, v)
    return _attention_call(flash_attention_onepass, "onepass", q, k, v)


KERNELS = (flash_attention, packed_attention, fused_qkv_attention, flash_attention_onepass)


def reset_launch_counts():
    """Empty every wrapper's launch tally, {shape: launches} with shape
    (B, Sq, Sk, H, D) for K1 and K4, (N, S, C, heads) for K2 and (N, S, C)
    for K3 (whose head width is always 64); a launch of the fp32 path has
    "fp32" appended to its shape."""
    for fn in KERNELS:
        fn.launches = {}


reset_launch_counts()

