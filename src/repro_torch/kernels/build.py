"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` into one shared library, loaded with ``ctypes``.  Each source
(each variant of a source: ``PARTS``) is compiled in its own
``nvcc`` process, all started together, then linked.
The library lands in ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``) under a name that hashes the sources and flags,
so an edited source is never served by a stale build.  Nothing is built at
import: the first kernel launch builds, or ``chip_smoke.py`` calls
``build()`` up front to time it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core.tiling import HALO_FIELDS, WGMMA_FIELDS, operand_route

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("deconv_fwd.cu", "conv_fwd.cu", "deconv_dw.cu",
           "deconv_wgmma.cu")
HEADERS = ("igemm.cuh",)
# each source compiles once per variant of its kernels (-DREPRO_PART=k),
# so the variants build in parallel: the forward sources per (x, w)
# operand pair x copy width, f32/f32 on the FMA route (parts 0-1),
# bf16/bf16 on the bf16 route (2-3), f32/int8 and bf16/int8 on the TF32
# route (4-7), then int8/int8 (the s8 route) per A copy width (8-10),
# then the bf16 route's halo staging (11; igemm.cuh::variant_part); the
# dw source per operand type x A's x B's copy width; the bf16 route's
# wgmma staging (deconv_wgmma.cu, which deconv_fwd.cu's entry calls) is
# one object of its own
PARTS = {"deconv_fwd.cu": 12, "conv_fwd.cu": 12, "deconv_dw.cu": 8}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(compile_units()).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def compile_units() -> list[tuple[str, str, tuple[str, ...]]]:
    """(source, object stem, extra nvcc flags) of every object."""
    units = []
    for src in SOURCES:
        stem = Path(src).stem
        if src in PARTS:
            units += [(src, f"{stem}_p{k}", (f"-DREPRO_PART={k}",))
                      for k in range(PARTS[src])]
        else:
            units.append((src, stem, ()))
    return units


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns its path and the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills), one
    ``== <source> <flags> (<seconds> s)`` section per object."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, \
            contextlib.ExitStack() as files:
        procs = []
        t0 = time.perf_counter()
        for src, stem, flags in compile_units():
            obj = Path(tmp) / (stem + ".o")
            out = files.enter_context(open(Path(tmp) / (stem + ".log"), "w+"))
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / src), "-o",
                   str(obj)]
            procs.append([" ".join((src, *flags)), obj, out, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT), None])
        while any(p[4] is None for p in procs):     # each object's seconds
            for p in procs:
                if p[4] is None and p[3].poll() is not None:
                    p[4] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for unit, _, out, proc, secs in procs:
            out.seek(0)
            logs.append(f"== {unit} ({secs:.1f} s)\n{out.read()}")
            if proc.returncode != 0:
                failed.append(unit)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(p[1]) for p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib, "\n".join(logs)


_P = ctypes.c_void_p
_I = ctypes.c_int

# operand type codes of igemm.cuh (DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the (x, w) operand types each kernel takes: the dw kernel floats of one
# type; the forward kernels also int8 weights beside float or int8
# activations, the pairs repro_torch.quant.Precision produces (each
# pair's route: tiling.operand_route)
FLOAT_PAIRS = frozenset({(torch.float32, torch.float32),
                         (torch.bfloat16, torch.bfloat16)})
FORWARD_PAIRS = FLOAT_PAIRS | {(torch.float32, torch.int8),
                               (torch.bfloat16, torch.int8),
                               (torch.int8, torch.int8)}
S8_PAIR = (torch.int8, torch.int8)
_INT32_MAX = 2 ** 31 - 1
# the most one product of two int8 values can be, in magnitude
_S8_PRODUCT_MAX = 128 * 128


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def check_operands(x, w, scale, bias, out_dtype, *, co: int,
                   pairs=FORWARD_PAIRS):
    """Validate what a kernel takes; returns the f32 scale/bias views.

    ``(x.dtype, w.dtype)`` must be one of ``pairs`` (``FORWARD_PAIRS`` for
    the deconv and conv kernels, ``FLOAT_PAIRS`` for the dw kernel) and the
    output float32 or bfloat16; anything else raises TypeError, a layout
    or placement the kernels do not take ValueError.
    """
    if (x.dtype, w.dtype) not in pairs:
        raise TypeError(
            f"x is {x.dtype} and w is {w.dtype}; this kernel takes (x, w) "
            f"in {sorted((_name(a), _name(b)) for a, b in pairs)}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    out = []
    for name, v in (("scale", scale), ("bias", bias)):
        if v is not None:
            if v.numel() != co or v.device != x.device:
                raise ValueError(f"{name} must hold {co} values on "
                                 f"{x.device}, got {tuple(v.shape)} on "
                                 f"{v.device}")
            v = v.reshape(co).to(torch.float32).contiguous()
        out.append(v)
    return tuple(out)


def forward_route(x, w, depth: int) -> str:
    """The route of a forward launch of ``x`` and ``w``
    (``tiling.operand_route``, one of four: ``"fma"`` for f32 x f32,
    ``"bf16"`` for bf16 x bf16, ``"tf32"`` for int8 weights beside f32 or
    bf16 activations, ``"s8"`` for int8 x int8).  The
    int8 x int8 route takes its weights K-major (4-D,
    ``common.kmajor_weights``, 16-byte aligned for its copies) and no
    other route does; its reduction of ``depth`` pairs must fit
    ``check_s8_depth``.  TypeError or ValueError otherwise."""
    s8 = (x.dtype, w.dtype) == S8_PAIR
    if (w.dim() == 4) != s8:
        raise TypeError(f"x is {x.dtype} and w is {w.dtype} of {w.dim()} "
                        f"dims: int8 x int8 takes K-major weights "
                        f"(common.kmajor_weights), and only it does")
    if s8:
        check_s8_depth(depth)
        if w.data_ptr() % 16:
            raise ValueError("K-major weights must be 16-byte aligned")
    return operand_route(x.element_size(), w.element_size())


# the kernels a forward C entry reports in its ``launched`` out-parameter
# (igemm.cuh::Launched), by their routes' names: igemm_kernel,
# igemm_tf32_kernel, igemm_s8_kernel, igemm_bf16_kernel (and
# igemm_bf16_halo_kernel, deconv_wgmma.cu's igemm_bf16_wgmma_kernel); and
# how the kernel staged A (igemm.cuh::Staging, deconv_wgmma.cu's
# wg::STAGING)
LAUNCHED_ROUTES = ("fma", "tf32", "s8", "bf16")
STAGINGS = ("gather", "halo", "wgmma")


def launched_buffer() -> ctypes.Array:
    """The forward C entries' ``launched`` out-parameter: the kernel the
    call launched (an index of ``LAUNCHED_ROUTES``: f32 FMAs on the CUDA
    cores, the TF32 route, the s8 route, the bf16 route's ``mma.sync``
    m16n8k16), the products a k8 step of it runs per fragment (the TF32
    route's passes, else 1) and how it staged A (an index of
    ``STAGINGS``: gathered per row and tap, a box's footprint once, or
    TMA boxes for wgmma); -1 until a kernel has launched."""
    return (ctypes.c_int * 3)(-1, -1, -1)


def halo_array(halo) -> ctypes.Array | None:
    """The forward C entries' ``halo`` argument: the planner's
    ``tiling.HaloPlan`` as igemm.cuh's ``Halo`` (``HALO_FIELDS`` ints), or
    None (a null pointer: the gather)."""
    if halo is None:
        return None
    fields = halo.fields()
    if len(fields) != HALO_FIELDS:
        raise ValueError(f"bad halo staging {fields}")
    return (ctypes.c_int * HALO_FIELDS)(*fields)


def record_operands(record: dict, x, w, launched, *,
                    staging: dict | None = None,
                    halo: bool = False, wgmma: bool = False) -> tuple:
    """Count one launch in ``record`` (a wrapper's ``operand_launches``)
    under its ``(x, w)`` operand type names and the route and passes the
    C entry reported in ``launched`` (``launched_buffer``); RuntimeError
    when it reported no kernel.  With ``staging`` (a wrapper's
    ``staging_launches``) count it there too under ``(x, w, route,
    staging)``, the staging the C entry reported, which must be the wgmma
    staging when the planner chose it (``wgmma``), the halo staging when
    it chose that (``halo``) and the gather when neither: RuntimeError
    otherwise (nothing falls back).  Returns the launch's ``(x, w, route,
    passes)``, its staging appended where counted."""
    kernel, passes = launched[0], launched[1]
    if not 0 <= kernel < len(LAUNCHED_ROUTES) or passes < 1:
        raise RuntimeError(f"the forward entry reported no launch "
                           f"({kernel}, {passes})")
    key = (_name(x.dtype), _name(w.dtype), LAUNCHED_ROUTES[kernel], passes)
    record[key] = record.get(key, 0) + 1
    if staging is None:
        return key
    planned = STAGINGS.index("wgmma") if wgmma else int(halo)
    if len(launched) <= 2 or launched[2] != planned:
        got = launched[2] if len(launched) > 2 else None
        raise RuntimeError(f"the forward entry reported staging {got}; the "
                           f"planner chose {STAGINGS[planned]}")
    staged = key[:3] + (STAGINGS[launched[2]],)
    staging[staged] = staging.get(staged, 0) + 1
    return key + staged[3:]


def wgmma_array(plan) -> ctypes.Array | None:
    """The forward entry's ``wgmma`` argument: the planner's
    ``tiling.WgmmaPlan`` as deconv_wgmma.cu's ``WgmmaPlan``
    (``WGMMA_FIELDS`` ints), or None (null: no wgmma staging)."""
    if plan is None:
        return None
    fields = plan.fields()
    if len(fields) != WGMMA_FIELDS:
        raise ValueError(f"bad wgmma staging {fields}")
    return (ctypes.c_int * WGMMA_FIELDS)(*fields)


def default_out_dtype(x) -> torch.dtype:
    """The output type when the caller names none: x's for float x, f32
    for int8 x (quantized inputs never store quantized)."""
    return x.dtype if x.dtype.is_floating_point else torch.float32


def geom_array(vals, fields: int = 27) -> ctypes.Array:
    """Pack a kernel's geometry struct for the C call: igemm.cuh's ``Geom``
    (27 ints) or deconv_dw.cu's ``DwGeom`` (``fields=24``)."""
    vals = [int(v) for v in vals]
    if len(vals) != fields or any(not 0 <= v <= _INT32_MAX for v in vals):
        raise ValueError(f"bad kernel geometry {vals}")
    if fields == 27:
        n, pd, ph, pw = vals[0], vals[16], vals[17], vals[18]
        if n * pd * ph * pw > _INT32_MAX:
            raise ValueError(f"{n * pd * ph * pw} output rows exceed the "
                             f"kernels' 32-bit row index")
        # igemm.cuh indexes input positions (not elements) in 32 bits
        if n * vals[1] * vals[2] * vals[3] > _INT32_MAX // 2:
            raise ValueError(f"{n * vals[1] * vals[2] * vals[3]} input "
                             f"positions exceed the kernels' 32-bit index")
    else:
        # deconv_dw.cu indexes A's rows and B's positions in 32 bits
        n = vals[0]
        for what, ext in (("A rows", vals[1:4]), ("B positions", vals[5:8])):
            if n * ext[0] * ext[1] * ext[2] > _INT32_MAX // 2:
                raise ValueError(f"{n * ext[0] * ext[1] * ext[2]} {what} "
                                 f"exceed the dw kernel's 32-bit index")
    return (ctypes.c_int * fields)(*vals)


def _vector_ok(t, channels: int) -> bool:
    """Whether 16-byte copies (4 f32, 8 bf16 or 16 int8 consecutive
    channels) may stage ``t``: its per-group ``channels`` a multiple of
    that, its base address 16-byte aligned."""
    return (channels % (16 // t.element_size()) == 0
            and t.data_ptr() % 16 == 0)


def vector_copies(x, w, cig: int, cog: int) -> bool:
    """Whether igemm.cuh may stage both operands with 16-byte copies: of
    one (row, tap) for x and of one weight row for w."""
    return _vector_ok(x, cig) and _vector_ok(w, cog)


def a_copy_bytes(x, cig: int) -> int:
    """The int8 route's bytes per copy of A (x's channels of one row and
    tap): 16 where Cin/G is a multiple of 16, 4 (cp.async's smallest
    copy) where it is a multiple of 4, else 1 (byte loads); x's base
    aligned to the copy.  B's copies are 16 bytes whatever the layer."""
    for nbytes in (16, 4):
        if cig % nbytes == 0 and x.data_ptr() % nbytes == 0:
            return nbytes
    return 1


# the bf16 route's copy bits (igemm.cuh BF16_COPY_A16, BF16_COPY_B16)
BF16_COPY_A16, BF16_COPY_B16 = 1, 2


def copy_variant(x, w, cig: int, cog: int) -> int:
    """The forward C entry's ``copy`` argument (igemm.cuh::variant_part):
    A's bytes per copy on the s8 route; on the bf16 route a bit per
    operand that takes 16-byte copies, each on its own (1: x, 2: w;
    ``_vector_ok``); else (the FMA and TF32 routes) whether both operands
    take 16-byte copies."""
    route = operand_route(x.element_size(), w.element_size())
    if route == "s8":
        return a_copy_bytes(x, cig)
    if route == "bf16":
        return (BF16_COPY_A16 * int(_vector_ok(x, cig))
                | BF16_COPY_B16 * int(_vector_ok(w, cog)))
    return int(vector_copies(x, w, cig, cog))


def check_s8_depth(depth: int) -> None:
    """The int8 route sums int8 x int8 products in int32: refuse a
    reduction of ``depth`` (tap, channel) pairs whose sum could leave that
    range (128^2 x depth >= 2^31: deeper than 131,071 pairs)."""
    if _S8_PRODUCT_MAX * depth > _INT32_MAX:
        raise ValueError(
            f"int8 x int8 reduction of {depth} (tap, channel) pairs: sums "
            f"of up to {_S8_PRODUCT_MAX} x {depth} could overflow the "
            f"kernel's int32 accumulators (at most "
            f"{_INT32_MAX // _S8_PRODUCT_MAX} pairs)")


def dw_vector_copies(a, b, ag: int, bg: int) -> tuple[bool, bool]:
    """Whether deconv_dw.cu may stage A and B with 16-byte copies, each
    operand on its own: of one row of A, of one tap of one row of B."""
    return _vector_ok(a, ag), _vector_ok(b, bg)


def split_workspace(splits: int, elems: int, device, route: str):
    """The partial sums of a split launch, ``splits`` x ``elems``: f32, or
    int32 on the s8 route, the same bytes (None for an unsplit
    launch)."""
    if splits == 1:
        return None
    return torch.empty(splits * elems, device=device,
                       dtype=torch.int32 if route == "s8" else torch.float32)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ints = ctypes.POINTER(ctypes.c_int)
    lib.repro_deconv_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, ints, _I,
                                     ctypes.c_float, _I, _I, _I, _I, _I,
                                     ints, ints, ints, _P]
    lib.repro_deconv_fwd.restype = _I
    lib.repro_conv_fwd.argtypes = [_P, _P, _P, _P, _P, _P, ints, _I,
                                   ctypes.c_float, _I, _I, _I, _I, _I, ints,
                                   ints, _P]
    lib.repro_conv_fwd.restype = _I
    lib.repro_deconv_dw.argtypes = [_P, _P, _P, _P, ints, _I, _I, _I, _I,
                                    _I, _I, _I, _P]
    lib.repro_deconv_dw.restype = _I
    return lib
