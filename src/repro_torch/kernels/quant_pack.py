"""Build and ctypes binding of the hand-written CUDA wire kernels
(``csrc/quant_pack.cu``; what each kernel replaces and what bounds it is
noted at the top of that file).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``_build/`` beside this file (listed in ``.gitignore``), keyed by a hash of
the source and flags so an edited source is rebuilt.  Nothing is compiled
or loaded at import time: this module must import on a machine without
``nvcc`` or a card.  The functions here launch on PyTorch's current stream,
allocate their outputs with ``torch.empty`` and raise if the launch is
refused; operand checks live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.compressors import inv_levels
from ..core.quantize import tau
from .ref import BLOCK

SOURCE = Path(__file__).parent / "csrc" / "quant_pack.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_BLOCKS = 132 * 8          # 8 resident 256-thread blocks on each of 132 SMs
_VP = ctypes.c_void_p


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA wire kernels cannot be built")
    return path


class _Library:
    """The loaded shared library and the compiler's report of its build."""

    def __init__(self):
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib_path = BUILD_DIR / f"libquant_pack_{digest[:16]}.so"
        self.build_log = f"cached: {lib_path.name}"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, lib_path)
            self.build_log = res.stdout + res.stderr
        self.path = lib_path
        lib = ctypes.CDLL(str(lib_path))
        lib.laq_absmax.argtypes = [_VP, _VP, ctypes.c_longlong, ctypes.c_int,
                                   _VP, ctypes.c_int, _VP, _VP]
        lib.laq_absmax.restype = ctypes.c_int
        lib.laq_quantize_pack.argtypes = [
            _VP, _VP, _VP, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, _VP, _VP, _VP, _VP, _VP,
            ctypes.c_int, _VP, _VP]
        lib.laq_quantize_pack.restype = ctypes.c_int
        lib.laq_sparse_quantize_pack.argtypes = [
            _VP, _VP, _VP, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, _VP, _VP, _VP, ctypes.c_int, _VP]
        lib.laq_sparse_quantize_pack.restype = ctypes.c_int
        lib.laq_quantize_codes.argtypes = [
            _VP, _VP, _VP, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, _VP, _VP, ctypes.c_int, _VP]
        lib.laq_quantize_codes.restype = ctypes.c_int
        lib.laq_quantize_pack_payload.argtypes = [
            _VP, _VP, _VP, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, _VP, _VP, ctypes.c_int, _VP]
        lib.laq_quantize_pack_payload.restype = ctypes.c_int
        lib.laq_dequant_acc.argtypes = [
            _VP, ctypes.c_longlong, ctypes.c_int, _VP, _VP, ctypes.c_float,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _VP, _VP,
            ctypes.c_int, _VP]
        lib.laq_dequant_acc.restype = ctypes.c_int
        for fn in (lib.laq_threads_per_block, lib.laq_max_workers):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        self.lib = lib
        self.threads = lib.laq_threads_per_block()
        self.max_workers = lib.laq_max_workers()


_LIBRARY: _Library | None = None


def library() -> _Library:
    """Build (once per source hash) and load the kernels."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = _Library()
    return _LIBRARY


def _check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def _grid(work_items: int, threads: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-work_items // threads)))


def _aligned(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _two_tau(bits: int) -> float:
    """``f32(2 tau)``, folded in double and rounded once."""
    return float(torch.tensor(2.0 * tau(bits), dtype=torch.float32))


def absmax_cuda(g: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """``max |g - qh|`` as a float32 0-d tensor; ``g``/``qh`` contiguous
    float32 CUDA vectors of one length n (0 gives R = 0)."""
    lib = library()
    n = g.numel()
    nparts = _grid(-(-n // 4), lib.threads)
    partial = torch.empty(nparts, dtype=torch.float32, device=g.device)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    _check(lib.lib.laq_absmax(g.data_ptr(), qh.data_ptr(), n,
                              _aligned(g, qh), partial.data_ptr(), nparts,
                              out.data_ptr(), _stream(g)), "laq_absmax")
    return out


def quantize_pack_cuda(g: torch.Tensor, qh: torch.Tensor, R: torch.Tensor,
                       bits: int, lane_bits: int = None):
    """``(packed, delta, q_new, err_sq, innovation_sq)`` for one flat leaf:
    ``packed`` uint8 ``[ceil(n lane_bits / 8)]`` (b-bit codes in
    ``lane_bits``-bit lanes, default b), ``delta``/``q_new`` float32
    ``[n]``, the moments float32 0-d tensors."""
    lib = library()
    lane_bits = bits if lane_bits is None else lane_bits
    n = g.numel()
    dev = g.device
    packed = torch.empty(-(-n * lane_bits // 8), dtype=torch.uint8, device=dev)
    delta = torch.empty(n, dtype=torch.float32, device=dev)
    q_new = torch.empty(n, dtype=torch.float32, device=dev)
    nparts = _grid(-(-n // 8), lib.threads)
    parts = torch.empty((2, nparts), dtype=torch.float64, device=dev)
    moments = torch.empty(2, dtype=torch.float32, device=dev)
    _check(lib.lib.laq_quantize_pack(
        g.data_ptr(), qh.data_ptr(), R.data_ptr(), _two_tau(bits), bits,
        lane_bits,
        n, _aligned(g, qh, packed, delta, q_new), packed.data_ptr(),
        delta.data_ptr(), q_new.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), nparts, moments.data_ptr(), _stream(g)),
        "laq_quantize_pack")
    return packed, delta, q_new, moments[0], moments[1]


def sparse_quantize_pack_cuda(vals: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, bits: int):
    """``(packed uint8 [ceil(k b / 8)], codes uint8 [k], deq f32 [k])`` for
    k contiguous float32 survivors on the card; ``lo``/``hi`` float32 0-d
    tensors there."""
    lib = library()
    k = vals.numel()
    dev = vals.device
    packed = torch.empty(-(-k * bits // 8), dtype=torch.uint8, device=dev)
    codes = torch.empty(k, dtype=torch.uint8, device=dev)
    deq = torch.empty(k, dtype=torch.float32, device=dev)
    _check(lib.lib.laq_sparse_quantize_pack(
        vals.data_ptr(), lo.data_ptr(), hi.data_ptr(), inv_levels(bits), bits,
        k, _aligned(vals, packed, codes, deq), packed.data_ptr(),
        codes.data_ptr(), deq.data_ptr(), _grid(-(-k // 8), lib.threads),
        _stream(vals)), "laq_sparse_quantize_pack")
    return packed, codes, deq


def quantize_codes_cuda(g: torch.Tensor, qh: torch.Tensor, R: torch.Tensor,
                        bits: int):
    """``(codes uint8 [n], delta f32 [n])`` for one flat leaf, the codes
    unpacked."""
    lib = library()
    n = g.numel()
    codes = torch.empty(n, dtype=torch.uint8, device=g.device)
    delta = torch.empty(n, dtype=torch.float32, device=g.device)
    _check(lib.lib.laq_quantize_codes(
        g.data_ptr(), qh.data_ptr(), R.data_ptr(), _two_tau(bits), bits, n,
        _aligned(g, qh, codes, delta), codes.data_ptr(), delta.data_ptr(),
        _grid(-(-n // 8), lib.threads), _stream(g)), "laq_quantize_codes")
    return codes, delta


def quantize_pack_payload_cuda(g: torch.Tensor, qh: torch.Tensor,
                               R: torch.Tensor, bits: int):
    """``(packed uint8 [ceil(n / 4096) * 4096 * b / 8], delta f32 [n])``
    for one flat leaf; the pad elements are quantized as ``d = 0``."""
    lib = library()
    n = g.numel()
    npad = -(-n // BLOCK) * BLOCK
    packed = torch.empty(npad * bits // 8, dtype=torch.uint8, device=g.device)
    delta = torch.empty(n, dtype=torch.float32, device=g.device)
    _check(lib.lib.laq_quantize_pack_payload(
        g.data_ptr(), qh.data_ptr(), R.data_ptr(), _two_tau(bits), bits, n,
        npad, _aligned(g, qh, packed, delta), packed.data_ptr(),
        delta.data_ptr(), _grid(npad // 8, lib.threads), _stream(g)),
        "laq_quantize_pack_payload")
    return packed, delta


def dequant_acc_cuda(packed: torch.Tensor, R: torch.Tensor,
                     keep: torch.Tensor, bits: int, n: int,
                     acc: torch.Tensor = None) -> torch.Tensor:
    """``(acc or 0) + sum_w keep_w * delta_w`` as float32 ``[n]`` from the
    contiguous uint8 rows ``packed [W, nbytes]`` and the float32 ``[W]``
    radii and 0/1 mask, all on the card."""
    lib = library()
    W, nbytes = packed.shape
    if not 1 <= W <= lib.max_workers:
        raise ValueError(f"laq_dequant_acc takes 1 to {lib.max_workers} "
                         f"workers, got {W}")
    out = torch.empty(n, dtype=torch.float32, device=packed.device)
    vec = [packed, out] + ([] if acc is None else [acc])
    aligned = _aligned(*vec) and nbytes % 8 == 0
    _check(lib.lib.laq_dequant_acc(
        packed.data_ptr(), nbytes, W, R.data_ptr(), keep.data_ptr(),
        _two_tau(bits), bits, n, int(aligned),
        None if acc is None else acc.data_ptr(), out.data_ptr(),
        _grid(-(-n // 8), lib.threads), _stream(packed)), "laq_dequant_acc")
    return out
