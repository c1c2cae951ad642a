"""Dispatch layer for the wire kernels, port of ``repro/kernels/ops.py``.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`); a
CUDA tensor goes to the hand-written kernel (:mod:`.quant_pack`), and the
wrapper raises if the kernel cannot take it.  There is no fallback from
one to the other.  Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``, incremented only where it
launches, so a run can show that its main path went through the kernel.

Unlike the Pallas wrappers, nothing is padded to a block: the CUDA kernels
mask the ragged tail themselves, and the payload is ``ceil(n b / 8)``
bytes.  The exception is :func:`quantize_pack`, whose payload keeps the
Pallas wrapper's padding to 4096 elements byte for byte (its callers
compare payloads with the reference's).
"""
from __future__ import annotations

import torch

from . import quant_pack
from .ref import (absmax_ref, dequant_acc_ref, quantize_codes_adaptive_ref,
                  quantize_codes_ref, quantize_pack_adaptive_ref,
                  quantize_pack_fused_ref, quantize_pack_payload_ref,
                  sparse_quantize_pack_ref)

PACKED_BITS = (1, 2, 4, 8)


def _flat_pair(grad: torch.Tensor, qhat: torch.Tensor):
    """Validate one leaf's operands; returns them as flat float32 vectors.
    A bfloat16 ``qhat`` (``StrategyConfig.state_bf16``) is cast to float32
    here, one leaf at a time, as the reference's ``_pad_pair`` casts it:
    the kernels read ``const float* qh``."""
    if qhat.dtype == torch.bfloat16:
        qhat = qhat.to(torch.float32)
    for name, t in (("grad", grad), ("qhat", qhat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} on unsupported device {t.device}")
    if grad.device != qhat.device:
        raise ValueError(f"grad on {grad.device}, qhat on {qhat.device}")
    if grad.numel() != qhat.numel():
        raise ValueError(f"grad has {grad.numel()} elements, qhat "
                         f"{qhat.numel()}")
    if grad.device.type == "cuda" and not (grad.is_contiguous()
                                           and qhat.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous operands")
    return grad.reshape(-1), qhat.reshape(-1)


def _check_bits(bits):
    if bits not in PACKED_BITS:
        raise ValueError(f"bits must be one of {PACKED_BITS}, got {bits}")


def _check_scalar(name, x, device):
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != device:
        raise ValueError(f"{name} must be one float32 on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def absmax(grad: torch.Tensor, qhat: torch.Tensor) -> torch.Tensor:
    """Pass 1: R = ||grad - qhat||_inf without materializing the diff;
    a float32 0-d tensor on the operands' device."""
    g, qh = _flat_pair(grad, qhat)
    if g.device.type == "cpu":
        return absmax_ref(g, qh)
    out = quant_pack.absmax_cuda(g, qh)
    absmax.launches += 1
    return out


absmax.launches = 0


def quantize_pack_fused(grad: torch.Tensor, qhat: torch.Tensor,
                        R: torch.Tensor, bits: int):
    """Pass 2: codes packed little-end-first, delta, q_new and both
    criterion moments in one sweep.

    Returns ``(packed uint8 [ceil(n b / 8)], delta f32 [n], q_new f32 [n],
    err_sq, innovation_sq)``; the moments are ``||grad - q_new||^2`` and
    ``||delta||^2`` as float32 0-d tensors.
    """
    _check_bits(bits)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_pack_fused_ref(g, qh, R.reshape(()), bits)
    out = quant_pack.quantize_pack_cuda(g, qh, R.reshape(()).contiguous(),
                                        bits)
    quantize_pack_fused.launches += 1
    return out


quantize_pack_fused.launches = 0


def _selection(onehot, grid) -> int:
    """Index of the width ``onehot`` selects from the ascending ``grid``
    (read on the host: ``onehot`` comes from ``adaptive.select_bits``)."""
    for b in grid:
        _check_bits(b)
    if list(grid) != sorted(grid) or len(onehot) != len(grid):
        raise ValueError(f"grid {grid} must be ascending, one onehot entry "
                         f"per width (got {len(onehot)})")
    return int(torch.as_tensor(onehot).argmax())


def _count_width(wrapper, b):
    wrapper.launches += 1
    wrapper.launches_by_width[b] = wrapper.launches_by_width.get(b, 0) + 1


def quantize_pack_adaptive(grad: torch.Tensor, qhat: torch.Tensor,
                           R: torch.Tensor, onehot, grid: tuple):
    """Adaptive pass 2: :func:`quantize_pack_fused` at the width ``onehot``
    selects from the ascending static ``grid``, with the codes packed into
    ``max(grid)``-bit lanes (``ceil(n max(grid) / 8)`` bytes).  The
    selection is read on the host (``onehot`` comes from
    ``adaptive.select_bits`` there), which picks the kernel's arm.  A
    pinned selection equals :func:`quantize_pack_fused` at that width on R,
    codes, delta, q_new and the moments.

    Returns ``(packed, delta, q_new, err_sq, innovation_sq)``.
    """
    grid = tuple(grid)
    sel = _selection(onehot, grid)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_pack_adaptive_ref(g, qh, R.reshape(()), grid, sel)
    out = quant_pack.quantize_pack_cuda(g, qh, R.reshape(()).contiguous(),
                                        grid[sel], max(grid))
    _count_width(quantize_pack_adaptive, grid[sel])
    return out


quantize_pack_adaptive.launches = 0
# the same launches split by the selected width (the kernel's arm)
quantize_pack_adaptive.launches_by_width = {}


def sparse_quantize_pack(vals: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, bits: int):
    """Sparse quantize + pack on the k gathered survivors of the EF-LAQ
    wire: the sign-magnitude b-bit grid on [lo, hi].

    Returns ``(packed uint8 [ceil(k b / 8)], codes uint8 [k], deq f32
    [k])``; the tail byte's unused lanes carry the midpoint code.
    """
    _check_bits(bits)
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vals on unsupported device {vals.device}")
    if vals.device.type == "cuda" and not vals.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous operands")
    for name, x in (("lo", lo), ("hi", hi)):
        _check_scalar(name, x, vals.device)
    v = vals.reshape(-1)
    if v.device.type == "cpu":
        return sparse_quantize_pack_ref(v, lo.reshape(()), hi.reshape(()),
                                        bits)
    out = quant_pack.sparse_quantize_pack_cuda(
        v, lo.reshape(()).contiguous(), hi.reshape(()).contiguous(), bits)
    sparse_quantize_pack.launches += 1
    return out


sparse_quantize_pack.launches = 0


def quantize_codes_fused(grad: torch.Tensor, qhat: torch.Tensor,
                         R: torch.Tensor, bits: int):
    """Pass 2 of the streamed sharded wire: codes and delta in one sweep,
    the codes left unpacked (the wire packs them along the leaf's last dim
    itself, ``core/wire.py`` ``pack_codes_along_axis``).

    Returns ``(codes uint8 [n], delta f32 [n])``; callers reshape them to
    the leaf's shape.
    """
    _check_bits(bits)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_codes_ref(g, qh, R.reshape(()), bits)
    out = quant_pack.quantize_codes_cuda(g, qh, R.reshape(()).contiguous(),
                                         bits)
    quantize_codes_fused.launches += 1
    return out


quantize_codes_fused.launches = 0


def quantize_codes_adaptive(grad: torch.Tensor, qhat: torch.Tensor,
                            R: torch.Tensor, onehot, grid: tuple):
    """:func:`quantize_codes_fused` at the width ``onehot`` selects from the
    ascending static ``grid``.  The selection is read on the host, which
    picks the kernel's arm, so a pinned width is
    :func:`quantize_codes_fused` at that width bit for bit.

    Returns ``(codes uint8 [n], delta f32 [n])``.
    """
    grid = tuple(grid)
    sel = _selection(onehot, grid)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_codes_adaptive_ref(g, qh, R.reshape(()), grid, sel)
    out = quant_pack.quantize_codes_cuda(g, qh, R.reshape(()).contiguous(),
                                         grid[sel])
    _count_width(quantize_codes_adaptive, grid[sel])
    return out


quantize_codes_adaptive.launches = 0
# the same launches split by the selected width (the kernel's arm)
quantize_codes_adaptive.launches_by_width = {}


def quantize_pack(grad: torch.Tensor, qhat: torch.Tensor, R: torch.Tensor,
                  bits: int):
    """Payload-only pass 2: ``(packed uint8 [ceil(n / 4096) * 4096 * b /
    8], delta f32 [n])``, no q_new and no moments.  The payload is padded
    as the Pallas wrapper pads it: the pad elements are quantized as
    ``d = 0`` under R."""
    _check_bits(bits)
    g, qh = _flat_pair(grad, qhat)
    _check_scalar("R", R, g.device)
    if g.device.type == "cpu":
        return quantize_pack_payload_ref(g, qh, R.reshape(()), bits)
    out = quant_pack.quantize_pack_payload_cuda(
        g, qh, R.reshape(()).contiguous(), bits)
    quantize_pack.launches += 1
    return out


quantize_pack.launches = 0


def dequant_acc(packed: torch.Tensor, R: torch.Tensor, keep: torch.Tensor,
                bits: int, n: int, acc: torch.Tensor = None) -> torch.Tensor:
    """Receive side: ``acc + sum_w keep_w * delta_w`` decoded from the
    packed payloads ``packed`` uint8 ``[W, nbytes]`` with ``nbytes * 8 / b
    >= n`` (a block-padded payload from :func:`quantize_pack` is taken as
    it is), radii ``R`` and 0/1 mask ``keep`` float32 ``[W]``.  Returns
    float32 ``[n]``.

    The sum runs as the Pallas kernel runs it: ``acc`` first, then worker
    by worker (``((acc + d_0) + d_1) + ...``, from 0 without ``acc``).
    """
    _check_bits(bits)
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"packed must be uint8 [W, nbytes], got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    W, nbytes = packed.shape
    dev = packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"packed on unsupported device {dev}")
    if nbytes * 8 // bits < n:
        raise ValueError(f"{nbytes} bytes per worker hold {nbytes * 8 // bits}"
                         f" codes at b={bits}, fewer than n={n}")
    for name, x in (("R", R), ("keep", keep)):
        if x.dtype != torch.float32 or x.shape != (W,) or x.device != dev:
            raise ValueError(f"{name} must be float32 [{W}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if acc is not None and (acc.dtype != torch.float32 or acc.numel() != n
                            or acc.device != dev):
        raise ValueError(f"acc must be float32 with {n} elements on {dev}")
    if dev.type == "cpu":
        return dequant_acc_ref(packed, R, keep, bits, n, acc)
    out = quant_pack.dequant_acc_cuda(
        packed.contiguous(), R.contiguous(), keep.contiguous(), bits, n,
        None if acc is None else acc.reshape(-1).contiguous())
    dequant_acc.launches += 1
    return out


dequant_acc.launches = 0
