"""NumPy-facing API on PyTorch — drop-in for the reference package ``edt``.

Counterpart of ``edt_tpu.api``: the same normalisation and dispatch (list
inputs, empty arrays, contiguity, C/F order, dtype acceptance ((u)int8-64,
float32/64, bool), default anisotropy, and the ``parallel``/``order``
keywords accepted for compatibility). The compute runs through
``ops.compose`` on a CUDA device unless ``device=`` names another; with no
CUDA device and no ``device=`` every entry point raises. Axes longer than
the device path takes fall back to the exact host implementation, as the
JAX API's do past its device limits, except under ``voxel_graph=``, which
has no host path there either and runs on the device at any length.

As the JAX API does, this one shards a 3-D volume of at least
``EDT_TPU_SHARD_MIN_VOXELS`` voxels (default 600^3) over every card when
the process sees more than one and no ``device=`` pins the call
(``_shard_devices``): one process drives them all (``parallel.local``),
bit-identical to one card, and ``counters.sharded_dispatches`` counts the
call. The voxel graph does the same on its doubled size. Under a
``torch.distributed`` group of more than one rank, JAX's multi-process
case, nothing auto-shards: every rank calls ``edt_tpu_torch.parallel``'s
sharded functions explicitly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from edt_tpu_torch.ops import compose
from edt_tpu_torch.ops import voxel_graph as vg
from edt_tpu_torch.utils import host_reference
from edt_tpu_torch.utils import profiling
from edt_tpu_torch.utils.profiling import counters

# Longest axis the device path takes; longer axes take the host's banded
# path, as the JAX API's do past its own device limits. CUDA: K1 takes any
# length, and this is where its shared-memory mode ends (``MAX_AXIS`` of
# ``ops/minplus.py``), held here so the API dispatches as it always has.
# CPU: the plain min-plus is O(n^2) a row, the same length as the JAX
# package off the TPU.
_DEVICE_MAX_AXIS_CUDA = 58048
_DEVICE_MAX_AXIS_CPU = 128


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "edt_tpu_torch: no CUDA device; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _shard_min_voxels() -> int:
    """Volumes at least this big auto-shard over every card (when there
    are several): ``EDT_TPU_SHARD_MIN_VOXELS``, default 600^3, the JAX
    package's."""
    return int(os.environ.get("EDT_TPU_SHARD_MIN_VOXELS", str(600 ** 3)))


def _shard_devices(device):
    """The cards a NumPy call shards over, or None (counterpart of the
    JAX API's ``_all_devices_addressable``): None where the caller pinned
    ``device``, where fewer than two cards are visible, and under an
    initialised ``torch.distributed`` group of more than one rank, where
    each rank would otherwise take every card. The host-fallback path
    never asks."""
    if device is not None or torch.cuda.device_count() < 2:
        return None
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_max_axis(device: torch.device) -> int:
    return (_DEVICE_MAX_AXIS_CUDA if device.type == "cuda"
            else _DEVICE_MAX_AXIS_CPU)


def _order_of(data: np.ndarray) -> str:
    return "F" if data.flags.f_contiguous and not data.flags.c_contiguous else "C"


def _as_device_labels(data: np.ndarray) -> np.ndarray:
    """Map any supported dtype onto labels torch compares natively.

    Only label *equality* and *zeroness* matter downstream, so any
    equality-preserving, zero-preserving remap is legal. uint8 and float32
    stay; uint32 is viewed as int32; narrower integers widen to int32.
    """
    dt = data.dtype
    if dt == np.bool_:
        return data.view(np.uint8)
    if dt in (np.uint8, np.int32, np.float32):
        return data
    if dt == np.uint32:
        return data.view(np.int32)
    if dt == np.int8:
        return data.astype(np.uint8)  # bijective wrap
    if dt in (np.uint16, np.int16):
        return data.astype(np.int32)
    if dt in (np.uint64, np.int64, np.float64):
        # 64-bit label spaces: try a lossless narrowing first; otherwise
        # factorize to compact int32 ids (equality- and zero-preserving).
        if dt == np.float64:
            as32 = data.astype(np.float32)
            if np.array_equal(as32.astype(np.float64), data):
                return as32
        else:
            info = np.iinfo(np.int32)
            lo = data.min() if data.size else 0
            hi = data.max() if data.size else 0
            if lo >= (0 if dt == np.uint64 else info.min) and hi <= info.max:
                return data.astype(np.int32)
        uniq, inv = np.unique(data, return_inverse=True)
        ids = np.arange(1, uniq.size + 1, dtype=np.int32)
        zero_idx = np.searchsorted(uniq, 0)
        if zero_idx < uniq.size and uniq[zero_idx] == 0:
            ids[zero_idx] = 0
        return ids[inv].reshape(data.shape)
    raise TypeError(f"Unsupported data type: {dt}")


def _sorted_axis_order(anisotropy):
    """Static pass order: ascending pitch, default (nd-1 .. 0) on ties."""
    nd = anisotropy.size
    return tuple(sorted(range(nd), key=lambda a: (float(anisotropy[a]), -a)))


def _normalize_anisotropy(anisotropy, dims):
    if anisotropy is None:
        anisotropy = (1.0,) * dims
    anisotropy = np.asarray(anisotropy, dtype=np.float32).reshape(-1)
    if anisotropy.size == 1 and dims > 1:
        anisotropy = np.repeat(anisotropy, dims)
    if anisotropy.size != dims:
        raise ValueError(
            f"anisotropy must have {dims} components, got {anisotropy.size}"
        )
    return anisotropy


def edtsq(
    data,
    anisotropy=None,
    black_border=False,
    parallel=1,
    voxel_graph=None,
    order=None,
    *,
    binary=False,
    device=None,
):
    """Squared anisotropic multi-label EDT of a 1/2/3-D array.

    ``parallel`` and ``order`` are accepted for API compatibility.
    ``binary=True`` treats any nonzero voxel as one foreground label; bool
    inputs take that path automatically. ``device`` selects the torch
    device (default CUDA; a 3-D volume of at least ``_shard_min_voxels()``
    voxels shards over every card where there are several).
    """
    dev = _device(device)
    if isinstance(data, list):
        data = np.array(data)
    data = np.asarray(data)

    dims = data.ndim
    if data.size == 0:
        return np.zeros(shape=data.shape, dtype=np.float32)

    arr_order = _order_of(data)
    if not data.flags.c_contiguous and not data.flags.f_contiguous:
        data = np.ascontiguousarray(data)

    if voxel_graph is not None and dims not in (2, 3):
        raise TypeError(
            "Voxel connectivity graph is only supported for 2D and 3D. "
            f"Got {dims}."
        )
    if dims not in (1, 2, 3):
        raise TypeError(
            f"Multi-Label EDT library only supports up to 3 dimensions got {dims}."
        )

    anisotropy = _normalize_anisotropy(anisotropy, dims)

    # The binary reduction comes before dispatch so the device and host
    # paths see one mask, except under voxel_graph: its foreground test
    # differs for floats (negative labels are background there), and it
    # applies its own.
    take_binary = bool(data.dtype == np.bool_) or binary
    if binary and data.dtype != np.bool_ and voxel_graph is None:
        data = data != 0

    counters.transforms += 1
    counters.voxels += int(data.size)

    if voxel_graph is not None:
        counters.voxel_graph_calls += 1
        result = vg.edtsq_voxel_graph(data, voxel_graph, anisotropy,
                                      bool(black_border), arr_order, device)
    elif max(data.shape) > _device_max_axis(dev):
        counters.host_fallbacks += 1
        result = host_reference.edtsq_host(data, anisotropy, bool(black_border))
    else:
        labels = _as_device_labels(data)
        if not labels.flags.writeable:
            labels = labels.copy(order="K")
        cards = (_shard_devices(device) if labels.ndim == 3
                 and labels.size >= _shard_min_voxels() else None)
        if cards:
            from edt_tpu_torch.parallel import local

            counters.sharded_dispatches += 1
            result = local.edtsq_sharded_local(
                labels, anisotropy, bool(black_border), binary=take_binary,
                devices=cards)
        else:
            with profiling.span("edt_tpu_torch.api", dev, shape=labels.shape,
                                dtype=labels.dtype):
                with profiling.span("edt_tpu_torch.api.copy_in", dev,
                                    bytes=labels.nbytes):
                    x = torch.from_numpy(labels).to(dev)
                with profiling.span("edt_tpu_torch.api.transform", dev):
                    out = compose.edtsq(
                        x,
                        anisotropy,
                        bool(black_border),
                        binary=take_binary,
                        axis_order=_sorted_axis_order(anisotropy),
                    )
                with profiling.span("edt_tpu_torch.api.copy_out", dev,
                                    bytes=out.numel() * out.element_size()):
                    result = out.contiguous().cpu().numpy()

    if arr_order == "F":
        result = np.asfortranarray(result)
    return result


def edt(data, anisotropy=None, black_border=False, parallel=1,
        voxel_graph=None, order=None, *, device=None):
    """Anisotropic multi-label EDT."""
    dt = edtsq(data, anisotropy, black_border, parallel, voxel_graph,
               device=device)
    return np.sqrt(dt, dt)


def sdf(data, anisotropy=None, black_border=False, parallel=1,
        voxel_graph=None, order=None, *, device=None):
    """Signed distance field: edt(x) - edt(x == 0)."""
    def fn(labels):
        return edt(labels, anisotropy=anisotropy, black_border=black_border,
                   parallel=parallel, voxel_graph=voxel_graph, device=device)

    dt = fn(data)
    dt -= fn(np.asarray(data) == 0)
    return dt


def sdfsq(data, anisotropy=None, black_border=False, parallel=1,
          voxel_graph=None, order=None, *, device=None):
    """Squared signed distance field: edtsq(x) - edtsq(x == 0)."""
    def fn(labels):
        return edtsq(labels, anisotropy=anisotropy, black_border=black_border,
                     parallel=parallel, voxel_graph=voxel_graph,
                     device=device)

    return fn(data) - fn(np.asarray(data) == 0)


def binary_edtsq(data, anisotropy=None, black_border=False, parallel=1,
                 order=None, *, device=None):
    """Binary fast-path squared EDT: any nonzero voxel is foreground."""
    return edtsq(data, anisotropy, black_border, parallel, binary=True,
                 device=device)


def binary_edt(data, anisotropy=None, black_border=False, parallel=1,
               order=None, *, device=None):
    """Binary fast-path EDT."""
    dt = binary_edtsq(data, anisotropy, black_border, parallel, device=device)
    return np.sqrt(dt, dt)


# --- fixed-dimension conveniences ---

def edt1dsq(data, anisotropy=1.0, black_border=False, *, device=None):
    return edtsq(np.asarray(data), anisotropy, black_border, device=device)


def edt1d(data, anisotropy=1.0, black_border=False, *, device=None):
    result = edt1dsq(data, anisotropy, black_border, device=device)
    return np.sqrt(result, result)


def edt2dsq(data, anisotropy=(1.0, 1.0), black_border=False, parallel=1,
            voxel_graph=None, *, device=None):
    return edtsq(np.asarray(data), anisotropy, black_border, parallel,
                 voxel_graph, device=device)


def edt2d(data, anisotropy=(1.0, 1.0), black_border=False, parallel=1,
          voxel_graph=None, *, device=None):
    result = edt2dsq(data, anisotropy, black_border, parallel, voxel_graph,
                     device=device)
    return np.sqrt(result, result)


def edt3dsq(data, anisotropy=(1.0, 1.0, 1.0), black_border=False, parallel=1,
            voxel_graph=None, *, device=None):
    return edtsq(np.asarray(data), anisotropy, black_border, parallel,
                 voxel_graph, device=device)


def edt3d(data, anisotropy=(1.0, 1.0, 1.0), black_border=False, parallel=1,
          voxel_graph=None, *, device=None):
    result = edt3dsq(data, anisotropy, black_border, parallel, voxel_graph,
                     device=device)
    return np.sqrt(result, result)
