"""The yardstick of the kernels: the published peaks of one NVIDIA H100, the
bytes and f32 operations each kernel's pass needs, and the names by which
the device trace knows each kernel.

A pass's count comes from its shape alone: every logical input read once,
every output written once, and the arithmetic its result needs, whatever
implements it. So a later kernel cannot make the count stale, and a share
above 100 % means the count or the time is wrong, never a fast kernel.

- K1, ``minplus_walls`` (the forward's parabolic pass over (R, n) rows):
  masked (multi-label) rows read f (f32) and the labels (the volume's own
  dtype, which fixes the runs and so the walls) and write d (f32): 8 B +
  the label width a voxel. Binary rows read f and write d: 8 B. Each
  voxel's result needs its winner's cost (k * k, * w2, + f) and its two
  walls (square, scale, each) and two mins: 9 operations.
- K2, ``minplus_argmin`` (a loss pass over (R, n) rows, walls from counts):
  reads f (f32) and the wall counts, writes d (f32) and each voxel's link
  to its winner, the residual the backward needs. A count or a link of a
  row of n voxels lies in (-n - 2, n + 2): ``index_bytes(n)`` (2 B up to
  32765) each. 12 B a voxel at n = 512. The winner's cost, the wall
  ((c * w2) * c) and the clamp: 6 operations.
- K3, ``minplus_grad`` and K4, ``binary_grad_scan`` (the loss passes'
  backward): read the cotangent g (f32) and the links, write df (f32):
  10 B a voxel at n = 512; one add a voxel.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel -> (the program's custom op that launches it, its CUDA kernels'
# function names as the device trace shows them)
KERNELS = {
    "K1": ("edt_tpu_torch::minplus_walls", ("minplus_walls_kernel",)),
    "K2": ("edt_tpu_torch::minplus_argmin", ("minplus_argmin_kernel",)),
    "K3": ("edt_tpu_torch::minplus_grad",
           ("minplus_grad_kernel", "minplus_grad_split_kernel")),
    "K4": ("edt_tpu_torch::binary_grad_scan",
           ("binary_grad_scan_kernel", "binary_grad_scan_reg_kernel")),
    "K5": ("edt_tpu_torch::softmin",
           ("softmin_warp_kernel", "softmin_block_kernel")),
    "K6": ("edt_tpu_torch::softmin_grad",
           ("softmin_grad_kernel", "row_min_kernel",
            "softmin_grad_split_kernel", "softmin_grad_combine_kernel")),
}
FAMILY = {fn: k for k, (_, fns) in KERNELS.items() for fn in fns}


def function_name(kernel: str) -> str:
    """``void (anonymous namespace)::minplus_walls_kernel<true, false,
    false>(float const*, ...)`` -> ``minplus_walls_kernel``."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].split("<", 1)[0].strip()
    return name.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def kernel_family(kernel: str) -> str | None:
    """"K1" .. "K6" for a device event of the program's kernels, "NCCL"
    for a collective's, else None (the glue: torch's own kernels, copies
    and fills)."""
    fn = function_name(kernel)
    if fn in FAMILY:
        return FAMILY[fn]
    return "NCCL" if "nccl" in kernel.lower() else None


def index_bytes(n: int) -> int:
    """Bytes of a signed offset or count in (-n - 2, n + 2)."""
    return 2 if n + 2 < 2 ** 15 else 4


def pass_count(kernel: str, shapes, label_bytes: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one pass of ``kernel`` from its custom
    op's input shapes, as the trace records them."""
    R, n = shapes[0]
    vox = R * n
    if kernel == "K1":
        masked = bool(shapes[1])
        return vox * (8 + (label_bytes if masked else 0)), 9 * vox
    if kernel == "K2":
        return vox * (8 + 2 * index_bytes(n)), 6 * vox
    if kernel in ("K3", "K4"):
        return vox * (8 + index_bytes(n)), vox
    raise ValueError(f"no count for {kernel}")


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time on the card: HBM bytes or f32 operations, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def share(trace, kernel: str) -> float | None:
    """``kernel``'s least time over its device time in the traced window,
    in %: None where the window ran no such pass, or where the trace holds
    fewer of its kernels than passes (the profiler dropped events)."""
    op, _ = KERNELS[kernel]
    calls = [s for name, s in trace.host_ops if name == op]
    events = [(s, e) for name, s, e in trace.device_events
              if kernel_family(name) == kernel]
    if not calls or len(events) < len(calls):
        return None
    least = sum(least_seconds(*pass_count(kernel, s, trace.label_bytes))
                for s in calls)
    device = sum(e - s for s, e in events) * 1e-6
    return 100.0 * least / device if device > 0 else None
