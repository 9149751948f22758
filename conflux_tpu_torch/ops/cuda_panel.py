"""K1 on Hopper: the rank-1 pivot-selection block, by hand in CUDA C++.

Counterpart of `conflux_tpu/ops/pallas_panel.py` (`rank1_block_pallas_t`,
kernel `_rank1_kernel`). The kernel is `csrc/rank1_panel.cu`, built by
`nvcc` for `sm_90a` at first use (ops/_build.py) and called through
ctypes on PyTorch's current stream. It has three routes, which the C
entry picks from (w, m) and the mode and reports back: forced blocks up
to w = 128 on the tile route (no exchange between CTAs), others on the
cluster route up to `cluster_max_m(w)` lanes (one thread-block cluster)
and on the grid route beyond (one persistent CTA per SM). The grid route
runs in clusters of 8 CTAs with a two-level exchange a column (each
cluster's candidates meet in its leader's shared memory, the leaders'
winners in tagged slots in the L2) wherever the card holds the clusters
at once and their slabs hold the block, and with one grid barrier a
column otherwise; `grid_cluster(w, m)` names the cluster size a block
gets, and the C entry reports the one it launched. The tags run on from
call to call, so the scratch they live in is zeroed once and kept per
device and stream. Its source note says what bounds it on the H100 and
what each route does about that.

Float64 blocks take K1 in double (`rank1_block_t_f64`,
`csrc/rank1_panel_f64.cu`): the same three routes in double, chosen in
its C entry from (w, m) and the mode (`route_f64`, `cluster_max_m_f64`),
each with its own launch counter.

Its plain PyTorch version is `ops/panel._rank1_block_t`, which serves both
dtypes; `ops/panel._rank1_dispatch` sends CPU tensors there and CUDA
tensors here.
"""

from __future__ import annotations

import ctypes

import torch

from conflux_tpu_torch.ops import _build

# widest block the kernel takes (the JAX kernel's VMEM bound, kept as the
# interface limit: wider blocks run from global memory through the L2)
MAX_M = 65536

# launches of the kernel in this process, in all and per route (the C
# entry picks the route from (w, m) and the mode and reports it);
# chip_smoke.py resets and reads them
LAUNCHES = 0
LAUNCHES_CLUSTER = 0    # one thread-block cluster, pushes between its CTAs
LAUNCHES_GRID = 0       # one persistent launch, one CTA per SM
# ... of which in clusters, with the two-level exchange a column (the
# others take one grid barrier a column)
LAUNCHES_GRID_CLUSTERED = 0
LAUNCHES_TILE = 0       # forced blocks: each CTA eliminates its lanes alone

# launches of the double kernel (rank1_panel_f64.cu), which float64
# blocks take, in all and per route; counted apart
LAUNCHES_F64 = 0
LAUNCHES_F64_CLUSTER = 0
LAUNCHES_F64_GRID = 0
LAUNCHES_F64_TILE = 0

# the routes' numbers in both sources (Route)
ROUTES = {1: "cluster", 2: "grid", 3: "tile"}

_lib = None
_lib_f64 = None
# the float32 kernel's scratch per (device, stream): zeroed once and kept,
# since the clustered grid route's tags run on from call to call
_scratch: dict = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rank1_panel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conflux_rank1_panel.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, p,
                                            ctypes.POINTER(i),
                                            ctypes.POINTER(i)]
        lib.conflux_rank1_panel.restype = i
        lib.conflux_rank1_panel_grid_cluster.argtypes = [i, i]
        lib.conflux_rank1_panel_grid_cluster.restype = i
        lib.conflux_rank1_panel_cluster_max_m.argtypes = [i]
        lib.conflux_rank1_panel_cluster_max_m.restype = i
        lib.conflux_rank1_panel_route.argtypes = [i, i, i]
        lib.conflux_rank1_panel_route.restype = i
        lib.conflux_rank1_panel_scratch_floats.argtypes = [i]
        lib.conflux_rank1_panel_scratch_floats.restype = i
        lib.conflux_cuda_error_string.argtypes = [i]
        lib.conflux_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_f64() -> ctypes.CDLL:
    global _lib_f64
    if _lib_f64 is None:
        lib = _build.load("rank1_panel_f64")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conflux_rank1_panel_f64.argtypes = [p, p, p, p, p, p, p,
                                                i, i, i, i, p,
                                                ctypes.POINTER(i)]
        lib.conflux_rank1_panel_f64.restype = i
        lib.conflux_rank1_panel_f64_scratch_doubles.argtypes = [i]
        lib.conflux_rank1_panel_f64_scratch_doubles.restype = i
        lib.conflux_rank1_panel_f64_cluster_max_m.argtypes = [i]
        lib.conflux_rank1_panel_f64_cluster_max_m.restype = i
        lib.conflux_rank1_panel_f64_route.argtypes = [i, i, i]
        lib.conflux_rank1_panel_f64_route.restype = i
        lib.conflux_rank1_panel_f64_error_string.argtypes = [i]
        lib.conflux_rank1_panel_f64_error_string.restype = ctypes.c_char_p
        _lib_f64 = lib
    return _lib_f64


def cluster_max_m(w: int) -> int:
    """The largest m whose unforced [w, m] block takes the cluster route on
    the current card; wider blocks take the grid route."""
    return _load().conflux_rank1_panel_cluster_max_m(w)


def route(w: int, m: int, forced: bool) -> str:
    """The route ('cluster', 'grid' or 'tile') a [w, m] block takes on the
    current card: forced blocks up to w = 128 take the tile route, others
    the cluster route up to cluster_max_m(w) lanes and the grid route
    beyond."""
    return ROUTES[_load().conflux_rank1_panel_route(w, m, int(forced))]


def grid_cluster(w: int, m: int) -> int:
    """The cluster size of the grid route's launch for a [w, m] block on
    the current card: 8 where it takes the two-level exchange, 0 where it
    keeps the flat one (a card that holds no such clusters, or a block
    whose slab the clustered CTAs cannot hold)."""
    return _load().conflux_rank1_panel_grid_cluster(w, m)


def _kept_scratch(lib, w: int, dev: torch.device, stream) -> torch.Tensor:
    """The zeroed scratch kept for (dev, stream), grown to width w."""
    need = lib.conflux_rank1_panel_scratch_floats(w)
    key = (dev.index, stream.cuda_stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.float32, device=dev)
        _scratch[key] = buf
    return buf


def cluster_max_m_f64(w: int) -> int:
    """cluster_max_m for K1 in double."""
    return _load_f64().conflux_rank1_panel_f64_cluster_max_m(w)


def route_f64(w: int, m: int, forced: bool) -> str:
    """route for K1 in double: forced blocks up to w = 128 take the tile
    route, others the cluster route up to cluster_max_m_f64(w) lanes and
    the grid route beyond."""
    return ROUTES[_load_f64().conflux_rank1_panel_f64_route(w, m,
                                                            int(forced))]


def _check_block(Mt, avail_f, forced: bool, j0: int, dtype):
    """Raise unless Mt [w, m] and avail_f [1, m] are contiguous CUDA
    tensors of `dtype` on one device, 1 <= m <= MAX_M, and forced pivots
    j0..j0+w-1 are lanes of the block."""
    if not Mt.is_cuda or avail_f.device != Mt.device:
        raise ValueError("rank1_block_t takes CUDA tensors on one device")
    if Mt.dtype != dtype or avail_f.dtype != dtype:
        raise TypeError(f"this K1 entry takes {dtype} tensors, not "
                        f"{Mt.dtype} and {avail_f.dtype}")
    if Mt.dim() != 2 or tuple(avail_f.shape) != (1, Mt.shape[1]):
        raise ValueError(f"shapes Mt {tuple(Mt.shape)} and avail "
                         f"{tuple(avail_f.shape)} are not [w, m] and [1, m]")
    if not (Mt.is_contiguous() and avail_f.is_contiguous()):
        raise ValueError("rank1_block_t takes contiguous tensors")
    w, m = Mt.shape
    if not (1 <= w and 1 <= m <= MAX_M):
        raise ValueError(f"block [{w}, {m}] outside 1 <= m <= {MAX_M}")
    if forced and not 0 <= j0 <= m - w:
        raise ValueError(f"forced pivots {j0}..{j0 + w - 1} outside the "
                         f"{m} lanes")


def rank1_block_t(Mt: torch.Tensor, avail_f: torch.Tensor,
                  forced: bool = False, j0: int = 0, finish: bool = False):
    """Fused masked-argmax rank-1 elimination of a TRANSPOSED block on the
    card. Mt [w, m] f32 (panel columns as rows); avail_f [1, m] f32
    (> 0 = selectable). Returns (Mt' [w, m], avail' [1, m], piv [w] i32,
    ok [w] i32), as `rank1_block_pallas_t` does.

    forced=True takes pivot j0 + jj for column jj instead of searching.
    `finish` is accepted for the caller's sake and changes nothing: the
    straight elimination leaves every pivot lane holding its merged-factor
    values in all modes (unforced callers never read them)."""
    global LAUNCHES, LAUNCHES_CLUSTER, LAUNCHES_GRID, \
        LAUNCHES_GRID_CLUSTERED, LAUNCHES_TILE
    del finish
    _check_block(Mt, avail_f, forced, j0, torch.float32)
    w, m = Mt.shape
    lib = _load()
    dev = Mt.device
    out = torch.empty_like(Mt)
    avail_o = torch.empty_like(avail_f)
    piv = torch.empty(w, dtype=torch.int32, device=dev)
    ok = torch.empty(w, dtype=torch.int32, device=dev)
    route_taken, cluster = ctypes.c_int(-1), ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        scratch = _kept_scratch(lib, w, dev, stream)
        err = lib.conflux_rank1_panel(
            Mt.data_ptr(), avail_f.data_ptr(), out.data_ptr(),
            avail_o.data_ptr(), piv.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), w, m, int(forced), j0, stream.cuda_stream,
            ctypes.byref(route_taken), ctypes.byref(cluster))
    if err != 0:
        raise RuntimeError("rank1_panel launch failed: "
                           + lib.conflux_cuda_error_string(err).decode())
    LAUNCHES += 1
    taken = ROUTES.get(route_taken.value)
    if taken == "cluster":
        LAUNCHES_CLUSTER += 1
    elif taken == "grid":
        LAUNCHES_GRID += 1
        LAUNCHES_GRID_CLUSTERED += int(cluster.value > 1)
    elif taken == "tile":
        LAUNCHES_TILE += 1
    return out, avail_o, piv, ok


def rank1_block_t_f64(Mt: torch.Tensor, avail_f: torch.Tensor,
                      forced: bool = False, j0: int = 0,
                      finish: bool = False):
    """K1 in double (csrc/rank1_panel_f64.cu): `rank1_block_t`'s contract
    for float64 Mt [w, m] and avail_f [1, m], on the route `route_f64`
    names. Raises on any launch error."""
    global LAUNCHES_F64, LAUNCHES_F64_CLUSTER, LAUNCHES_F64_GRID, \
        LAUNCHES_F64_TILE
    del finish
    _check_block(Mt, avail_f, forced, j0, torch.float64)
    w, m = Mt.shape
    lib = _load_f64()
    dev = Mt.device
    out = torch.empty_like(Mt)
    avail_o = torch.empty_like(avail_f)
    piv = torch.empty(w, dtype=torch.int32, device=dev)
    ok = torch.empty(w, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.conflux_rank1_panel_f64_scratch_doubles(w),
                          dtype=torch.float64, device=dev)
    route_taken = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conflux_rank1_panel_f64(
            Mt.data_ptr(), avail_f.data_ptr(), out.data_ptr(),
            avail_o.data_ptr(), piv.data_ptr(), ok.data_ptr(),
            scratch.data_ptr(), w, m, int(forced), j0, stream,
            ctypes.byref(route_taken))
    if err != 0:
        raise RuntimeError("rank1_panel_f64 launch failed: "
                           + lib.conflux_rank1_panel_f64_error_string(err)
                           .decode())
    LAUNCHES_F64 += 1
    taken = ROUTES.get(route_taken.value)
    if taken == "cluster":
        LAUNCHES_F64_CLUSTER += 1
    elif taken == "grid":
        LAUNCHES_F64_GRID += 1
    elif taken == "tile":
        LAUNCHES_F64_TILE += 1
    return out, avail_o, piv, ok
