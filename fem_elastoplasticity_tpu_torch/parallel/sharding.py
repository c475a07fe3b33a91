"""Multi-device runs over `torch.distributed`: ranks, their collectives, the
launcher and the element partition.

Port of `fem_elastoplasticity_tpu/parallel/sharding.py`.  The JAX package
shards with `shard_map` over a device mesh; here every rank is a process
that runs the same host loop (`solve.newton`) over its own shard, SPMD.
Nodal DOF vectors stay replicated, as in JAX, and every host decision (the
CG and Newton criteria, the plastic counts) is read from replicated values
or from a fold in rank order, so every rank takes the same schedule.

Two layouts, as in the JAX package:

* elements (`sharded_geometry`, the counterpart of `sharded_geometry` and
  `sharded_geometry_df`): each rank holds a contiguous run of elements
  and their points, with the plastic strain on them for the whole solve;
  the nodal partial sums (internal force, the tangent product, the
  preconditioner's diagonal blocks) are reduced by `ShardGroup.sum_ranks`;
* rows (`ops.spmv.shard_rows`, `solve.multigrid.shard_hierarchy_ell`):
  the assembled operators are cut into row slices, the rest is
  replicated, and a product is the local rows followed by
  `ShardGroup.gather` (a concatenation).

Only exact collectives are used: `gather` is an all-gather and a
concatenation, `sum_ranks` an all-gather and a sum in rank order, the same
on every rank (the counterpart of `psum` and of the JAX package's
compensated `df_allreduce`; the port's df32 state is f64, so the fold is
one f64 sum).  No `dist.all_reduce`: its order is the backend's.  Over
more than two ranks a small all-gather is a gather to rank 0 and a
broadcast (two hops, where gloo's all_gather walks a ring of N - 1): the
same bytes land in the same places.

`spawn(fn, n_devices, *args, device=None)` starts the ranks (the `spawn`
start method: CUDA cannot be forked) around a `file://` rendezvous in a
temporary directory, runs `fn(group, *args)` in each and returns rank 0's
result on the host.  On the card (device=None) rank r holds its tensors on
`cuda:(r % device_count)`: NCCL where every rank has a card of its own,
gloo where ranks share one (NCCL refuses two ranks on one device; gloo
stages a card's tensors through the host).  device="cpu" runs gloo on the
CPU.  Rank functions live in this package, so a rank imports only torch
and the port.
"""
from __future__ import annotations

import collections
import pickle
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import assembly as asm
from ..ops.elements import ReferenceElement

# per process: all-gathers and the elements they moved ("gathers",
# "gathered_elements"); `measured` reports them
COLLECTIVES: collections.Counter = collections.Counter()
# gloo all-gathers of at most this many elements in all, over more than
# two ranks, go to rank 0 and back (`ShardGroup._all_gather`): gloo's ring
# takes N - 1 hops, each a scheduling round of the N processes (952 f32
# values a rank on one NVIDIA H100 80GB HBM3, 700.00 W, `tools/gather_bench.py`:
# 8 ranks 19.2 ms around the ring against 5.6 ms to rank 0 and back, 4
# ranks 4.0 against 1.4; at 456,224 a rank the ring is the faster)
SMALL_GATHER = 1 << 16


class ShardGroup(NamedTuple):
    """One rank's view of the group: its rank, the group size, the device
    its tensors live on and the backend, with the exact collectives over
    the default process group."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def _all_gather(self, x: torch.Tensor) -> list:
        """Every rank's x, in rank order (an all-gather; `SMALL_GATHER`)."""
        x = x.contiguous()
        COLLECTIVES.update(gathers=1, gathered_elements=x.numel() * self.size)
        if self.backend == "gloo" and self.size > 2 and x.numel() * self.size <= SMALL_GATHER:
            flat = x.new_empty((self.size,) + tuple(x.shape))
            dist.gather(x, list(flat.unbind(0)) if self.rank == 0 else None, dst=0)
            dist.broadcast(flat, src=0)
            return list(flat.unbind(0))
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        return out

    def gather(self, x: torch.Tensor, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's x concatenated along dim 0 in rank order (exact).
        `counts`: the ranks' lengths along dim 0 where they differ; each
        part is padded with zeros to the longest for the transport and cut
        back after it."""
        if counts is None:
            return torch.cat(self._all_gather(x))
        longest = max(counts)
        if x.shape[0] != counts[self.rank]:
            raise ValueError(f"rank {self.rank}: {x.shape[0]} rows, counts say "
                             f"{counts[self.rank]}")
        if x.shape[0] < longest:
            x = torch.cat([x, x.new_zeros((longest - x.shape[0],) + tuple(x.shape[1:]))])
        return torch.cat([p[:c] for p, c in zip(self._all_gather(x), counts)])

    def sum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """sum over ranks of x, folded in rank order from rank 0's part:
        the same bits on every rank."""
        parts = self._all_gather(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def objects(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def same(self, what: str, obj) -> None:
        """Raise unless every rank holds an equal `obj` (the schedule each
        rank took: a mismatch means the ranks decided differently)."""
        got = self.objects(obj)
        if any(o != got[0] for o in got[1:]):
            raise RuntimeError(f"the ranks disagree on {what}: {got}")


def placement(n_devices: int, device=None) -> tuple:
    """(devices of ranks 0..n-1, backend) for `spawn`: on the card (device
    None or "cuda") rank r on cuda:(r % device_count), NCCL if every rank
    has a card of its own, else gloo; raises without a card.  "cpu": gloo
    on the CPU.  Nothing falls back silently."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1; got {n_devices}")
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible: the port runs on the card; pass "
                               "device='cpu' to run the ranks on the host")
        count = torch.cuda.device_count()
        return ([torch.device("cuda", r % count) for r in range(n_devices)],
                "nccl" if count >= n_devices else "gloo")
    if str(device) != "cpu":
        raise ValueError(f"spawn: device must be None, 'cuda' or 'cpu'; got {device!r}")
    return [torch.device("cpu")] * n_devices, "gloo"


def current_group(n_devices: Optional[int] = None, device=None) -> ShardGroup:
    """The ShardGroup of this process in an initialised default process
    group (inside `spawn`, or under torchrun); raises unless its size is
    n_devices (when given)."""
    from ..utils.precision import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: run inside sharding.spawn (or torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and size != int(n_devices):
        raise ValueError(f"shard_devices={n_devices} in a process group of {size} ranks")
    return ShardGroup(dist.get_rank(), size, resolve_device(device), dist.get_backend())


def _to_host(obj):
    """obj with every tensor moved to the CPU (NamedTuples, dicts, lists
    and tuples walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, n: int, tmp: str, devices: list, backend: str, fn: Callable,
               args: tuple) -> None:
    device = devices[rank]
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=n,
                            rank=rank)
    try:
        out = fn(ShardGroup(rank, n, device, backend), *args)
        if rank == 0:
            with open(f"{tmp}/result.pkl", "wb") as fh:
                pickle.dump(_to_host(out), fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _load_kernels() -> None:
    """Build every kernel once, in the launching process, so that the ranks
    only load the libraries (no two ranks run nvcc on one source)."""
    from ..ops import return_map, spmv

    for load in (spmv.load_kernel, spmv.load_sweep_kernel, spmv.load_transfer_kernel,
                 spmv.load_ell_kernel, return_map.load_kernel):
        load()


def spawn(fn: Callable, n_devices: int, *args, device=None):
    """Run fn(group, *args) in `n_devices` ranks and return rank 0's result
    with its tensors on the CPU.  `fn` must be a module-level function of
    this package (a rank imports it by name).  Where a default process
    group of `n_devices` ranks is already up (torchrun), fn runs in place
    in this process.  device: `placement`."""
    if dist.is_available() and dist.is_initialized():
        return fn(current_group(n_devices, device), *args)
    import torch.multiprocessing as mp

    devices, backend = placement(n_devices, device)
    if devices[0].type == "cuda":
        _load_kernels()
    with tempfile.TemporaryDirectory(prefix="fem_shard_") as tmp:
        mp.start_processes(_rank_main, args=(n_devices, tmp, devices, backend, fn, args),
                           nprocs=n_devices, join=True, start_method="spawn")
        with open(f"{tmp}/result.pkl", "rb") as fh:
            return pickle.load(fh)


def run_jobs(group: ShardGroup, jobs: Sequence[tuple]) -> list:
    """Rank function of several runs in one spawn: jobs are (fn, args)
    pairs of rank functions, run in order; returns their results."""
    return [fn(group, *args) for fn, args in jobs]


def describe(group: ShardGroup) -> list:
    """Rank function: (rank, backend, device, card name, whether JAX is
    loaded) of every rank; a rank imports torch and the port only."""
    name = torch.cuda.get_device_name(group.device) if group.device.type == "cuda" else "cpu"
    return group.objects((group.rank, group.backend, str(group.device), name,
                          "jax" in sys.modules))


def measured(group: ShardGroup, fn: Callable, args: tuple = (), profile: bool = False) -> dict:
    """Rank function: fn(group, *args) between barriers, with its wall on
    rank 0, the kernel launches and collectives of all ranks summed, and
    with `profile` rank 0's device busy time under torch.profiler (the
    card's activity only; None where the profile recorded no kernel).
    Returns dict(result, wall_s, launches, collectives, busy_s)."""
    from ..ops import return_map, spmv

    for counter in (spmv.LAUNCHES, return_map.LAUNCHES, COLLECTIVES):
        counter.clear()
    cuda = group.device.type == "cuda"
    prof = None
    if profile and group.rank == 0 and cuda:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CUDA])
    dist.barrier()
    if cuda:
        torch.cuda.synchronize(group.device)
    t0 = time.perf_counter()
    if prof is not None:
        with prof:
            out = fn(group, *args)
            torch.cuda.synchronize(group.device)
    else:
        out = fn(group, *args)
        if cuda:
            torch.cuda.synchronize(group.device)
    wall = time.perf_counter() - t0
    busy = None
    if prof is not None:
        # the kernels' device time; None where the profile lost the card's
        # activity (no kernel event recorded)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = 1e-6 * sum(e.device_time_total for e in kernels) if kernels else None
    launches = collections.Counter()
    for c in group.objects(dict(spmv.LAUNCHES) | dict(return_map.LAUNCHES)):
        launches.update(c)
    collectives = collections.Counter()
    for c in group.objects(dict(COLLECTIVES)):
        collectives.update(c)
    return dict(result=out, wall_s=wall, launches=dict(launches),
                collectives=dict(collectives), busy_s=busy)


# ---------------------------------------------------------------------------
# the element partition
# ---------------------------------------------------------------------------
def element_range(n_elems: int, group: ShardGroup) -> tuple:
    """(first, end, per) of this rank's elements: `per` each, the element
    count padded to a multiple of the group size with inert elements (zero
    B and weight) at the end."""
    per = -(-n_elems // group.size)
    return group.rank * per, (group.rank + 1) * per, per


def sharded_geometry(coords: torch.Tensor, elems: np.ndarray, ref: ReferenceElement,
                     group: ShardGroup) -> asm.Geometry:
    """This rank's element shard of the geometry, on coords' device and in
    its dtype: the elements [first, end) of `element_range` with their
    points (element-major, quadrature-minor), their DOF gather map built
    for the shard.  The JAX package's `sharded_geometry` and
    `sharded_geometry_df` in one: the port's df32 geometry is the f64 one
    (its f32 heads are `Geometry.to`)."""
    n_e = np.asarray(elems).shape[0]
    first, end, per = element_range(n_e, group)
    full = asm.compute_geometry(coords, elems, ref, pad_to=ref.n_q * group.size)
    if full.n_elems != per * group.size:
        raise AssertionError(f"{full.n_elems} padded elements for {group.size} ranks of {per}")
    q0, q1 = first * ref.n_q, end * ref.n_q
    return asm.make_geometry(
        full.B[:, :, q0:q1].contiguous(), full.weight[q0:q1].contiguous(),
        full.edofs[first:end], full.n_nodes, full.n_q, max(0, min(n_e, end) - first))


def gather_points(x: torch.Tensor, n_real_points: int, n_int: int,
                  group: ShardGroup) -> torch.Tensor:
    """A point field (..., n_local) of the element shards -> the whole
    mesh's (..., n_int): the shards concatenated in rank order, the padding
    points cut and the single-device layout's lane padding (n_int points)
    restored with zeros."""
    full = group.gather(x.movedim(-1, 0)).movedim(0, -1)[..., :n_real_points]
    pad = n_int - n_real_points
    return torch.nn.functional.pad(full, (0, pad)) if pad else full


# ---------------------------------------------------------------------------
# the multi-device dry run
# ---------------------------------------------------------------------------
# its parts, in the order of the JAX package's `__graft_entry__.py:116-170`
DRYRUN_PARTS = ("f64", "df32", "scale", "footing")
# the fewest accepted steps each part must reach
DRYRUN_MIN_STEPS = {"f64": 2, "df32": 2, "scale": 3, "footing": 2}


def dryrun_configs() -> dict:
    """{part: (rank function, configuration)} of the dry run: two load steps
    of the element-sharded f64 and df32 solves; three of the row-sharded
    scale preset at refine level 1 with a deflation basis of 4; the
    footing's level-3 tangent multigrid, row-sharded, with a deflation
    basis of 8, to zeta 0.002."""
    from ..models import footing
    from ..models import tsx_tunnel as tsx
    from ..models.config import FootingConfig, TsxTunnelConfig

    zeta_max = 2.0 / 17.0  # two load steps: tiny
    return {
        "f64": (tsx.solve_sharded_rank, TsxTunnelConfig(zeta_max=zeta_max)),
        "df32": (tsx.solve_sharded_df32_rank,
                 TsxTunnelConfig.fast(solver="cg", zeta_max=zeta_max)),
        "scale": (tsx.solve_sharded_scale_rank,
                  TsxTunnelConfig.fast_scale(1, zeta_max=3.0 / 17.0, cg_deflate=4)),
        "footing": (footing.solve_sharded_rank,
                    FootingConfig.fast(solver="cg", level=3, tangent_mg=True, zeta_max=0.002,
                                       cg_deflate=8)),
    }


def dryrun_rank(group: ShardGroup, parts: Sequence[str] = DRYRUN_PARTS) -> dict:
    """Rank function of `dryrun_multichip`: {part: result} of `parts`."""
    configs = dryrun_configs()
    out = {}
    for part in parts:
        fn, cfg = configs[part]
        out[part] = fn(group, cfg)
    return out


def dryrun_multichip(n_devices: int, device=None, parts: Sequence[str] = DRYRUN_PARTS) -> dict:
    """The JAX package's `__graft_entry__.dryrun_multichip` on `n_devices`
    ranks, its four parts (`dryrun_configs`): `solve_sharded` (f64) and
    `solve_sharded_df32` at zeta_max = 2/17, `solve_sharded_scale` of
    `fast_scale(1, zeta_max=3/17, cg_deflate=4)` and the footing's
    `solve_sharded` of its level-3 tangent multigrid with cg_deflate=8 to
    zeta 0.002; `parts` picks some of them.  Each is held to
    `check_dryrun`'s gates.  Returns {part: result}."""
    out = spawn(dryrun_rank, n_devices, tuple(parts), device=device)
    check_dryrun(out)
    return out


def check_dryrun(results: dict) -> None:
    """`dryrun_multichip`'s gates on {part: result}: each part finite with
    at least `DRYRUN_MIN_STEPS` accepted steps, and the df32 field within
    1e-9 of max |u| of the f64 one where both ran; raises AssertionError."""
    for part, res in results.items():
        finite = bool(np.isfinite(res.u).all())
        if res.n_steps < DRYRUN_MIN_STEPS[part] or not finite:
            raise AssertionError(f"dryrun {part}: {res.n_steps} steps, finite {finite}")
    if "f64" in results and "df32" in results:
        r, r_df = results["f64"], results["df32"]
        d = float(np.abs(r_df.u - r.u).max())
        if not d < 1e-9 * max(float(np.abs(r.u).max()), 1e-30):
            raise AssertionError(f"dryrun: df32 field {d:.3e} from the f64 one")
