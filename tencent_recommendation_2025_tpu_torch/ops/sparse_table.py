"""Sparse embedding-table training: host-planned lookups, the dedup'd row
gather, row-sparse optimizers and whole-group write-back.

Counterpart of ``tencent_recommendation_2025_tpu/ops/sparse_table.py`` for
one device. A table listed in ``train.sparse_tables`` trains by the
gather-train pattern:

1. the host collects every id the step touches and dedups it into sorted
   ``uids`` [K], padded with the sentinel = the table's row count
   (:func:`host_unique_touched`, in the input pipeline);
2. the step gathers those K rows once; the loss is differentiated with
   respect to the gathered rows [K, D], never the [V, D] table;
3. lookups inside the model resolve ids against the gathered rows
   (:class:`GatheredRows`, through ``embedding.masked_take``), by a host
   plan per call site (:func:`planned_lookup`, a scatter-free backward) or
   by ``searchsorted``;
4. the optimizer updates only the K touched rows (:func:`compute_row_update`:
   ``lazy_adam`` with SparseAdam's global step, or ``rowwise_adagrad`` with
   one f32 accumulator a row), written back in place.

Tables of ``TABLE_PACK_MIN_ROWS`` (30M) rows and more pad to ``Vp =
padded_table_rows(rows)`` rows and write back whole groups of R = 1024 / D
rows (:func:`host_group_plan`, :func:`group_scatter_apply`): the JAX
package stores them packed [Vp / R, 8, 128] for the TPU's layout. The port
keeps the table [Vp, D], which is that packed array's bytes, row-major, and
takes the write groups as the view ``table.view(Vp // R, R * D)``. On a
CUDA tensor the group write is the hand-written kernel
``csrc/sparse_table.cu::group_scatter_kernel`` (:func:`group_scatter`,
replacing ``pallas_group_scatter``, l.391-476); its gather twin
``group_gather_kernel`` (:func:`group_gather`, replacing
``pallas_group_gather``, l.479-544) is on no product path, as in the JAX
package: :func:`gather_rows_grouped` takes the plain dim-0 gather. Each
wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor (counted in ``group_scatter.launches`` and
``group_gather.launches``); it never falls back. The gathers of a step's
rows open span ``table.gather``, the row updates ``table.update``
(``utils/tracing``). 1-D state (the rowwise
accumulator) and tables below packed scale take a plain row write
(``index_copy_``), as they take XLA's scatter in the JAX package; a table
at packed scale never does (the trainer refuses a batch without its group
plan).

On a data (x model) mesh a sparse table row-shards like every learned
table over S = data x model shards (``parallel/sharded_embedding.py``; a
process holds shard ``data_index * model + model_index``): shard s holds
the contiguous row block
``[s * V / S, (s + 1) * V / S)``, at packed scale of the [Vp, D] table itself
(Vp is a multiple of 256, so a block is whole groups for S <= 16), below it
of the table padded to a multiple of S. The host plans each shard's share of
the step's touched rows (:func:`host_shard_plan`, with :func:`shard_capacity`
rows a shard); each shard takes its rows and an all-gather of the [Kp, D]
row blocks rebuilds the step's rows (:func:`sharded_gather_rows`); each
shard updates its own rows from the global gradient and writes them into its
block (:func:`sharded_apply_row_update`): at packed scale through the group
scatter on the block's groups, one launch per chunk and shard, below it by a
row write.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing as TRC
from . import kernels

# ---------------------------------------------------------------------------
# host-planned lookups
# ---------------------------------------------------------------------------


class PlannedLookup(torch.autograd.Function):
    """``rows[idx]`` whose backward is the host-scheduled segment sum:

        x = cot[perm];  c = [0; cumsum(x)];  drows[k] = c[ends[k]] - c[starts[k]]

    ``perm`` is the stable argsort of the flattened idx and ``starts`` /
    ``ends`` bound each row's segment (:func:`build_lookup_plan`). The sum
    runs in f32 and the gradient returns in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, rows, idx, perm, starts, ends):
        ctx.save_for_backward(perm, starts, ends)
        return rows[idx.long().clamp(0, rows.shape[0] - 1)]

    @staticmethod
    def backward(ctx, cot):
        perm, starts, ends = ctx.saved_tensors
        D = cot.shape[-1]
        # scanned as [D, N] rows: a scan along the inner axis runs in
        # parallel over D rows of N, where one along the outer axis of
        # [N, D] has only D lanes of parallel work
        xt = cot.reshape(-1, D).float()[perm.long()].t().contiguous()
        c = torch.cat([xt.new_zeros((D, 1)), torch.cumsum(xt, 1)], 1)
        drows = (c[:, ends.long()] - c[:, starts.long()]).t()
        return drows.to(cot.dtype), None, None, None, None


def planned_lookup(rows: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                   starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    return PlannedLookup.apply(rows, idx, perm, starts, ends)


def build_lookup_plan(uids_np, ids_np):
    """HOST-side plan for one lookup site: positions of ``ids`` in the
    sorted ``uids`` plus the segment-sum schedule for the backward."""
    uids_np = np.asarray(uids_np)
    ids_np = np.asarray(ids_np)
    idx = np.searchsorted(uids_np, ids_np).astype(np.int32)
    idx = np.minimum(idx, len(uids_np) - 1)
    flat = idx.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=len(uids_np)).astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    return {"idx": idx, "perm": perm, "starts": starts, "ends": ends}


@dataclasses.dataclass
class GatheredRows:
    """A table stand-in holding only the step's touched rows: ``uids`` [K]
    sorted unique ids (sentinel-padded with the row count) and ``rows``
    [K, D]. ``embedding.masked_take`` resolves ids against it, so every
    call site works unchanged and the gradient lands on the [K, D] rows.

    ``plans`` maps a lookup-site name ("seq", "posneg", "pos_last", "negs",
    "dedup", "user") to a host plan (:func:`build_lookup_plan`); a site
    without one resolves by ``searchsorted``."""

    uids: torch.Tensor
    rows: torch.Tensor
    plans: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        return self.rows.shape

    def lookup(self, ids: torch.Tensor, site: Optional[str] = None
               ) -> torch.Tensor:
        """Rows for ``ids`` [...] -> [..., D]; the caller applies the
        padding mask."""
        plan = self.plans.get(site) if site is not None else None
        if plan is not None and tuple(plan["idx"].shape) == tuple(ids.shape):
            return planned_lookup(self.rows, plan["idx"], plan["perm"],
                                  plan["starts"], plan["ends"])
        idx = torch.searchsorted(self.uids, ids.to(self.uids.dtype)
                                 .contiguous())
        return self.rows[idx.clamp(0, self.rows.shape[0] - 1)]


def unique_touched(ids: torch.Tensor, capacity: int, vocab_rows: int
                   ) -> torch.Tensor:
    """Sorted unique ids padded to ``capacity`` with the sentinel
    ``vocab_rows``, on the device: the step's fallback when the batch ships
    no ``touched_uids`` (the host prep, :func:`host_unique_touched`, is the
    product path)."""
    u = torch.unique(ids.reshape(-1))[:capacity]
    out = torch.full((capacity,), vocab_rows, dtype=ids.dtype,
                     device=ids.device)
    out[:len(u)] = u
    return out


def host_unique_touched(ids_np, capacity: int, vocab_rows: int):
    """Host (numpy) twin of :func:`unique_touched`: run it in the data
    pipeline and ship ``touched_uids`` with the batch."""
    u = np.unique(np.asarray(ids_np).reshape(-1))
    out = np.full((capacity,), vocab_rows, dtype=np.int32)
    out[: min(len(u), capacity)] = u[:capacity]
    return out


def row_take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for 1-D state or [V, D] tables, ids clamped to the
    rows (the JAX gather's mode='clip')."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, uids: torch.Tensor) -> GatheredRows:
    with TRC.span("table.gather"):
        rows = row_take(table, uids)
        # sentinel lanes read a clamped row; zero them so they contribute
        # nothing
        return GatheredRows(uids, rows * (uids < table.shape[0])[:, None]
                            .to(rows.dtype))


# ---------------------------------------------------------------------------
# row-sparse optimizer states and updates
# ---------------------------------------------------------------------------

def init_table_opt(table: torch.Tensor, kind: str,
                   moments_dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """``lazy_adam``: moments shaped as the table in ``moments_dtype``;
    ``rowwise_adagrad``: one f32 accumulator a row."""
    if kind == "lazy_adam":
        dt = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[moments_dtype]
        return {"mu": torch.zeros_like(table, dtype=dt),
                "nu": torch.zeros_like(table, dtype=dt)}
    if kind == "rowwise_adagrad":
        return {"acc": torch.zeros(table.shape[0], dtype=torch.float32,
                                   device=table.device)}
    raise ValueError(f"unknown table optimizer {kind!r}")


def compute_row_update(table: torch.Tensor, opt: Dict, uids: torch.Tensor,
                       drows: torch.Tensor, *, kind: str, lr: float,
                       step: int, b1: float = 0.9, b2: float = 0.98,
                       eps: float = 1e-8, weight_decay: float = 0.0,
                       rows0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Row math only (gathers, no writes): new values for the rows in
    ``uids`` from their gradient ``drows`` [K, D]. Returns (new_rows [K, D]
    in the table's dtype, new optimizer-state rows). ``step`` is the
    1-based global step of Adam's bias correction (SparseAdam: touched rows
    correct with the global t); ``rows0``, the forward's gathered rows,
    saves a second table gather. The math runs in f32; sentinel rows get a
    zero gradient and keep their value."""
    f32 = torch.float32
    g = drows.to(f32)
    rows = (rows0 if rows0 is not None else row_take(table, uids)).to(f32)
    ok = (uids < table.shape[0])[:, None].to(f32)
    g = g * ok
    if kind == "lazy_adam":
        mu_r = row_take(opt["mu"], uids).to(f32)
        nu_r = row_take(opt["nu"], uids).to(f32)
        mu_r = b1 * mu_r + (1 - b1) * g
        nu_r = b2 * nu_r + (1 - b2) * g * g
        # the bias corrections in f32, as the JAX package computes them
        t = np.float32(step)
        mu_hat = mu_r / float(np.float32(1) - np.float32(b1) ** t)
        nu_hat = nu_r / float(np.float32(1) - np.float32(b2) ** t)
        upd = mu_hat / (torch.sqrt(nu_hat) + eps)
        if weight_decay:
            upd = upd + weight_decay * rows
        new_rows = rows - lr * upd * ok
        opt_rows = {"mu": mu_r.to(opt["mu"].dtype),
                    "nu": nu_r.to(opt["nu"].dtype)}
    elif kind == "rowwise_adagrad":
        acc_r = row_take(opt["acc"], uids) + (g * g).mean(-1)
        upd = g * torch.rsqrt(acc_r + eps)[:, None]
        if weight_decay:
            upd = upd + weight_decay * rows
        new_rows = rows - lr * upd * ok
        opt_rows = {"acc": acc_r}
    else:
        raise ValueError(f"unknown table optimizer {kind!r}")
    return new_rows.to(table.dtype), opt_rows


# ---------------------------------------------------------------------------
# tables at packed scale: padding and whole-group writes
# ---------------------------------------------------------------------------

#: tables of this many rows and more train in whole write groups (the JAX
#: package's threshold: where its TPU layout stops fitting one chip)
TABLE_PACK_MIN_ROWS = 30_000_000
#: pad unit of such a table: the lcm of the group sizes at D | 128 (R <= 16)
#: times the JAX package's largest table-shard count
_PAD_ROWS = 256
#: K, the group plan's length, is a multiple of this (the JAX kernel's id
#: chunk)
_SCATTER_CSC = 1024
#: groups per merge-and-write chunk of :func:`group_scatter_apply`: bounds
#: its temporaries where the table fills most of the card (100M rows)
_SCATTER_CHUNK_GROUPS = 65536


def padded_table_rows(rows: int) -> int:
    """Physical rows of a learned table of ``rows`` logical rows: tables at
    packed scale pad to a multiple of 256, so they split into whole groups
    for any supported D. The pad rows are zero and never read."""
    if rows >= TABLE_PACK_MIN_ROWS:
        return -(-rows // _PAD_ROWS) * _PAD_ROWS
    return rows


def scatter_group_rows(dim: int) -> Optional[int]:
    """Rows per write group: 1024 elements of ``dim``-wide rows, whatever
    the dtype (the JAX package's [8, 128] tile). None when ``dim`` does not
    divide 128."""
    if dim > 128 or 128 % dim:
        return None
    return 8 * (128 // dim)


def is_packed_scale(rows: int, dim: int) -> bool:
    """Whether a learned table of ``rows`` logical rows of ``dim`` trains at
    packed scale: padded to :func:`padded_table_rows` and written back in
    whole groups (the JAX package stores it packed [Vp / R, 8, 128] there).
    The caller also checks ``model.pack_big_tables``."""
    return scatter_group_rows(dim) is not None and rows >= TABLE_PACK_MIN_ROWS


def host_group_plan(uids_np, vocab_rows: int, group_rows: int) -> Dict:
    """HOST-side write plan for the group scatter. ``uids_np`` is the
    sorted unique id list with the sentinel ``vocab_rows`` tail
    (:func:`host_unique_touched`). With R = ``group_rows`` and K =
    len(uids) rounded up to a multiple of 1024:

    - ``groups`` [K] int32: unique touched groups, sentinel
      ``vocab_rows // R`` (skipped by the scatter);
    - ``slot_src`` [K, R] int32: for each group slot, the row of the step's
      new-row tensor that goes there, or K to keep the old value;
    - ``uid_pos`` [len(uids)] int32: each uid's row in the gathered group
      buffer viewed [K * R, D] (sentinels point at row 0; callers mask)."""
    uids = np.asarray(uids_np)
    K = -(-len(uids) // _SCATTER_CSC) * _SCATTER_CSC
    R = group_rows
    nG = vocab_rows // R
    real = uids < vocab_rows           # sentinels sort last -> real prefix
    gr = uids[real] // R
    first = np.ones(len(gr), bool)
    first[1:] = gr[1:] != gr[:-1]
    groups_u = gr[first]
    groups = np.full((K,), nG, np.int32)
    groups[: len(groups_u)] = groups_u
    slot_src = np.full((K, R), K, np.int32)
    gidx = np.cumsum(first) - 1        # group index of each real uid
    slot = uids[real] % R
    slot_src[gidx, slot] = np.arange(len(gr), dtype=np.int32)
    uid_pos = np.zeros((len(uids),), np.int32)
    uid_pos[: len(gr)] = gidx.astype(np.int32) * R + slot.astype(np.int32)
    return {"groups": groups, "slot_src": slot_src, "uid_pos": uid_pos}


def group_view(table: torch.Tensor, group_rows: int) -> torch.Tensor:
    """The [Vp, D] table as its write groups [Vp / R, R * D] (a view)."""
    V, D = table.shape
    if V % group_rows:
        raise ValueError(f"{V} table rows do not split into groups of "
                         f"{group_rows}: pad them (padded_table_rows)")
    return table.view(V // group_rows, group_rows * D)


# ---------------------------------------------------------------------------
# the group kernels: wrappers and plain versions
# ---------------------------------------------------------------------------

def group_scatter_plain(table_groups: torch.Tensor, groups: torch.Tensor,
                        arranged: torch.Tensor) -> torch.Tensor:
    """Plain version of the scatter kernel: ``table_groups[groups[j]] =
    arranged[j]`` for the real groups, in place."""
    real = (groups >= 0) & (groups < table_groups.shape[0])
    table_groups[groups[real].long()] = arranged[real].to(table_groups.dtype)
    return table_groups


def group_gather_plain(table_groups: torch.Tensor, groups: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of the gather kernel: ``out[j] = table_groups[
    groups[j]]`` for the real groups; the rows of sentinel groups are
    zero here (the kernel leaves them unwritten)."""
    real = (groups >= 0) & (groups < table_groups.shape[0])
    out = table_groups.new_zeros((groups.shape[0], table_groups.shape[1]))
    out[real] = table_groups[groups[real].long()]
    return out


def _check_groups(name: str, table_groups, groups, rows=None) -> int:
    """Raise on operands the kernel does not take; returns the row bytes."""
    if table_groups.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes an f32 or bf16 table, not "
                         f"{table_groups.dtype}")
    if table_groups.dim() != 2 or not table_groups.is_contiguous():
        raise ValueError(f"{name}: the table must be a contiguous [groups, "
                         f"width] view, not {tuple(table_groups.shape)}")
    if groups.dtype != torch.int32 or groups.dim() != 1 \
            or not groups.is_contiguous():
        raise ValueError(f"{name}: groups must be a contiguous [K] int32")
    row_bytes = table_groups.shape[1] * table_groups.element_size()
    tensors = [table_groups, groups]
    if rows is not None:
        if rows.dtype != table_groups.dtype or not rows.is_contiguous() \
                or tuple(rows.shape) != (groups.shape[0],
                                         table_groups.shape[1]):
            raise ValueError(f"{name}: rows must be a contiguous [K, "
                             f"{table_groups.shape[1]}] {table_groups.dtype}")
        tensors.append(rows)
    if row_bytes % 16 or table_groups.data_ptr() % 16 \
            or (rows is not None and rows.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be 16-byte aligned multiples of "
                         "16 bytes")
    if any(t.device != table_groups.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    return row_bytes


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fn(name: str):
    fn = getattr(kernels.load("sparse_table"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_void_p]
    return fn


def group_scatter(table_groups: torch.Tensor, groups: torch.Tensor,
                  arranged: torch.Tensor) -> torch.Tensor:
    """``table_groups[groups[j]] = arranged[j]`` for every real group (the
    sentinel ``groups[j] >= len(table_groups)`` is skipped), in place:
    writes into the caller's tensor and returns it, with no copy of the
    table. CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``group_scatter.launches``)."""
    if table_groups.device.type == "cpu":
        return group_scatter_plain(table_groups, groups, arranged)
    if table_groups.device.type != "cuda":
        raise ValueError(f"group_scatter: no kernel for "
                         f"{table_groups.device}")
    row_bytes = _check_groups("group_scatter", table_groups, groups, arranged)
    with torch.cuda.device(table_groups.device):
        rc = _fn("group_scatter")(
            table_groups.data_ptr(), groups.data_ptr(), arranged.data_ptr(),
            groups.shape[0], table_groups.shape[0], row_bytes,
            _stream(table_groups.device))
    if rc != 0:
        raise RuntimeError(f"group_scatter kernel launch failed: CUDA error "
                           f"{rc}")
    group_scatter.launches += 1
    return table_groups


group_scatter.launches = 0


def group_gather(table_groups: torch.Tensor, groups: torch.Tensor
                 ) -> torch.Tensor:
    """``out[j] = table_groups[groups[j]]`` for every real group; the rows
    of sentinel groups are never written (and must not be read). CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``group_gather.launches``)."""
    if table_groups.device.type == "cpu":
        return group_gather_plain(table_groups, groups)
    if table_groups.device.type != "cuda":
        raise ValueError(f"group_gather: no kernel for {table_groups.device}")
    row_bytes = _check_groups("group_gather", table_groups, groups)
    out = table_groups.new_empty((groups.shape[0], table_groups.shape[1]))
    with torch.cuda.device(table_groups.device):
        rc = _fn("group_gather")(
            table_groups.data_ptr(), groups.data_ptr(), out.data_ptr(),
            groups.shape[0], table_groups.shape[0], row_bytes,
            _stream(table_groups.device))
    if rc != 0:
        raise RuntimeError(f"group_gather kernel launch failed: CUDA error "
                           f"{rc}")
    group_gather.launches += 1
    return out


group_gather.launches = 0


# ---------------------------------------------------------------------------
# grouped gather and write-back of a table at packed scale
# ---------------------------------------------------------------------------

def gather_rows_grouped(table: torch.Tensor, uids: torch.Tensor,
                        group_plan: Dict, dim: int,
                        plans: Optional[Dict] = None
                        ) -> Tuple[GatheredRows, torch.Tensor]:
    """(GatheredRows for ``uids``, the gathered group buffer [K, R * D])
    from a table at packed scale: one plain dim-0 gather of the touched
    groups (the JAX package measured it faster than its Pallas gather, and
    takes it), then the touched rows out of that buffer. The buffer is the
    old content :func:`group_scatter_apply` merges with."""
    R = group_plan["slot_src"].shape[1]
    with TRC.span("table.gather"):
        groups_view = group_view(table, R)
        group_buf = groups_view[group_plan["groups"].long()
                                .clamp(0, groups_view.shape[0] - 1)]
        rows = group_buf.view(-1, dim)[group_plan["uid_pos"].long()]
        rows = rows * (uids < table.shape[0])[:, None].to(rows.dtype)
    return GatheredRows(uids, rows, plans or {}), group_buf


def group_scatter_apply(buf: torch.Tensor, vals: torch.Tensor,
                        group_plan: Dict,
                        old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``buf[uids] = vals`` on a [Vp, D] buffer at packed scale, as whole
    group writes, in place: each touched group's merged content (new rows
    at touched slots, old rows elsewhere: a gather and a ``where``, no row
    scatter), then :func:`group_scatter`, one launch per chunk of
    ``_SCATTER_CHUNK_GROUPS`` groups so the temporaries stay O(chunk).
    ``old``: the group buffer of :func:`gather_rows_grouped`, when the
    groups were gathered this step."""
    groups, slot_src = group_plan["groups"], group_plan["slot_src"]
    K, R = slot_src.shape
    D = vals.shape[-1]
    if R * D != 8 * 128:
        raise ValueError(f"a group plan of {R} rows does not fit rows of "
                         f"{D}")
    table_groups = group_view(buf, R)
    nG = table_groups.shape[0]
    vals_ext = torch.cat([vals.to(buf.dtype), vals.new_zeros((1, D),
                                                             dtype=buf.dtype)])
    step = max(_SCATTER_CSC,
               min(K, -(-_SCATTER_CHUNK_GROUPS // _SCATTER_CSC)
                   * _SCATTER_CSC))
    for lo in range(0, K, step):
        hi = min(lo + step, K)
        g = groups[lo:hi]
        ss = slot_src[lo:hi].long()
        picked = vals_ext[ss.clamp(max=vals_ext.shape[0] - 1)]   # [k, R, D]
        old_k = old[lo:hi] if old is not None \
            else table_groups[g.long().clamp(0, nG - 1)]
        arranged = torch.where((ss < K)[..., None], picked,
                               old_k.view(hi - lo, R, D))
        group_scatter(table_groups, g, arranged.reshape(hi - lo, R * D))
    return buf


def scatter_row_update(table: torch.Tensor, opt: Dict, uids: torch.Tensor,
                       new_rows: torch.Tensor, opt_rows: Dict,
                       group_plan: Optional[Dict] = None,
                       table_old: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Write-only companion of :func:`compute_row_update`, in place. With a
    host ``group_plan`` (tables at packed scale) every [Vp, D] buffer
    writes whole groups (:func:`group_scatter_apply`); 1-D state and
    tables below packed scale take a row write of the real uids (sentinels
    dropped). A table at packed scale must come with its plan: the trainer
    refuses a batch without one (``trainer.sparse_loss_backward``)."""
    real = uids < table.shape[0]
    idx = uids[real].long()

    def one(buf, vals, old=None):
        if group_plan is not None and buf.dim() == 2:
            return group_scatter_apply(buf, vals, group_plan, old=old)
        return buf.index_copy_(0, idx, vals[real].to(buf.dtype))

    table = one(table, new_rows, old=table_old)
    opt = {k: one(opt[k], v) for k, v in opt_rows.items()}
    return table, opt


def apply_row_update(table: torch.Tensor, opt: Dict, uids: torch.Tensor,
                     drows: torch.Tensor, group_plan: Optional[Dict] = None,
                     rows0: Optional[torch.Tensor] = None,
                     table_old: Optional[torch.Tensor] = None,
                     **kw) -> Tuple[torch.Tensor, Dict]:
    """:func:`compute_row_update` then :func:`scatter_row_update`, in
    place. At packed scale pass ``rows0`` and ``table_old`` from
    :func:`gather_rows_grouped`, so the table is not gathered again."""
    with TRC.span("table.update"):
        new_rows, opt_rows = compute_row_update(table, opt, uids, drows,
                                                rows0=rows0, **kw)
        return scatter_row_update(table, opt, uids, new_rows, opt_rows,
                                  group_plan=group_plan, table_old=table_old)


# ---------------------------------------------------------------------------
# tables row-sharded over a mesh: per-shard plans, gather and update
# ---------------------------------------------------------------------------

def mesh_table_shards(mesh) -> int:
    """Number of table-row shards of a mesh (product over the table
    axes)."""
    from ..parallel.mesh import table_shards

    return table_shards(mesh)


def shard_capacity(cap: int, n_shards: int, slack: float = 1.35) -> int:
    """Static per-shard touched-row capacity: ceil(cap / S) with ``slack``
    headroom for imbalance, rounded up to the scatter chunk (1024). With
    uniformly spread ids the largest shard's load is cap / S + O(sqrt(cap /
    S)); :func:`host_shard_plan` raises rather than drops rows past it."""
    if n_shards <= 1:
        return -(-cap // _SCATTER_CSC) * _SCATTER_CSC
    per = int(-(-cap // n_shards) * slack)
    return -(-per // _SCATTER_CSC) * _SCATTER_CSC


def host_shard_plan(uids_np, vocab_rows: int, group_rows: Optional[int],
                    n_shards: int, cap_per_shard: int) -> Dict:
    """HOST-side per-shard plan for a table row-sharded over ``n_shards``
    (``uids_np`` sorted unique, sentinel ``vocab_rows`` tail; ``vocab_rows``
    the physical rows, a multiple of S). With S = n_shards, Kp =
    cap_per_shard, R = group_rows, K = len(uids):

    - ``lids`` [S, Kp] int32: LOCAL row ids per shard (sentinel: the rows
      per shard, out of local range);
    - ``gpos`` [S, Kp] int32: each local row's position in the global uid
      order (sentinel K: callers append a zero row);
    - ``groups`` [S, Kp] int32: local touched group ids (sentinel: the
      local group count, skipped by the scatter);
    - ``slot_src`` [S, Kp, R] int32: per group slot, the row in the shard's
      new-rows tensor [Kp, D] (sentinel Kp: keep the old value);
    - ``pos`` [K] int32: each uid's row in the all-gathered owner-blocked
      buffer [S * Kp, D].

    ``group_rows`` None (a table below packed scale, written by rows)
    leaves out ``groups`` and ``slot_src``. Raises on a shard's capacity
    overflow, naming ``train.sparse_shard_slack``."""
    uids = np.asarray(uids_np)
    K = len(uids)
    Kp = int(cap_per_shard)
    assert vocab_rows % n_shards == 0, (vocab_rows, n_shards)
    rps = vocab_rows // n_shards
    grouped = group_rows is not None
    if grouped:
        assert rps % group_rows == 0, (rps, group_rows)
        nGl = rps // group_rows
        groups = np.full((n_shards, Kp), nGl, np.int32)
        slot_src = np.full((n_shards, Kp, group_rows), Kp, np.int32)
    real = uids < vocab_rows
    owner = np.minimum(uids // rps, n_shards - 1)
    lids = np.full((n_shards, Kp), rps, np.int32)
    gpos = np.full((n_shards, Kp), K, np.int32)
    pos = np.zeros((K,), np.int32)
    for s in range(n_shards):
        sel = np.nonzero(real & (owner == s))[0]
        n = len(sel)
        if n > Kp:
            raise ValueError(
                f"table shard {s} touched {n} rows > per-shard capacity "
                f"{Kp}. Shard ownership is contiguous-range "
                f"(uid // rows_per_shard), so id layouts that cluster hot "
                f"rows into one range can exceed the uniform-spread "
                f"headroom — raise train.sparse_shard_slack by at least "
                f"{n / max(Kp, 1):.2f}x its current value (default 1.35)")
        lu = (uids[sel] - s * rps).astype(np.int32)
        lids[s, :n] = lu
        gpos[s, :n] = sel
        pos[sel] = s * Kp + np.arange(n, dtype=np.int32)
        if grouped:
            gr = lu // group_rows
            first = np.ones(n, bool)
            first[1:] = gr[1:] != gr[:-1]
            groups[s, : int(first.sum())] = gr[first]
            gidx = np.cumsum(first) - 1
            slot_src[s, gidx, lu % group_rows] = np.arange(n, dtype=np.int32)
    out = {"lids": lids, "gpos": gpos, "pos": pos}
    if grouped:
        out.update(groups=groups, slot_src=slot_src)
    return out


def _shard_blocks(mesh, t: torch.Tensor):
    """[(shard index, row block)] of a table or row-optimizer leaf this
    process holds on ``mesh``: its own block on a process mesh, every row
    block (views) of the leaf on a local mesh."""
    if mesh.process:
        return list(zip(mesh.table_indices, [t]))
    return list(zip(mesh.table_indices, t.chunk(mesh_table_shards(mesh))))


def sharded_gather_rows(mesh, table: torch.Tensor, uids: torch.Tensor,
                        shard_plan: Dict, dim: int,
                        plans: Optional[Dict] = None) -> GatheredRows:
    """GatheredRows for ``uids`` from a table row-sharded over ``mesh``
    (``table``: this process's leaf, :func:`_shard_blocks`): each shard's
    rows at its ``lids``, one all-gather of the [Kp, D] row blocks over the
    table shards (never whole groups; on a model mesh over the model group,
    then the data group), then the host-planned permutation ``pos`` back
    to the global uid order."""
    blocks = _shard_blocks(mesh, table)
    rps = blocks[0][1].shape[0]
    vocab = rps * mesh_table_shards(mesh)
    local = []
    with TRC.span("table.gather"):
        for s, blk in blocks:
            lids = shard_plan["lids"][s]
            rows = row_take(blk, lids)
            local.append(rows * (lids < rps)[:, None].to(rows.dtype))
        rows_cat = mesh.all_gather_tables(local)          # [S * Kp, D]
        rows = rows_cat[shard_plan["pos"].long()]
        rows = rows * (uids < vocab)[:, None].to(rows.dtype)
    return GatheredRows(uids, rows, plans or {})


def sharded_apply_row_update(mesh, table: torch.Tensor, opt: Dict,
                             uids: torch.Tensor, drows: torch.Tensor,
                             shard_plan: Dict, rows0: torch.Tensor, *,
                             kind: str, lr: float, step: int,
                             weight_decay: float = 0.0, eps: float = 1e-8,
                             b1: float = 0.9, b2: float = 0.98, **_unused
                             ) -> Tuple[torch.Tensor, Dict]:
    """Row-sparse update of a table row-sharded over ``mesh``, in place:
    each shard takes its rows' gradient from the global [K, D] ``drows``
    (and their old values from ``rows0``) through ``gpos``, updates its
    block of the optimizer state (:func:`compute_row_update`) and writes
    its block: with a grouped plan (packed scale, rowwise Adagrad only, as
    the JAX package asserts) through :func:`group_scatter_apply` on the
    block's groups, one group-scatter launch per chunk and shard on the
    card; otherwise by a row write of the real local rows."""
    grouped = "groups" in shard_plan
    if grouped:
        assert kind == "rowwise_adagrad", (
            "sharded packed tables support rowwise_adagrad (the production "
            f"choice at packed scale); got {kind!r}")
    D = drows.shape[-1]
    zero = drows.new_zeros((1, D), dtype=torch.float32)
    opt_blocks = {k: dict(_shard_blocks(mesh, v)) for k, v in opt.items()}
    with TRC.span("table.update"):
        vals_ext = torch.cat([drows.float(), zero])
        rows_ext = torch.cat([rows0.float(), zero])
        for s, blk in _shard_blocks(mesh, table):
            lids = shard_plan["lids"][s]
            gpos = shard_plan["gpos"][s].long()
            oblk = {k: v[s] for k, v in opt_blocks.items()}
            new_rows, opt_rows = compute_row_update(
                blk, oblk, lids, vals_ext[gpos], kind=kind, lr=lr,
                step=step, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                rows0=rows_ext[gpos])
            plan = {"groups": shard_plan["groups"][s],
                    "slot_src": shard_plan["slot_src"][s]} \
                if grouped else None
            scatter_row_update(blk, oblk, lids, new_rows, opt_rows,
                               group_plan=plan)
    return table, opt
