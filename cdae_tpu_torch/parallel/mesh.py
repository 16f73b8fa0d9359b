"""Process meshes and sharding layouts (port of cdae_tpu/parallel/mesh.py).

Mesh axes, as in cdae_tpu:
  data  -- the users / batch axis (data parallelism; per-user gradients
           are independent, so it is exact up to the order of sums);
  model -- the item / catalog axis: W, V, b' (and the MF family's item
           tables) split into contiguous row blocks, full-catalog decode
           and top-k per block.

cdae_tpu lays tables out with ``NamedSharding``s over a device mesh and
lets XLA insert the collectives. Here one process drives one device and
the ranks form the grid ``arange(world).reshape(n_data, n_model)``: rank r
sits at (d, m) = (r // n_model, r % n_model). ``make_mesh`` builds one
process subgroup per data row (the ranks that share d: the ``model``
group) and one per model column (the ``data`` group); every rank calls
``dist.new_group`` for every group, in the same order. The sharded steps
call their collectives explicitly (``Collectives``), only ``all_reduce``,
``all_gather`` and ``barrier``: collectives gloo has too, so the same code
runs over gloo on the CPU and over NCCL on the card.

A layout is a tuple of axis names per table dimension (``("model", None)``
splits rows over 'model'; ``()`` replicates), the entries of cdae_tpu's
``PartitionSpec``s. ``_fit_spec`` keeps cdae_tpu's rule: an axis that
does not divide its dimension replicates it instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


class Mesh:
    """The ('data', 'model') grid of processes as this rank sees it: its
    coordinates, its two subgroups, its device and the collectives over
    them. Without a process group (one process) the mesh is 1 x 1 and
    every collective returns its input."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int, n_model: int, device,
                 groups: Optional[dict] = None, rank: int = 0):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.grid = np.arange(n_data * n_model).reshape(n_data, n_model)
        self.rank = int(rank)
        self.d, self.m = divmod(self.rank, int(n_model))
        self.device = torch.device(device)
        self._groups = groups or {}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def coord(self, axis: str) -> int:
        return self.d if axis == "data" else self.m

    def group(self, axis: str):
        """The process subgroup of ``axis`` this rank belongs to (None
        without a process group)."""
        return self._groups.get(axis)

    # ----------------------------------------------------- collectives ----
    def all_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` summed over the ranks of ``axis`` (the input is not
        changed; an axis of one rank returns it as it is)."""
        g = self.group(axis)
        if g is None or self.shape[axis] == 1:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in axis
        order (every rank's ``t`` has the same shape)."""
        g = self.group(axis)
        if g is None or self.shape[axis] == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim=dim)

    def all_gather_world(self, t: torch.Tensor, dim: int = 0
                         ) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order
        (a flat axis over the whole mesh)."""
        if not dist.is_initialized() or self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def collectives(self, num_users: int, num_items: int,
                    **kw) -> "Collectives":
        """The step collectives for a model of these dimensions."""
        return Collectives(self, num_users, num_items, **kw)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank} at ({self.d}, "
                f"{self.m}), device={self.device})")


def make_mesh(
    n_data: Optional[int] = None,
    n_model: Optional[int] = None,
    device=None,
) -> Mesh:
    """Build the ('data', 'model') mesh over the processes of the group
    (one process without one).

    With only one axis size given, the other gets the remaining factor;
    with neither, every process goes to 'data' (pure data parallelism, the
    safe default). ``device`` defaults to this process's CUDA device when a
    GPU is present, else the CPU."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    elif n_model is None:
        if n % n_data:
            raise ValueError(f"{n} devices not divisible by n_data={n_data}")
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(
            f"mesh {n_data}x{n_model} != {n} available devices"
        )
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    if not dist.is_initialized():
        return Mesh(n_data, n_model, device)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(n_data, n_model)
    groups = {}
    # every rank creates every group, in the same order
    for d in range(n_data):
        g = dist.new_group([int(r) for r in grid[d]])
        if rank in grid[d]:
            groups["model"] = g
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if rank in grid[:, m]:
            groups["data"] = g
    return Mesh(n_data, n_model, device, groups, rank)


# ------------------------------------------------------------- layouts ----

def _base(name: str) -> str:
    return name[:-3] if name.endswith("_ag") else name


def cdae_param_specs(params: Dict) -> Dict[str, Spec]:
    """Layouts of the CDAE parameters: item-axis tables over 'model', user
    tables over 'data', small vectors replicated (AdaGrad accumulators
    follow their tables)."""
    specs: Dict[str, Spec] = {}
    for name in params:
        base = _base(name)
        if base in ("W", "V", "b_prime"):
            specs[name] = (("model",) if params[name].ndim == 1
                           else ("model", None))
        elif base in ("Wu", "Uu"):
            specs[name] = ("data", None)
        else:  # b and other small vectors
            specs[name] = ()
    return specs


def mf_param_specs(params: Dict) -> Dict[str, Spec]:
    """Layouts of the MF family: user tables over 'data', item tables over
    'model'."""
    specs: Dict[str, Spec] = {}
    for name in params:
        base = _base(name)
        if base in ("iv", "ib", "q", "bi", "Q", "P"):
            specs[name] = (("model",) if params[name].ndim == 1
                           else ("model", None))
        elif base in ("uv", "ub", "p", "bu", "x", "Wu"):
            specs[name] = (("data",) if params[name].ndim == 1
                           else ("data", None))
        else:
            specs[name] = ()
    return specs


def batch_specs() -> Dict[str, Spec]:
    """User-minibatch arrays split over 'data' on the batch axis."""
    return {
        "uids": ("data",),
        "items": ("data", None),
        "ratings": ("data", None),
        "mask": ("data", None),
        "lengths": ("data",),
        "weight": ("data",),
    }


def _fit_spec(mesh: Mesh, spec: Spec, shape) -> Spec:
    """Drop mesh axes a dimension cannot divide (replicate instead), as
    cdae_tpu does for GSPMD: small and odd tables degrade gracefully."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            out.append(None)
        elif d < len(shape) and shape[d] % mesh.shape[ax] == 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


def _block(mesh: Mesh, spec: Spec, shape) -> tuple:
    """The index of this rank's block of a table of ``shape``."""
    idx = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            idx.append(slice(None))
        else:
            per = n // mesh.shape[ax]
            lo = mesh.coord(ax) * per
            idx.append(slice(lo, lo + per))
    return tuple(idx)


def shard_params(mesh: Mesh, params: Dict, specs: Dict[str, Spec]) -> Dict:
    """Each full table (numpy array or tensor) cut to this rank's block by
    its fitted layout, as a contiguous tensor on the mesh's device (a copy:
    the steps update their blocks in place)."""
    out = {}
    for k, v in params.items():
        spec = _fit_spec(mesh, specs[k], tuple(v.shape))
        blk = torch.as_tensor(v)[_block(mesh, spec, tuple(v.shape))]
        out[k] = blk.to(mesh.device, copy=True).contiguous()
    return out


def gather_params(mesh: Mesh, params: Dict, specs: Dict[str, Spec],
                  shapes: Dict[str, tuple]) -> Dict:
    """The inverse of ``shard_params``: every table whole on every rank,
    from the ranks' blocks (``shapes``: the full shapes, which fix each
    table's fitted layout). A collective: every rank calls it."""
    out = {}
    for k, v in params.items():
        spec = _fit_spec(mesh, specs[k], shapes[k])
        for d, ax in enumerate(spec):
            if ax is not None:
                v = mesh.all_gather(v, ax, dim=d)
        out[k] = v
    return out


# --------------------------------------------------- step collectives ----

class Collectives:
    """What a sharded train step needs of the mesh, for one model's
    dimensions: CDAE's step functions always take one (a 1 x 1 mesh's on
    one process, where every collective returns its input and every block
    is the whole table), the MF family's as their optional ``coll``
    argument (None: the single-device step); they call it where GSPMD put
    its collectives.

    - ``rows(B)``: this rank's contiguous block of a batch's B rows, as
      ``P('data')`` splits them (B must divide over 'data').
    - ``data_sum``: a partial sum over this rank's batch rows completed
      over 'data' (table gradients, bias sums, counts).
    - ``model_sum``: a partial sum over this rank's item block completed
      over 'model' (the encode's pre-activation, the back-propagated
      hidden gradient, row lengths); the identity when the catalog does
      not divide over 'model' and the item tables are replicated.
    - ``model_gather`` / ``data_gather``: blocks concatenated over an axis.
    - ``items`` / ``users``: this rank's block [lo, hi) of the item and
      user tables (the whole table where the layout replicates it).

    ``split_items`` / ``split_users`` False replicate a side whatever its
    size (the data-parallel wrappers); ``table_items`` is the item tables'
    row count when it differs from the catalog (ShardedMFTP pads them to
    a multiple of n_model); ``gather_contribs``: the MF steps all-gather
    their contribution rows over 'data' and aggregate them into the rank's
    own blocks instead of summing aggregated tables over 'data'.
    """

    def __init__(self, mesh: Mesh, num_users: int, num_items: int, *,
                 split_items: bool = True, split_users: bool = True,
                 gather_contribs: bool = False,
                 table_items: Optional[int] = None):
        self.mesh = mesh
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.gather_contribs = bool(gather_contribs)
        nd, nm = mesh.shape["data"], mesh.shape["model"]
        table_items = self.num_items if table_items is None else table_items
        self.items_split = (split_items and nm > 1
                            and table_items % nm == 0)
        self.users_split = split_users and nd > 1 and num_users % nd == 0
        per_i = table_items // nm if self.items_split else table_items
        lo = mesh.m * per_i if self.items_split else 0
        self.items = (lo, lo + per_i)
        per_u = num_users // nd if self.users_split else num_users
        lo = mesh.d * per_u if self.users_split else 0
        self.users = (lo, lo + per_u)

    @property
    def col_offset(self) -> int:
        return self.items[0]

    @property
    def num_cols(self) -> int:
        return self.items[1] - self.items[0]

    def rows(self, B: int) -> slice:
        nd = self.mesh.shape["data"]
        if B % nd:
            raise ValueError(f"a batch of {B} rows does not divide over "
                             f"n_data={nd}")
        per = B // nd
        return slice(self.mesh.d * per, (self.mesh.d + 1) * per)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(t, "data")

    def data_sum_all(self, tensors: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """``data_sum`` of every tensor of a dict in one all_reduce of
        their flat concatenation."""
        if self.mesh.shape["data"] == 1 or not tensors:
            return tensors
        names = list(tensors)
        flat = torch.cat([tensors[n].reshape(-1) for n in names])
        flat = self.mesh.all_sum(flat, "data")
        out, at = {}, 0
        for n in names:
            t = tensors[n]
            out[n] = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
        return out

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(t, "model") if self.items_split else t

    def model_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if not self.items_split:
            return t
        return self.mesh.all_gather(t, "model", dim=dim % t.dim())

    def data_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.mesh.all_gather(t, "data", dim=dim % t.dim())

    def _gather(self, table, ids, block, split: bool, axis: str):
        if not split:
            return table[ids]
        lo, hi = block
        lid = ids - lo
        ok = (lid >= 0) & (lid < hi - lo)
        rows = table[lid.clamp(0, hi - lo - 1)]
        mask = ok if rows.dim() == ok.dim() else ok[..., None]
        return self.mesh.all_sum(torch.where(mask, rows, 0), axis)

    def gather_items(self, table: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
        """Rows of an item table at global ``ids`` (the same ids on every
        rank of a 'model' group): each rank gathers the rows it owns, zeros
        elsewhere, and one ``model_sum`` completes them (cdae_tpu's
        ``_psum_gather``)."""
        return self._gather(table, ids, self.items, self.items_split,
                            "model")

    def gather_users(self, table: torch.Tensor, uids: torch.Tensor
                     ) -> torch.Tensor:
        """Rows of a user table at global ``uids`` (the same ids on every
        rank of a 'data' group: a whole batch's)."""
        return self._gather(table, uids, self.users, self.users_split,
                            "data")

    def batch_rows(self, table: torch.Tensor, uids: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's rows ``rows(B)`` of a whole batch ``uids`` from a
        user-axis table: its own rows where the users are not split, else
        the batch's rows gathered from their owners (``gather_users``).
        The dense_R block is read so: its users over 'data', its item
        columns over 'model'."""
        sl = self.rows(uids.shape[0])
        if not self.users_split:
            return table[uids[sl]]
        return self.gather_users(table, uids)[sl]

    def dense_block(self, users, items) -> torch.Tensor:
        """This rank's block of the int8 (U, I) interaction matrix dense_R
        (cdae_tpu's P('data', 'model')), built on the device from the
        interactions' ``users`` / ``items`` ids: the whole matrix is never
        held on a rank."""
        (ulo, uhi), (ilo, ihi) = self.users, self.items
        u = torch.as_tensor(users, dtype=torch.long, device=self.mesh.device)
        i = torch.as_tensor(items, dtype=torch.long, device=self.mesh.device)
        R = torch.zeros((uhi - ulo, ihi - ilo), dtype=torch.int8,
                        device=self.mesh.device)
        if self.users_split or self.items_split:  # a block: its own pairs
            keep = (u >= ulo) & (u < uhi) & (i >= ilo) & (i < ihi)
            u, i = u[keep] - ulo, i[keep] - ilo
        R[u, i] = 1
        return R

    def own_users(self, uids: torch.Tensor):
        """(local row ids, owned mask) of global user ids in this rank's
        user block (ids outside it map to row 0, not owned)."""
        lo, hi = self.users
        owned = (uids >= lo) & (uids < hi)
        return torch.where(owned, uids - lo, 0), owned

    def own_rows(self, uids: torch.Tensor, live: torch.Tensor):
        """(local row ids, live mask) of a whole batch's global user ids:
        rows of this rank's user block, live where ``live`` and the row is
        the rank's own. Where the users are not split every row is its
        own: ``uids`` and ``live`` as they are, no device op."""
        if not self.users_split:
            return uids, live
        rows, owned = self.own_users(uids)
        return rows, live & owned

    def own_items(self, ids: torch.Tensor) -> torch.Tensor:
        """Global item ids as rows of this rank's item block; ids outside
        it become the block size, the id a row aggregation drops."""
        lo, hi = self.items
        if not self.items_split:
            return ids
        return torch.where((ids >= lo) & (ids < hi), ids - lo, hi - lo)
