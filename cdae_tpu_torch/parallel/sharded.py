"""Sharded training and scoring steps of CDAE and the dense slabs (port of
cdae_tpu/parallel/sharded.py).

cdae_tpu compiles the single-device step under GSPMD with the batch over
'data', W / V / b' over 'model' and Wu / Uu over 'data', and XLA inserts
the collectives. Here each rank runs the SAME single-device step function
(models/cdae.py ``_train_step`` / ``_dense_train_step``, the slabs of
models/mf.py and models/fism.py) with its ``coll`` argument set
(parallel/mesh.py ``Collectives``): the step takes its rows of the batch,
works on its table blocks with the port's kernels (B1 at its offsets, B8
into its own item block, one B2 launch over its blocks, B3 for its score
block) and calls the collectives where GSPMD put them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cdae_tpu_torch.models.cdae import (
    CDAE,
    _decode,
    _dense_train_step,
    _finish_hidden,
    _hidden,
    _mm,
    _train_step,
)
from cdae_tpu_torch.parallel.mesh import (
    Mesh,
    cdae_param_specs,
    shard_params,
)


def make_sharded_train_step(model: CDAE, mesh: Mesh, num_users: int,
                            num_items: int):
    """The sparse CDAE step of one rank: ``step(params, uids, items, mask,
    lengths, weight, seed, **draws)`` over the WHOLE batch, the rank's
    parameter blocks updated in place."""
    coll = mesh.collectives(num_users, num_items)
    return functools.partial(_train_step, cfg=model.cfg, loss=model.loss,
                             coll=coll)


def make_sharded_dense_step(model: CDAE, mesh: Mesh, num_users: int,
                            num_items: int):
    """The dense CDAE step of one rank: ``step(params, R_block, uids,
    weight, seed)``, with ``R_block`` the rank's (U / n_data, I / n_model)
    block of dense_R (a side the mesh does not divide whole, as its
    tables)."""
    coll = mesh.collectives(num_users, num_items)
    return functools.partial(_dense_train_step, cfg=model.cfg,
                             loss=model.loss, coll=coll)


def make_sharded_mf_dense_step(model, mesh: Mesh, num_users: int,
                               num_items: int):
    """A dense-slab MF step (IMF) of one rank: ``step(params, R_block,
    R_block, uids, weight, keys)`` with the rank's block of dense_R."""
    coll = mesh.collectives(num_users, num_items)
    return functools.partial(model._dense_step, cfg=model.cfg,
                             loss=model.loss, coll=coll)


def make_sharded_fism_dense_step(model, mesh: Mesh, num_users: int,
                                 num_items: int):
    """The dense-slab FISM step of one rank: ``step(params, R_block, uids,
    weight, lr, seed)`` with the rank's block of dense_R."""
    from cdae_tpu_torch.models.fism import _fism_dense_step

    coll = mesh.collectives(num_users, num_items)
    return functools.partial(_fism_dense_step, cfg=model.cfg,
                             loss=model.loss, coll=coll)


def sharded_hidden(params, coll, uids, rated_items, rated_mask, cfg,
                   R_block=None):
    """Hidden codes of this rank's rows ``coll.rows(B)`` of a batch of
    users (``uids`` whole): from the uncorrupted padded rated rows (item
    rows gathered from their owners) or, with ``R_block``, a dense encode
    of the rank's block of dense_R summed over 'model'."""
    sl = coll.rows(uids.shape[0])
    user_rows = {n: coll.gather_users(params[n], uids)[sl]
                 for n in ("Uu", "Wu") if n in params}
    off = cfg.corruption_ratio == 1.0
    if R_block is not None:
        dt = params["W"].dtype
        rows = coll.batch_rows(R_block, uids).to(dt)
        if off:
            rows = torch.zeros_like(rows)
        h = coll.model_sum(_mm(rows, params["W"], cfg).to(dt))
        return _finish_hidden(h, params, user_rows, cfg)
    items = rated_items[sl].long()
    mask = torch.zeros_like(rated_mask[sl]) if off else rated_mask[sl]
    rows = coll.gather_items(params["W"],
                             items.clamp(0, coll.num_items - 1))
    return _hidden(params, uids[sl], items, mask, 1.0, cfg, rows=rows,
                   user_rows=user_rows)


def make_sharded_scores(model: CDAE, mesh: Mesh, num_users: int,
                        num_items: int):
    """Full-catalog scoring of one rank: ``fn(params, uids, rated_items,
    rated_mask, R_block=None)`` over a whole batch (B dividing over
    'data') -> the rank's (B / n_data, I / n_model) score block, decoded
    by B3 with the kernels on."""
    coll = mesh.collectives(num_users, num_items)

    def fn(params, uids, rated_items, rated_mask, R_block=None):
        z = sharded_hidden(params, coll, uids, rated_items, rated_mask,
                           model.cfg, R_block)
        return _decode(params, z, model.cfg)

    return fn


def shard_cdae_state(mesh: Mesh, params) -> dict:
    """This rank's blocks of CDAE's parameters by their layouts."""
    return shard_params(mesh, params, cdae_param_specs(params))


def make_batch(pb, sel: np.ndarray, batch_size: int):
    """Host-side fixed-size batch slicing: the first ``batch_size`` users of
    ``sel`` as ``iter_user_batches`` cuts a batch (padded with user 0 at
    weight 0); returns (uids, items, mask, lengths, weight)."""
    sel = np.asarray(sel)[:batch_size]
    weight = np.ones(batch_size, dtype=np.float32)
    pad = batch_size - len(sel)
    if pad > 0:
        sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
        weight[batch_size - pad:] = 0.0
    mask = pb.mask[sel] & (weight[:, None] > 0)
    lengths = pb.lengths[sel] * weight.astype(np.int32)
    return pb.uids[sel], pb.items[sel], mask, lengths, weight
