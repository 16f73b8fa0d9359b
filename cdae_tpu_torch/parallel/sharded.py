"""Sharded training and scoring steps of CDAE and the dense slabs (port of
cdae_tpu/parallel/sharded.py).

cdae_tpu compiles the single-device step under GSPMD with the batch over
'data', W / V / b' over 'model' and Wu / Uu over 'data', and XLA inserts
the collectives. Here each rank runs the SAME step function as one
device (models/cdae.py ``_train_step`` / ``_dense_train_step``, the slabs
of models/mf.py and models/fism.py) with its rank's ``coll``
(parallel/mesh.py ``Collectives``): the step takes its rows of the batch,
works on its table blocks with the port's kernels (B1 at its offsets, B8
into its own item block, one B2 launch over its blocks, B3 for its score
block) and calls the collectives where GSPMD put them. These are
cdae_tpu's names for those bindings.
"""

from __future__ import annotations

import functools

import numpy as np

from cdae_tpu_torch.models.cdae import (
    CDAE,
    _decode,
    _dense_train_step,
    _serve_hidden,
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


def make_sharded_scores(model: CDAE, mesh: Mesh, num_users: int,
                        num_items: int):
    """Full-catalog scoring of one rank: ``fn(params, uids, rated_items,
    rated_mask, R_block=None)`` over a whole batch (B dividing over
    'data') -> the rank's (B / n_data, I / n_model) score block, decoded
    by B3 with the kernels on."""
    coll = mesh.collectives(num_users, num_items)

    def fn(params, uids, rated_items, rated_mask, R_block=None):
        z = _serve_hidden(params, uids, rated_items, rated_mask,
                          cfg=model.cfg, coll=coll, dense_R=R_block)
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
