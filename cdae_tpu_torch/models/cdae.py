"""CDAE -- Collaborative Denoising Auto-Encoder (WSDM'16), on PyTorch.

Port of cdae_tpu/models/cdae.py: the configuration, parameter reset, dense
(full-catalog) training, the losses, the hidden encode and every way a batch
of users is scored or ranked. With ``use_pallas`` on (the default on a CUDA
device) training runs the hand-written kernels hw_uniform (the masks) and
adagrad_update (the W, b', b sweep, one launch a step), or with
``fused_step=True`` the fused step of ops/cdae_fused.py; scoring runs the
decode and fused top-k kernels.

Training has two steps, as in cdae_tpu. While the int8 (U, I) interaction
matrix fits (the auto rule below), the dense step works on (B, I) slabs
with matmuls. Past it -- ML-20M at D=200, a 1M-item catalog -- the sparse
step works on each batch's padded (B, L) rated rows: gathers of the rated
rows, exact complement negatives in num_neg chunks of (B, L) or one pooled
draw of ``neg_pool`` ids a batch, and row aggregations of the gradients.
Every aggregation runs ``ops/scatter.py:scatter_add_rows`` over one plan
per id vector: kernel B8 on the card with ``use_pallas``, so its sums run
in a fixed order and a sparse run is the same bits on every run.

Model math (as in cdae_tpu):
  h   = s * sum_{i in rated} W_i   (* U_u if linear_function)
  h  += b (+ W^u_u if user_factor)
  z   = sigmoid(h) | tanh(h) | h    with the reference's +-18 / +-9 clamps
  y_o = (V_o | W_o) . z + b'_o      (linear decoder)
Training corrupts the input (each rated item kept w.p. 1 - q, scaled by
1/(1 - q) if ``scaled``), draws Bernoulli negatives with expected count
num_neg*|O_u|, and applies AdaGrad per minibatch. Serving uses the
uncorrupted input with scale 1 (an empty input when corruption_ratio == 1).

Random draws. cdae_tpu's threefry and TPU hardware streams cannot be
reproduced in torch. Every train step takes a 32-bit step seed that is a
pure host function of (solver seed, ``state.step``, batch index, corruption
index) -- utils/random.py ``step_seed`` -- so a run resumed from a
checkpoint's step replays the same draws. With ``fast_rng`` (default on CUDA) the masks come from
``hw_uniform`` (a counter hash, the stream cdae_tpu's fused kernel uses off
the TPU); without it from a ``torch.Generator`` seeded with the step seed.
The step functions also take injected uniforms, so tests feed them the
very draws cdae_tpu makes.

Parameter init: U(-s, s) with s = 4 * sqrt(6 / (num_items + num_dim)),
AdaGrad accumulators at 1e-4. The draws come from a ``torch.Generator``,
so a fresh reset differs from cdae_tpu's; a checkpoint carries parameters
across (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from cdae_tpu_torch.data.dataset import Interactions, rows_from_csr
from cdae_tpu_torch.models.base import (
    ModelState,
    RecsysModel,
    dense_fits,
    iter_user_batches,
    iter_user_batches_csr,
    resolve_device,
)
from cdae_tpu_torch.ops.cdae_fused import (
    cdae_dense_step_fused,
    cdae_dense_step_fused_plain,
)
from cdae_tpu_torch.ops.corruption import input_scale
from cdae_tpu_torch.ops.losses import Loss
from cdae_tpu_torch.ops.pallas_kernels import (
    _MAX_K,
    decode_scores,
    fused_topk_scores,
    fused_topk_scores_csr,
    hw_uniform,
    hw_uniform_plain,
    streaming_topk_scores,
)
from cdae_tpu_torch.ops.penalties import Penalty
from cdae_tpu_torch.ops.sampling import hw_randint, is_rated, sample_unrated
from cdae_tpu_torch.ops.scatter import row_plan, scatter_add_rows
from cdae_tpu_torch.parallel.mesh import Collectives
from cdae_tpu_torch.solver.optimizer import (
    ADAGRAD_INIT,
    dense_adagrad_step,
    dense_adagrad_steps,
    row_adagrad_delta,
)
from cdae_tpu_torch.utils.profiling import (
    count,
    phase,
    profiler_active,
    span,
)
from cdae_tpu_torch.utils.random import step_seed

_LOSS_STREAM = -1  # the seed stream of data_loss draws (not the solver's)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CDAEConfig:
    """Every field of cdae_tpu's CDAEConfig, so CLI flags and checkpoints
    carry over. ``dense_mode``: None picks the dense step while the int8
    (U, I) matrix and the step's (B, I) slabs fit (models/base.py
    ``dense_fits``), else the sparse step. The sparse step's knobs:

    - ``neg_pool`` (K): one pool of K uniform item ids a batch, each user
      keeping a pool id with q_u = num_neg*|O_u|*I / (K*(I - |O_u|)), so an
      unrated item's expected touches equal exact sampling's; None = exact
      complement sampling, num_neg * L draws a user.
    - ``row_update``: AdaGrad on only the touched W / V / b' rows, by
      duplicate-safe delta-adds in the reference's touch order, instead of
      the dense apply over the whole tables; None = off.
    - ``packed_io``: None or True (the tied decoder, no row_update) adds the
      positives' output- and input-side gradients before their one
      aggregation with b'; False aggregates them apart. Only the order of
      the f32 sums differs.
    - ``cache_device_batches``: keep the epoch's batches on the device
      (default), else build them anew each epoch.
    """

    lambda_: float = 0.01
    learn_rate: float = 0.1
    loss: str = "LOGISTIC"
    penalty: str = "L2"
    num_dim: int = 10
    using_adagrad: bool = True
    corruption_ratio: float = 0.5
    num_corruptions: int = 1
    asymmetric: bool = False
    user_factor: bool = True
    linear: bool = False
    num_neg: int = 5
    scaled: bool = True
    beta: float = 0.0
    linear_function: bool = False
    tanh: bool = False
    batch_size: int = 128
    bucket_by_length: bool = True
    use_pallas: Optional[bool] = None  # hand-written kernels; None = on CUDA
    compute_dtype: Any = None  # matmul operand dtype (sums stay f32); None =
    # dtype
    stream_batches: Optional[bool] = None  # None = auto when U*max_len > 2e8
    cache_device_batches: bool = True  # sparse training
    fast_rng: Optional[bool] = None  # hash masks (hw_uniform) for the dense
    # step; None = on CUDA
    dense_mode: Optional[bool] = None  # int8 (U, I) dense_R; None = auto
    fused_step: Optional[bool] = None  # the fused step kernel (B4); None =
    # off, as in cdae_tpu
    neg_pool: Optional[int] = None  # sparse training: pooled negatives
    row_update: Optional[bool] = None  # sparse training: touched rows only
    packed_io: Optional[bool] = None  # sparse training: sum order
    dtype: Any = torch.float32


# batch_topk defers to the evaluator's (B, I) dense-scores pipeline below
# this many score cells; above it the blockwise paths take over (tests
# lower this to drive the huge-catalog modes at fixture scale)
_TOPK_DEFER_CELLS = 200_000_000
# hw_randint salts of the sparse step's integer draws (its uniforms are
# hw_uniform draws 0, the corruption, and 1, the pool selection)
_NEG_SALT = 0x5EED0001
_POOL_SALT = 0x5EED0002


class CDAEState(ModelState):
    """CDAE parameters + data views; ``aux`` holds the CSR view, the
    ``Collectives`` of the state's mesh (``coll``) and, in dense mode, the
    int8 (U, I) interaction matrix ``dense_R`` -- a sharded rank's block of
    it as ``dense_R_block`` (without either training takes the sparse step,
    whose cached batches are ``device_batches``)."""


def _resident_R(state: CDAEState) -> Optional[torch.Tensor]:
    """The state's dense_R (or this rank's block of it), None in sparse
    mode."""
    aux = state.aux
    return aux["dense_R"] if "dense_R" in aux else aux.get("dense_R_block")


def _activation(h: torch.Tensor, linear: bool, tanh: bool) -> torch.Tensor:
    """Hidden activation with the reference's clamps."""
    if linear:
        return h
    if tanh:
        t = torch.tanh(h)
        return torch.where(h > 9.0, 1.0, torch.where(h < -9.0, -1.0, t))
    s = torch.sigmoid(h)
    return torch.where(h > 18.0, 1.0, torch.where(h < -18.0, 0.0, s))


class CDAE(RecsysModel):
    name = "CDAE"

    def __init__(self, config: Optional[CDAEConfig] = None,
                 device="cuda", **kw):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else CDAEConfig(**kw)
        on_cuda = self.device.type == "cuda"
        if self.cfg.use_pallas is None:
            self.cfg = dataclasses.replace(self.cfg, use_pallas=on_cuda)
        if self.cfg.fast_rng is None:
            self.cfg = dataclasses.replace(self.cfg, fast_rng=on_cuda)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)

    # ------------------------------------------------------------- reset ----
    @phase("cdae.reset")
    def reset(self, data: Interactions, seed: int = 0) -> CDAEState:
        cfg = self.cfg
        U, I, D = data.num_users, data.num_items, cfg.num_dim
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = 4.0 * float(np.sqrt(6.0 / float(I + D)))
        dt, at = cfg.dtype, torch.float32

        def uniform(shape):
            u = torch.rand(shape, generator=gen, dtype=at, device=dev)
            return (u * (2.0 * s) - s).to(dt)

        def acc(shape):
            return torch.full(shape, ADAGRAD_INIT, dtype=at, device=dev)

        params: Dict[str, torch.Tensor] = {
            "W": uniform((I, D)),
            "W_ag": acc((I, D)),
            "b": torch.zeros((D,), dtype=dt, device=dev),
            "b_ag": acc((D,)),
            "b_prime": torch.zeros((I,), dtype=dt, device=dev),
            "b_prime_ag": acc((I,)),
        }
        if cfg.asymmetric:
            params["V"] = uniform((I, D))
            params["V_ag"] = acc((I, D))
        if cfg.user_factor:
            params["Wu"] = uniform((U, D))
            params["Wu_ag"] = acc((U, D))
        if cfg.linear_function:
            params["Uu"] = torch.ones((U, D), dtype=dt, device=dev)
            params["Uu_ag"] = acc((U, D))
        csr = data.csr()
        stream = cfg.stream_batches
        if stream is None:
            max_len = int(csr.row_lengths().max()) if len(csr.indices) else 1
            stream = U * max_len > 200_000_000  # full padding would blow RAM
        state = CDAEState(
            params=params,
            padded=None if stream else data.padded(),
            num_users=U,
            num_items=I,
        )
        state.aux["csr"] = csr
        # the collectives every step, loss and encode of this state calls:
        # a sharded rank's, or a 1 x 1 mesh's, which return their input
        state.aux["coll"] = self._collectives(U, I)
        dense = cfg.dense_mode
        if dense is None:
            dense = dense_fits(U, I, cfg.batch_size)
        if dense:
            with phase("cdae.dense_R"):
                state.aux["dense_R"] = self._dense_R(data)
        return state

    # ------------------------------------------------------------- train ----
    def _dense_batches(self, state: CDAEState):
        """Dense-mode batches: (k, B) uid and weight tensors on the device;
        the last batch wraps around to uid 0 with weight 0."""
        if "dense_batches" not in state.aux:
            with phase("cdae.batches"):
                U = state.num_users
                B = self.cfg.batch_size
                k = max(-(-U // B), 1)
                uids = np.arange(k * B, dtype=np.int64) % max(U, 1)
                weight = (np.arange(k * B) < U).astype(np.float32)
                state.aux["dense_batches"] = (
                    self._tensor(uids.reshape(k, B)),
                    self._tensor(weight.reshape(k, B)),
                )
        return state.aux["dense_batches"]

    def _device_batches(self, state: CDAEState):
        """The sparse step's batches, (uids, items, mask, lengths, weight)
        tensors on the device in ``_host_batches`` order: built once and
        kept in ``aux`` (the data do not change between epochs), or anew
        for each pass with ``cache_device_batches=False``."""
        if "device_batches" in state.aux:
            return state.aux["device_batches"]
        batches = (
            (self._tensor(b.uids, torch.long), self._tensor(b.items,
                                                            torch.long),
             self._tensor(b.mask), self._tensor(b.lengths, torch.long),
             self._tensor(b.weight))
            for b in self._host_batches(state))
        if not self.cfg.cache_device_batches:
            return batches
        with phase("cdae.batches"):
            state.aux["device_batches"] = list(batches)
        return state.aux["device_batches"]

    def _epoch(self, state: CDAEState, seed: int, draws,
               by_shape: bool) -> None:
        """One epoch, ``num_corruptions`` steps a batch, with step seeds
        from (``seed``, ``state.step``, batch index, corruption): the dense
        step over the dense batches, else the sparse step over the batches
        in host order or, ``by_shape``, grouped by ascending (B, L) shape
        with the host order kept within a group; ``draws`` (optional)
        yields each step's injected draws in turn."""
        R = _resident_R(state)
        kw = dict(cfg=self.cfg, loss=self.loss, coll=state.aux["coll"])
        with span("cdae.epoch"):
            if R is None:
                step = functools.partial(_train_step, state.params, **kw)
                steps = enumerate(self._device_batches(state))
                if by_shape:
                    steps = sorted(steps, key=lambda jb: tuple(jb[1][1].shape))
            else:
                step = functools.partial(_dense_train_step, state.params, R,
                                         **kw)
                steps = enumerate(zip(*self._dense_batches(state)))
            for j, batch in steps:
                for c in range(self.cfg.num_corruptions):
                    with span("cdae.step"):
                        step(*batch, step_seed(seed, state.step, j, c),
                             **(next(draws) if draws is not None else {}))
        state.step += 1

    def train_one_iteration(self, state: CDAEState, seed: int = 0,
                            draws=None) -> CDAEState:
        """One epoch over every user, the batches in their host order
        (cdae_tpu's). ``draws`` (optional): an iterator of each step's
        draws as the step's keywords."""
        self._epoch(state, seed, draws, by_shape=False)
        return state

    def train_epochs(self, state: CDAEState, num_epochs: int, seed: int = 0,
                     draws=None) -> CDAEState:
        """``num_epochs`` epochs, updating ``state.params`` in place. The
        sparse step visits the batches as cdae_tpu's fused epochs do:
        grouped by shape in ascending (B, L), the host order within a
        group. ``draws``: as in ``train_one_iteration``."""
        for _ in range(num_epochs):
            self._epoch(state, seed, draws, by_shape=True)
        return state

    # -------------------------------------------------------------- loss ----
    def data_loss(self, state: CDAEState, sample_size: int = 0,
                  uniforms=None) -> float:
        """Reconstruction loss over the positives under fresh corruption,
        summed over users. ``sample_size`` is accepted and ignored, as in
        cdae_tpu. ``uniforms[j][c]`` (optional) are the corruption uniforms
        of batch j, corruption c -- (B, I) in dense mode, (B, L) over the
        sparse batches; by default they are drawn from seeds of
        (``state.step``, batch, corruption). On a mesh each rank sums its
        rows and blocks, and the total is the mesh's."""
        R = _resident_R(state)
        sparse = R is None
        batches = (self._device_batches(state) if sparse
                   else zip(*self._dense_batches(state)))
        total = 0.0
        for j, batch in enumerate(batches):
            kw = dict(cfg=self.cfg, loss=self.loss, coll=state.aux["coll"],
                      uniforms=None if uniforms is None else uniforms[j])
            seed = step_seed(_LOSS_STREAM, state.step, j, 0)
            if sparse:
                uids, items, mask, _, weight = batch
                loss = _data_loss_batch(state.params, uids, items, mask,
                                        weight, seed, **kw)
            else:
                loss = _dense_data_loss(state.params, R, *batch, seed, **kw)
            total += float(loss)
        return total

    def penalty_loss(self, state: CDAEState) -> float:
        """0.5*lambda*(|W| + |V| + |Wu| + |b| + |b'|) under the penalty's
        norm (Uu is exempt)."""
        p = state.params
        pen = self.penalty.evaluate
        total = pen(p["W"]) + pen(p["b"]) + pen(p["b_prime"])
        if "V" in p:
            total = total + pen(p["V"])
        if "Wu" in p:
            total = total + pen(p["Wu"])
        return float(0.5 * self.cfg.lambda_ * total)

    def _host_batches(self, state: CDAEState):
        cfg = self.cfg
        if state.padded is not None:
            return iter_user_batches(
                state.padded, cfg.batch_size,
                bucket_by_length=cfg.bucket_by_length,
            )
        return iter_user_batches_csr(
            state.aux["csr"], state.num_items, cfg.batch_size,
            bucket_by_length=cfg.bucket_by_length,
        )

    # ----------------------------------------------------------- scoring ----
    def batch_scores(self, state: CDAEState, uids, rated_items, rated_mask):
        """(B, I) full-catalog decode for the given users from their
        uncorrupted input; with dense_R resident the encode is a (B, I) x
        (I, D) matmul instead of a padded gather-sum. On a mesh (B dividing
        over 'data') each rank decodes its (B / n_data, I / n_model) block
        and every rank gets the whole (B, I)."""
        coll = state.aux["coll"]
        z = _serve_hidden(state.params, self._tensor(uids, torch.long),
                          self._tensor(rated_items), self._tensor(rated_mask),
                          cfg=self.cfg, coll=coll, dense_R=_resident_R(state))
        return coll.data_gather(coll.model_gather(
            _decode(state.params, z, self.cfg), dim=1))

    def batch_topk(self, state: CDAEState, uids, rated_items, rated_mask,
                   k: int = 10):
        """Top-k unrated ids (B, k) for huge catalogs, or None when
        B * num_items <= _TOPK_DEFER_CELLS or k is outside [1, _MAX_K] (the
        caller then scores the full (B, I) slab). Modes: 'fused_dense'
        (kernel reads dense_R rows), 'fused_csr' (kernel walks the sorted
        rated rows), 'streaming' (plain blockwise loop, when the kernels are
        off). The encode runs in span ``serve.scores``, the top-k in
        ``serve.topk``, as ``recommend``'s slab route names its halves."""
        B = len(uids)
        if B * state.num_items <= _TOPK_DEFER_CELLS or not 1 <= k <= _MAX_K:
            return None
        mode = ("fused_dense" if self.cfg.use_pallas and "dense_R" in state.aux
                else "fused_csr" if self.cfg.use_pallas
                else "streaming")
        uids = self._tensor(uids, torch.long)
        rated_items = self._tensor(rated_items)
        with span("serve.scores"):
            z = _serve_hidden(state.params, uids, rated_items,
                              self._tensor(rated_mask), cfg=self.cfg,
                              coll=state.aux["coll"])
        with span("serve.topk"):
            return _topk_from_hidden(
                z, state.params, uids, rated_items,
                state.aux.get("dense_R") if mode == "fused_dense" else None,
                cfg=self.cfg, mode=mode, k=k)

    def user_representations(self, state: CDAEState) -> np.ndarray:
        """Hidden codes for all users, in uid order."""
        out = np.zeros((state.num_users, self.cfg.num_dim), dtype=np.float32)
        for batch in self._host_batches(state):
            z = _hidden(
                state.params,
                self._tensor(batch.uids, torch.long),
                self._tensor(batch.items),
                self._tensor(batch.mask),
                1.0,
                self.cfg,
            )
            real = batch.weight > 0
            out[batch.uids[real]] = z.cpu().numpy()[real]
        return out

    def _user_rows(self, state: CDAEState, users_np: np.ndarray):
        """(B, L) rated rows + mask for specific users (padded or CSR)."""
        if state.padded is not None:
            pb = state.padded
            return pb.items[users_np], pb.mask[users_np]
        items, _, mask, _ = rows_from_csr(state.aux["csr"], users_np,
                                          state.num_items)
        return items, mask

    def predict(self, state: CDAEState, users, items):
        users_np = np.asarray(users)
        rated_items, rated_mask = self._user_rows(state, users_np)
        z = _hidden(
            state.params,
            self._tensor(users_np, torch.long),
            self._tensor(rated_items),
            self._tensor(rated_mask),
            1.0,
            self.cfg,
        )
        p = state.params
        dec = p["V"] if self.cfg.asymmetric else p["W"]
        items = self._tensor(items, torch.long)
        return (dec[items] * z).sum(dim=-1) + p["b_prime"][items]


# ============================================================ functions ====

def _cdt(cfg: CDAEConfig):
    return cfg.compute_dtype or cfg.dtype


def _operand(x: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """``x`` rounded to the compute dtype and held in f32: a matmul of two
    such operands has compute-dtype inputs and f32 sums, as cdae_tpu's
    ``preferred_element_type=float32`` einsums do."""
    return x.to(_cdt(cfg)).to(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """a @ b with operands in the compute dtype and f32 accumulation (a
    bf16 @ bf16 in torch would round the sums to bf16 too)."""
    return _operand(a, cfg) @ _operand(b, cfg)


def _hidden(params, uids, items, keep_mask, scale, cfg: CDAEConfig,
            rows: Optional[torch.Tensor] = None,
            user_rows=None) -> torch.Tensor:
    """z = act(scale * sum W_i (* Uu) + b (+ Wu)) over a padded (B, L)
    item block; ``keep_mask`` selects the live entries. ``rows``
    (optional): W[clip(items)], gathered already (the sparse step gathers
    them once for the encoder, the tied decoder and the input gradients).
    ``user_rows`` (optional): the batch's Uu / Wu rows by name, gathered
    already (a sharded step gathers them from their blocks)."""
    W = params["W"]
    if rows is None:
        rows = W[items.long().clamp(0, W.shape[0] - 1)]  # (B, L, D)
    if user_rows is None:
        user_rows = {n: params[n][uids] for n in ("Uu", "Wu") if n in params}
    h = torch.einsum("bld,bl->bd", _operand(rows, cfg),
                     _operand(keep_mask, cfg))
    return _finish_hidden(h.to(W.dtype) * scale, params, user_rows, cfg)


def _finish_hidden(h, params, user_rows, cfg: CDAEConfig) -> torch.Tensor:
    """The encoder's tail from the scaled input sum ``h`` (B, D): act((Uu
    *) h + b (+ Wu)), with ``user_rows`` the batch's Uu / Wu rows by
    name."""
    if cfg.linear_function:
        h = user_rows["Uu"] * h
    h = h + params["b"][None, :]
    if cfg.user_factor:
        h = h + user_rows["Wu"]
    return _activation(h, cfg.linear, cfg.tanh)


def _decode(params, z, cfg: CDAEConfig) -> torch.Tensor:
    """(B, I) scores from hidden codes: the decode kernel when the kernels
    are on, else the plain matmul in the compute dtype."""
    table = params["V"] if cfg.asymmetric else params["W"]
    if cfg.use_pallas:
        return decode_scores(z, table, params["b_prime"])
    return _mm(z, table.t(), cfg) + params["b_prime"][None, :]


def _serve_hidden(params, uids, rated_items, rated_mask, *,
                  cfg: CDAEConfig, coll: Collectives,
                  dense_R: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B / n_data, D) hidden codes of this rank's rows ``coll.rows(B)`` of
    a batch of users (``uids`` whole), from their uncorrupted input at
    scale 1 (an empty input when corruption_ratio == 1): a gather-sum of
    the padded rated rows (item rows gathered from their owners) or, with
    ``dense_R`` (its rank's block), a dense encode of its rows summed over
    'model'."""
    sl = coll.rows(uids.shape[0])
    user_rows = {n: coll.gather_users(params[n], uids)[sl]
                 for n in ("Uu", "Wu") if n in params}
    off = cfg.corruption_ratio == 1.0
    if dense_R is not None:
        dt = params["W"].dtype
        rows = coll.batch_rows(dense_R, uids).to(dt)
        if off:
            rows = torch.zeros_like(rows)
        h = coll.model_sum(_mm(rows, params["W"], cfg).to(dt))
        return _finish_hidden(h, params, user_rows, cfg)
    items = rated_items[sl].long()
    mask = torch.zeros_like(rated_mask[sl]) if off else rated_mask[sl]
    rows = coll.gather_items(params["W"], items.clamp(0, coll.num_items - 1))
    return _hidden(params, uids[sl], items, mask, 1.0, cfg, rows=rows,
                   user_rows=user_rows)


def _topk_from_hidden(z, params, uids, rated_items, dense_R, *,
                      cfg: CDAEConfig, mode: str, k: int) -> torch.Tensor:
    """Blockwise decode/top-k of hidden codes ``z`` -> (B, k) ids.
    ``mode``: 'fused_dense' (kernel masks from dense_R[uids] int8 rows),
    'fused_csr' (kernel masks from the sorted padded rated rows),
    'streaming' (plain blockwise loop)."""
    table = params["V"] if cfg.asymmetric else params["W"]
    bp = params["b_prime"]
    if mode == "streaming":
        ids, _ = streaming_topk_scores(z, table, bp, rated_items, k=k)
    elif mode == "fused_dense":
        ids, _ = fused_topk_scores(z, table, bp, dense_R[uids], k=k)
    else:
        # w=64: the batches cdae_tpu's per-block query lists cannot hold
        # (more than 64 rated items in one catalog block) are the ones it
        # answers with its streaming scan; the tail convention follows
        ids, _ = fused_topk_scores_csr(z, table, bp, rated_items.int(),
                                       k=k, w=64)
    return ids


# ============================================================ training ====

def _draw_uniforms(seed: int, shape, draws, cfg: CDAEConfig, device,
                   block):
    """(B, I) f32 uniforms of one step seed, one per entry of ``draws``:
    ``hw_uniform(seed, shape, draw)`` with ``fast_rng`` (its kernel when
    ``use_pallas`` is on), else successive ``torch.rand`` draws of a
    generator seeded with ``seed``. ``block`` = (row offset, column
    offset, whole shape): ``shape`` is that block of the whole draw (a
    rank's): B1 draws the block alone, a generator the whole shape, then
    the block is cut out."""
    r0, c0, full = block
    if cfg.fast_rng:
        fn = hw_uniform if cfg.use_pallas else hw_uniform_plain
        return [fn(seed, shape, d, device=device, row_offset=r0,
                   col_offset=c0) for d in draws]
    gen = torch.Generator(device=device).manual_seed(seed & _MASK32)
    return [torch.rand(full, generator=gen, device=device)[
        r0:r0 + shape[0], c0:c0 + shape[1]] for _ in draws]


def _z_one_minus_z(z: torch.Tensor, cfg: CDAEConfig) -> torch.Tensor:
    """Activation derivative factor in terms of the activation z."""
    if cfg.linear:
        return torch.ones_like(z)
    if cfg.tanh:
        return 1.0 - z * z
    return z - z * z


def _neg_probability(lengths: torch.Tensor, I: int, cfg: CDAEConfig
                     ) -> torch.Tensor:
    """Per-user Bernoulli probability of an unrated item becoming a
    negative: num_neg * |O_u| expected negatives over the I - |O_u|
    unrated items, clamped to [0, 1]."""
    return torch.clamp(
        cfg.num_neg * lengths / torch.clamp(I - lengths, min=1.0), 0.0, 1.0
    )


def _fused_step_supported(cfg: CDAEConfig) -> bool:
    """What cdae_dense_step_fused covers: tied decoder, no Uu gate, f32."""
    return (
        not cfg.asymmetric
        and not cfg.linear_function
        and _cdt(cfg) == torch.float32
        and cfg.dtype == torch.float32
    )


def _use_fused_step(cfg: CDAEConfig) -> bool:
    """fused_step=None stays off, as in cdae_tpu: its TPU measurement said
    so, and the port's own comparison is recorded in PERF.md; changing the
    default is a later measurement's call."""
    if cfg.fused_step is None:
        return False
    if cfg.fused_step and not _fused_step_supported(cfg):
        import warnings

        warnings.warn(
            "CDAEConfig.fused_step=True but the fused kernel does not "
            "support this config (requires asymmetric=False, "
            "linear_function=False, f32 dtype/compute_dtype) -- running the "
            "unfused dense step instead. Timings will measure that path, "
            "not the fused kernel.",
            UserWarning,
            stacklevel=3,
        )
    return bool(cfg.fused_step) and _fused_step_supported(cfg)


def _dense_train_step_fused(params, dense_R, uids, weight, seed: int, *,
                            cfg: CDAEConfig, loss: Loss):
    """The dense step through cdae_dense_step_fused (its kernels when
    ``use_pallas`` is on, else its plain version): W, W_ag, b', b'_ag in
    the fused step, then b and Wu from the returned hidden gradient, as the
    unfused step does. The masks are the hash draws of ``seed``."""
    W = params["W"]
    I = W.shape[0]
    lam, lr, beta = cfg.lambda_, cfg.learn_rate, cfg.beta
    rows_int8 = dense_R[uids]  # (B, I)
    w_user = weight.to(torch.float32)
    lengths = rows_int8.sum(dim=1, dtype=torch.int32).to(torch.float32) \
        * w_user
    p_neg = _neg_probability(lengths, I, cfg)
    h_bias = params["b"][None, :].expand(uids.shape[0], -1)
    if cfg.user_factor:
        h_bias = h_bias + params["Wu"][uids]
    act = "linear" if cfg.linear else ("tanh" if cfg.tanh else "sigmoid")
    fused = (cdae_dense_step_fused if cfg.use_pallas
             else cdae_dense_step_fused_plain)
    *_, hg = fused(
        seed, rows_int8, w_user, p_neg, h_bias.contiguous(), W,
        params["W_ag"], params["b_prime"], params["b_prime_ag"],
        q=cfg.corruption_ratio,
        scale=input_scale(cfg.corruption_ratio, cfg.scaled),
        lam=lam, lr=lr, beta=beta, use_ada=cfg.using_adagrad, act=act,
        loss_name=cfg.loss,
    )
    d_b = w_user @ hg + w_user.sum() * lam * params["b"]
    dense_adagrad_step(params["b"], params["b_ag"], d_b, lr, beta,
                       cfg.using_adagrad, use_kernel=bool(cfg.use_pallas))
    if cfg.user_factor:
        row_adagrad_delta(
            params["Wu"], params["Wu_ag"], uids,
            (hg + lam * params["Wu"][uids]) * w_user[:, None],
            w_user[:, None] > 0, lr, beta, cfg.using_adagrad,
        )
    return params


def _dense_train_step(
    params: Dict[str, torch.Tensor],
    dense_R: torch.Tensor,  # (U, I) int8 interaction matrix
    uids: torch.Tensor,  # (B,) long
    weight: torch.Tensor,  # (B,) 0/1
    seed: int,  # the step seed (step_seed)
    *,
    cfg: CDAEConfig,
    loss: Loss,
    coll: Collectives,
    u_corrupt: Optional[torch.Tensor] = None,  # (B, I) f32 uniforms
    u_neg: Optional[torch.Tensor] = None,  # (B, I) f32 uniforms
) -> Dict[str, torch.Tensor]:
    """One full-catalog dense minibatch step: corrupt, encode ((B, I) x
    (I, D)), activate, draw Bernoulli negatives (expected count
    num_neg*|O_u| per user), decode, loss gradient, table gradients, then
    AdaGrad. Updates ``params`` IN PLACE (W, b', b, V in one
    dense_adagrad_steps sweep -- one launch of the adagrad_update kernel
    when ``use_pallas`` is on -- and the Wu / Uu rows) and returns it.

    ``u_corrupt`` / ``u_neg`` inject the corruption and negative uniforms;
    when absent they are drawn from ``seed`` (``_draw_uniforms``). With
    ``compute_dtype`` bf16 the (B, I) slabs live in bf16, as in cdae_tpu:
    the 0/1 masks are exact, and the loss-gradient slab rounds.

    ``coll`` (parallel/mesh.py ``Collectives``) places the step on its
    rank of the mesh: ``uids`` / ``weight`` are the whole batch, of which
    the step takes its rows (``coll.rows``); ``dense_R`` is the rank's
    (user, item) block (``coll.batch_rows`` reads it), the item tables its
    item block, Wu / Uu its user block. The encode's partial
    pre-activation, the row lengths and the back-propagated hidden
    gradient are summed over 'model', every dense gradient over 'data'
    before the one B2 launch; the user rows are gathered from and updated
    on their owners. Draws are the block of the whole step's (B1 at the
    block's offsets). Injected uniforms are the block's. On one process
    every block is whole and every collective returns its input."""
    if _use_fused_step(cfg):
        return _dense_train_step_fused(params, dense_R, uids, weight, seed,
                                       cfg=cfg, loss=loss)
    W = params["W"]
    dt = W.dtype
    sdt = _cdt(cfg)
    f32 = torch.float32
    lam, lr, beta = cfg.lambda_, cfg.learn_rate, cfg.beta
    use_kernel = bool(cfg.use_pallas)
    uids_all, weight_all = uids, weight
    sl = coll.rows(uids.shape[0])
    uids, weight = uids[sl], weight[sl]
    block = (sl.start, coll.col_offset, (uids_all.shape[0], coll.num_items))
    I = coll.num_items  # the negatives' rate is the whole catalog's

    w_user = weight.to(sdt)
    rows = coll.batch_rows(dense_R, uids_all).to(sdt) * w_user[:, None]
    # counts exceed bf16's exact-integer range -- accumulate f32; whole
    # counts summed over 'model': exact
    lengths = coll.model_sum(rows.sum(dim=1, dtype=f32).to(dt))
    shape = tuple(rows.shape)
    q = cfg.corruption_ratio
    need = [0] if q > 0.0 and u_corrupt is None else []  # draw 0: corruption
    if u_neg is None:
        need.append(1)  # draw 1: negatives
    with span("cdae.step.draws"):
        drawn = dict(zip(need, _draw_uniforms(seed, shape, need, cfg, W.device,
                                              block)))
    u_corrupt = drawn.get(0, u_corrupt)
    u_neg = drawn.get(1, u_neg)

    with span("cdae.step.forward"):
        kept = rows * (u_corrupt > q).to(sdt) if q > 0.0 else rows
        scale = input_scale(q, cfg.scaled)

        h = coll.model_sum(_mm(kept, W, cfg).to(dt))
        urows = {n: coll.gather_users(params[n], uids_all)[sl]
                 for n in ("Uu", "Wu") if n in params}
        uu_rows, wu_rows = urows.get("Uu"), urows.get("Wu")
        z = _finish_hidden(h * scale, params, urows, cfg)
        dz = _z_one_minus_z(z, cfg)

        p_neg = _neg_probability(lengths, I, cfg).to(sdt)
        neg_sel = ((1.0 - rows) * (u_neg < p_neg[:, None]).to(sdt)
                   * w_user[:, None])
        w_mat = rows + neg_sel  # per-(user, item) touch counts (0/1 -- exact)

        table = params["V"] if cfg.asymmetric else W
        pred = _mm(z, table.t(), cfg) + params["b_prime"].to(f32)[None, :]
        # truth IS the 0/1 row: one gradient evaluation covers positives and
        # negatives; g is stored in the slab dtype
        g = (loss.gradient(pred, rows.to(f32)) * w_mat.to(f32)).to(sdt)

        touches = w_mat.sum(dim=0, dtype=f32).to(dt)  # (I,)
        d_bp = (g.sum(dim=0, dtype=f32).to(dt)
                + lam * touches * params["b_prime"])
        hg = coll.model_sum(_mm(g, table, cfg).to(dt)) * dz

        base = (uu_rows * hg if cfg.linear_function else hg) * scale
        if cfg.asymmetric:
            # decoder touches update V; kept inputs update W with base + lam*W
            d_V = _mm(g.t(), z, cfg).to(dt) + lam * touches[:, None] * table
            d_W = _mm(kept.t(), base, cfg).to(dt) + lam * kept.sum(
                dim=0, dtype=f32).to(dt)[:, None] * W
        else:
            # every touch contributes g*z, kept inputs add the base term,
            # lambda once per touch
            d_W = (_mm(g.t(), z, cfg).to(dt) + _mm(kept.t(), base, cfg).to(dt)
                   + lam * touches[:, None] * W)
        # Uu's gradient needs the pre-update W: take it before the sweep
        sum_kept_W = (coll.model_sum(_mm(kept, W, cfg).to(dt))
                      if cfg.linear_function else None)
        dense = {"W": d_W, "b_prime": d_bp}
        if cfg.asymmetric:
            dense["V"] = d_V
        dense["b"] = w_user.to(f32) @ hg + w_user.sum() * lam * params["b"]
        dense = coll.data_sum_all(dense)
    with span("cdae.step.update"):
        # every dense grad is taken: one sweep (one kernel launch) for them
        # all
        dense_adagrad_steps(
            [(params[name], params[name + "_ag"], g)
             for name, g in dense.items()],
            lr, beta, cfg.using_adagrad, use_kernel)
        _user_row_steps(
            params, cfg, coll, uids_all, weight_all, {
                "Wu": (lambda: (hg + lam * wu_rows) * w_user[:, None])
                if cfg.user_factor else None,
                "Uu": (lambda: (lam * uu_rows + hg * sum_kept_W)
                       * w_user[:, None])
                if cfg.linear_function else None,
            })
    return params


def _user_row_steps(params, cfg: CDAEConfig, coll: Collectives, uids_all,
                    weight_all, grads) -> None:
    """Per-user-row AdaGrad of Wu, then Uu (``grads``: name -> a function
    giving this rank's batch rows' gradient, or None), by the
    duplicate-safe delta-add: the rows' gradients gathered over 'data',
    each rank updating the rows of its user block."""
    for name in ("Wu", "Uu"):
        fn = grads.get(name)
        if fn is not None:
            rows, live = coll.own_rows(uids_all, weight_all > 0)
            row_adagrad_delta(params[name], params[name + "_ag"], rows,
                              coll.data_gather(fn()), live[:, None],
                              cfg.learn_rate, cfg.beta, cfg.using_adagrad)


def _dense_data_loss(params, dense_R, uids, weight, seed: int, *,
                     cfg: CDAEConfig, loss: Loss, coll: Collectives,
                     uniforms=None) -> torch.Tensor:
    """Dense-mode reconstruction loss over the positives, averaged over
    ``num_corruptions`` corruptions. ``uniforms[c]`` (optional) is the
    (B, I) corruption draw of corruption c; otherwise draw c of ``seed``.
    ``coll``: this rank's part of the loss, as in ``_dense_train_step``
    (the encode summed over 'model', the loss over both axes; injected
    uniforms are the rank's block)."""
    W = params["W"]
    dt = W.dtype
    uids_all = uids
    sl = coll.rows(uids.shape[0])
    w_user = weight[sl].to(dt)
    rows = coll.batch_rows(dense_R, uids_all).to(dt) * w_user[:, None]
    block = (sl.start, coll.col_offset, (uids_all.shape[0], coll.num_items))
    q = cfg.corruption_ratio
    ncorr = cfg.num_corruptions
    if uniforms is None and q > 0.0:
        uniforms = _draw_uniforms(seed, tuple(rows.shape), range(ncorr), cfg,
                                  W.device, block)
    scale = input_scale(q, cfg.scaled)
    table = params["V"] if cfg.asymmetric else W
    urows = {n: coll.gather_users(params[n], uids_all)[sl]
             for n in ("Uu", "Wu") if n in params}
    total = torch.zeros((), dtype=torch.float32, device=W.device)
    for c in range(ncorr):
        kept = rows * (uniforms[c] > q).to(dt) if q > 0.0 else rows
        h = coll.model_sum(_mm(kept, W, cfg).to(dt))
        z = _finish_hidden(h * scale, params, urows, cfg)
        pred = _mm(z, table.t(), cfg).to(dt) + params["b_prime"][None, :]
        total = total + torch.sum(loss.evaluate(pred, 1.0) * rows)
    return coll.data_sum(coll.model_sum(total)) / ncorr


# ======================================================== sparse training ===

def _scatter_mode(cfg: CDAEConfig) -> str:
    """The sparse step's row aggregations: ``pallas`` -- kernel B8 on the
    card, its plain version on the CPU -- with ``use_pallas``, else
    ``scatter``, one ``index_add_``. Both sum in ascending position on the
    CPU; only B8 sums in a fixed order on the card."""
    return "pallas" if cfg.use_pallas else "scatter"


def _decode_at(params, z, item_ids, cfg: CDAEConfig, coll: Collectives):
    """(predictions, decoder rows) of the given item ids: y_o = (V|W)_o . z
    + b'_o over (B, N) ids, clipped into the catalog, the rows gathered
    from their owners' item blocks."""
    table = params["V"] if cfg.asymmetric else params["W"]
    ids = item_ids.clamp(0, coll.num_items - 1)
    rows = coll.gather_items(table, ids)  # (B, N, D)
    bp = coll.gather_items(params["b_prime"], ids)
    preds = torch.einsum("bnd,bd->bn", _operand(rows, cfg),
                         _operand(z, cfg)).to(table.dtype)
    return preds + bp, rows


def _sparse_draws(seed: int, items, lengths, I: int, cfg: CDAEConfig,
                  rows: slice, B_all: int):
    """The sparse step's draws from its seed, as ``_train_step`` keywords:
    the (B, L) corruption uniforms ``u_keep``, then the exact negatives
    ``neg`` (B, num_neg * L) or the pool ids ``pool`` (K,) with their
    (B, K) selection uniforms ``u_sel``. With ``fast_rng`` the uniforms are
    hw_uniform draws 0 and 1 of the seed and the ids hw_randint draws with
    their own salts (kernel B1 with ``use_pallas``); otherwise a generator
    seeded with the seed draws them in that order. ``rows``: this rank's
    block of a batch of ``B_all`` rows (``items`` and ``lengths`` are the
    block's), whose draws are the block of the whole batch's -- B1 draws
    at the block's row offset, a generator draws the whole batch's shapes
    and the block is cut out."""
    B, L = items.shape
    dev = items.device
    q = cfg.corruption_ratio
    out = {}
    gen = None
    r0 = rows.start
    if not cfg.fast_rng:
        gen = torch.Generator(device=dev).manual_seed(int(seed) & _MASK32)
    if q > 0.0:
        out["u_keep"] = (
            _draw_uniforms(seed, (B, L), [0], cfg, dev, (r0, 0, (B_all, L)))[0]
            if cfg.fast_rng else
            torch.rand((B_all, L), generator=gen, device=dev)[rows])
    if cfg.neg_pool:
        K = int(cfg.neg_pool)
        if cfg.fast_rng:
            out["pool"] = hw_randint(seed, (1, K), I, salt=_POOL_SALT,
                                     device=dev,
                                     use_kernel=bool(cfg.use_pallas))[0]
            out["u_sel"] = _draw_uniforms(seed, (B, K), [1], cfg, dev,
                                          (r0, 0, (B_all, K)))[0]
        else:
            out["pool"] = torch.randint(0, I, (K,), generator=gen,
                                        device=dev)
            out["u_sel"] = torch.rand((B_all, K), generator=gen,
                                      device=dev)[rows]
    elif cfg.num_neg > 0:
        shape = (B, cfg.num_neg * L)
        free = torch.clamp(I - lengths, min=1)[:, None]
        if cfg.fast_rng:
            u = hw_randint(seed, shape, free, salt=_NEG_SALT, device=dev,
                           use_kernel=bool(cfg.use_pallas), row_offset=r0)
        else:
            r = torch.rand((B_all, shape[1]), generator=gen,
                           dtype=torch.float64, device=dev)[rows]
            u = torch.minimum((r * free).to(torch.int64), free - 1)
        out["neg"] = sample_unrated(seed, items, lengths, I, shape[1], u=u)
    return out


def _train_step(
    params: Dict[str, torch.Tensor],
    uids: torch.Tensor,  # (B,) long
    items: torch.Tensor,  # (B, L) long, ascending, padded with num_items
    mask: torch.Tensor,  # (B, L) bool
    lengths: torch.Tensor,  # (B,)
    weight: torch.Tensor,  # (B,) 0/1
    seed: int,  # the step seed (step_seed)
    *,
    cfg: CDAEConfig,
    loss: Loss,
    coll: Collectives,
    keep: Optional[torch.Tensor] = None,  # (B, L) bool corruption keep mask
    u_keep: Optional[torch.Tensor] = None,  # (B, L) its uniforms
    neg: Optional[torch.Tensor] = None,  # (B, num_neg * L) exact negatives
    pool: Optional[torch.Tensor] = None,  # (K,) pooled negative ids
    u_sel: Optional[torch.Tensor] = None,  # (B, K) pool selection uniforms
) -> Dict[str, torch.Tensor]:
    """One sparse minibatch step (cdae_tpu's ``_train_step``): the batched
    per-user corruption, encode, decode at the positives and the sampled
    negatives, loss gradients and AdaGrad. Updates ``params`` IN PLACE and
    returns it.

    Every gradient is taken from the pre-update parameters, then applied:
    W, b', V and b in one ``dense_adagrad_steps`` call (one launch of
    kernel B2 with ``use_pallas``) -- or, with ``row_update``, the touched
    W / V / b' rows in the reference's order (positive outputs, negative
    outputs, b', input rows) and b alone in B2 -- then the Wu and Uu rows.
    Each row aggregation sums over one plan per id vector (the positives,
    each negative chunk, the pool; ``_scatter_mode``), where an id of
    num_items (padding, an empty complement) contributes nothing.

    The draws come from ``seed`` (``_sparse_draws``) unless injected: the
    keep mask (``keep``, or its uniforms ``u_keep``: kept where u > q), the
    exact negatives ``neg``, or the ``pool`` ids and their selection
    uniforms ``u_sel``.

    ``coll`` (parallel/mesh.py ``Collectives``) places the step on its
    rank of the mesh: the batch arrays are the whole batch, of which the
    step takes its rows (``coll.rows``); W / V / b' are the rank's item
    blocks and Wu / Uu its user blocks. Item rows are gathered from their
    owners (``coll.gather_items``), each aggregation sums into the rank's
    own block only, the dense gradients are summed over 'data' before the
    one B2 launch, and the user rows update on their owners. The draws
    are the block's rows of the whole step's; injected draws are the
    block's. On one process every block is whole and every collective
    returns its input."""
    W = params["W"]
    n_tbl, D = W.shape  # rows of this rank's item tables
    dt = W.dtype
    lam, lr, beta = cfg.lambda_, cfg.learn_rate, cfg.beta
    q = cfg.corruption_ratio
    sm = _scatter_mode(cfg)
    use_row = bool(cfg.row_update)
    if use_row and coll.mesh.size > 1:
        # the touched-row apply writes whole rows of whole tables, in the
        # reference's order: it has no form over blocks
        raise ValueError("row_update has no sharded step")
    pack = cfg.packed_io is not False and not cfg.asymmetric and not use_row
    items = items.long()
    uids_all, weight_all = uids, weight
    sl = coll.rows(uids.shape[0])
    uids, items, mask, lengths, weight = (
        x[sl] for x in (uids, items, mask, lengths, weight))
    L, I = items.shape[1], coll.num_items
    need_keep = keep is None and u_keep is None and q > 0.0
    need_neg = ((pool is None or u_sel is None) if cfg.neg_pool
                else neg is None and cfg.num_neg > 0)
    if need_keep or need_neg:
        with span("cdae.step.draws"):
            drawn = _sparse_draws(seed, items, lengths, I, cfg, sl,
                                  uids_all.shape[0])
        u_keep = drawn.get("u_keep") if need_keep else u_keep
        if need_neg:
            neg, pool, u_sel = (drawn.get(k) for k in ("neg", "pool",
                                                        "u_sel"))

    with span("cdae.step.forward"):
        if keep is None:
            keep = mask & (u_keep > q) if q > 0.0 else mask
        live_user = weight[:, None] > 0
        keep = keep & live_user
        w_user = weight.to(dt)
        mask_f = mask.to(dt) * w_user[:, None]
        keep_f = keep.to(dt)
        items_c = items.clamp(0, I - 1)
        scale = input_scale(q, cfg.scaled)

        # ---- forward: one gather of the positives' W rows serves the
        # encoder, the tied decoder and the input-side gradients
        enc_rows = coll.gather_items(W, items_c)  # (B, L, D)
        user_rows = {n: coll.gather_users(params[n], uids_all)[sl]
                     for n in ("Uu", "Wu") if n in params}
        z = _hidden(params, uids, items, keep, scale, cfg, rows=enc_rows,
                    user_rows=user_rows)
        dz = _z_one_minus_z(z, cfg)
        bp_items = coll.gather_items(params["b_prime"], items_c)

        # ---- positives (truth 1)
        if cfg.asymmetric:
            pred_pos, dec_pos = _decode_at(params, z, items, cfg, coll)
        else:
            dec_pos = enc_rows
            pred_pos = torch.einsum("bld,bd->bl", _operand(enc_rows, cfg),
                                    _operand(z, cfg)).to(dt) \
                + bp_items
        g_pos = loss.gradient(pred_pos, 1.0) * mask_f
        bp_pos_vals = (g_pos + lam * bp_items) * mask_f
        hidden_grad = torch.einsum("bl,bld->bd", g_pos, dec_pos)

        out_name = "V" if cfg.asymmetric else "W"
        dec_table = params[out_name]
        # the negatives' id vectors -- the pool, or each (B, L) chunk of the
        # exact draws: with row_update their (ids, table grads, b' grads,
        # live) in order, else one running [table | b'] sum (I, D + 1), each
        # chunk summed as soon as it is taken (a scatter span inside this
        # forward one)
        neg_sets, neg_sum = [], None

        def add_negatives(ids, table_vals, bp_vals, live):
            nonlocal neg_sum
            if use_row:
                neg_sets.append((ids, table_vals, bp_vals, live))
                return
            with span("cdae.step.scatter"):
                neg_sum = _aggregate(coll.own_items(ids),
                                     (table_vals, bp_vals), n_tbl, sm,
                                     neg_sum)
        if cfg.neg_pool:
            with span("cdae.step.pool"):
                K = int(cfg.neg_pool)
                pool = pool.long()
                dec_pool = coll.gather_items(dec_table, pool)  # (K, D)
                bp_pool = coll.gather_items(params["b_prime"], pool)
                pred_pool = (_mm(z, dec_pool.t(), cfg).to(dt)
                             + bp_pool[None, :])
                rated = is_rated(items, lengths, pool)  # (B, K)
                L_u = lengths.to(torch.float32)
                q_u = torch.clamp(cfg.num_neg * L_u * I
                                  / (K * torch.clamp(I - L_u, min=1.0)),
                                  0.0, 1.0)
                sel = ((u_sel < q_u[:, None]) & ~rated & live_user).to(dt)
                g_pool = loss.gradient(pred_pool, 0.0) * sel
                touch = sel.sum(dim=0)  # (K,)
                bp_pool_vals = g_pool.sum(dim=0) + lam * bp_pool * touch
                table_pool_vals = (g_pool.t() @ z
                                   + lam * dec_pool * touch[:, None])
                hidden_grad = hidden_grad + g_pool @ dec_pool
                add_negatives(pool, table_pool_vals, bp_pool_vals,
                              torch.ones((K,), dtype=torch.bool,
                                         device=pool.device))
        else:
            # num_neg chunks of (B, L): one (B, L, D) gather at a time, not
            # (B, num_neg * L, D) (cdae_tpu measured a 10.5 GB temporary at
            # B=2048, L=1080, D=200 without the chunks)
            for k in range(max(cfg.num_neg, 0)):
                nk = neg[:, k * L:(k + 1) * L].long()
                pred_nk, dec_nk = _decode_at(params, z, nk, cfg, coll)
                bp_nk = coll.gather_items(params["b_prime"],
                                          nk.clamp(0, I - 1))
                # the sentinel id num_items (an empty complement) is no
                # negative: its slot carries no gradient
                nk_live = mask & (nk < I)
                g_nk = loss.gradient(pred_nk, 0.0) * nk_live.to(dt)
                bp_nk_vals = (g_nk + lam * bp_nk) * mask_f
                w_nk_vals = ((g_nk[..., None] * z[:, None, :] + lam * dec_nk)
                             * mask_f[..., None])
                hidden_grad = hidden_grad + torch.einsum("bl,bld->bd", g_nk,
                                                         dec_nk)
                add_negatives(nk, w_nk_vals, bp_nk_vals, nk_live)
        hg = hidden_grad * dz  # (B, D)

        # ---- decoder-table gradients of the positives
        gz_pos = g_pos[..., None] * z[:, None, :]
        if cfg.asymmetric:
            out_vals = (gz_pos + lam * dec_pos) * mask_f[..., None]
        else:
            # positives kept in the input defer their g.z to the input side;
            # dropped ones update W directly with g.z + lam.W_o
            direct = mask_f * (1.0 - keep_f)
            out_vals = (gz_pos + lam * dec_pos) * direct[..., None]

        # ---- input-side (encoder) gradients of the kept items
        uu_rows = user_rows.get("Uu")
        base = (uu_rows * hg if cfg.linear_function else hg) * scale
        in_grad = (base[:, None, :] + lam * enc_rows
                   + (0.0 if cfg.asymmetric else gz_pos)) * keep_f[..., None]
        # Uu's gradient reads the pre-update W rows
        sum_kept_W = (torch.einsum("bld,bl->bd", enc_rows, keep_f)
                      if cfg.linear_function else None)
        d_b = w_user.to(torch.float32) @ hg + w_user.sum() * lam * params["b"]

    if use_row:
        def row_table_step(name, ids, vals, live):
            n = ids.numel()
            vals = vals.reshape((n,) + tuple(vals.shape[ids.dim():]))
            live = live.reshape((n,) + (1,) * (vals.dim() - 1))
            if profiler_active():
                count("table_bytes", _adagrad_bytes(params, name,
                                                    vals.numel()))
            # dead slots (padding, the sentinel) add nothing to a clipped id
            row_adagrad_delta(params[name], params[name + "_ag"],
                              ids.reshape(-1).clamp(0, I - 1), vals, live,
                              lr, beta, cfg.using_adagrad, mode=sm)

        with span("cdae.step.update"):
            # the reference's order: positive outputs, negative outputs, b',
            # then the input rows
            row_table_step(out_name, items, out_vals, mask)
            for ids, table_vals, _, live in neg_sets:
                row_table_step(out_name, ids, table_vals, live)
            row_table_step("b_prime", items, bp_pos_vals, mask)
            for ids, _, bp_vals, live in neg_sets:
                row_table_step("b_prime", ids, bp_vals, live)
            row_table_step("W", items, in_grad, keep)
        dense = {"b": d_b}
    else:
        with span("cdae.step.scatter"):
            dense = _sparse_dense_grads(
                n_tbl, D, coll.own_items(items), out_vals, in_grad,
                bp_pos_vals, neg_sum, pack=pack, asymmetric=cfg.asymmetric,
                mode=sm)
        dense["b"] = d_b
    dense = coll.data_sum_all(dense)
    if profiler_active():
        count("table_bytes", sum(_adagrad_bytes(params, name, g.numel())
                                 for name, g in dense.items() if name != "b"))
    with span("cdae.step.update"):
        # every dense gradient is taken: one sweep (one kernel launch)
        dense_adagrad_steps(
            [(params[name], params[name + "_ag"], g)
             for name, g in dense.items()],
            lr, beta, cfg.using_adagrad, bool(cfg.use_pallas))
        _user_row_steps(
            params, cfg, coll, uids_all, weight_all, {
                # Wu's rows read anew for its gradient (ROADMAP, Queue 5:
                # the encoder's rows would save this gather)
                "Wu": (lambda: (hg + lam * coll.gather_users(
                    params["Wu"], uids_all)[sl]) * w_user[:, None])
                if cfg.user_factor else None,
                "Uu": (lambda: (lam * uu_rows + hg * sum_kept_W)
                       * w_user[:, None])
                if cfg.linear_function else None,
            })
    return params


def _adagrad_bytes(params, name: str, n: int) -> int:
    """Bytes an AdaGrad apply moves over ``n`` elements of table ``name``:
    each element's parameter and accumulator read and written, its f32
    gradient read (as benchmark/harness/counts.py reckons B2's)."""
    return n * (2 * params[name].element_size()
                + 2 * params[name + "_ag"].element_size() + 4)


def _aggregate(ids, cols, I: int, mode: str,
               base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base`` (default zeros) plus the values of ``cols`` (each (P, ...)
    over the P entries of ``ids``) side by side, summed at their ids into
    an (I, C) table: one ``scatter_add_rows`` over one plan of ``ids``."""
    vals = torch.cat([c.reshape(ids.numel(), -1) for c in cols], dim=1)
    if base is None:
        base = torch.zeros((I, vals.shape[1]), dtype=vals.dtype,
                           device=vals.device)
    return scatter_add_rows(base, ids, vals, mode=mode,
                            plan=row_plan(ids.reshape(-1), I, mode))


def _sparse_dense_grads(I: int, D: int, items, out_vals, in_grad,
                        bp_pos_vals, neg_sum, *, pack: bool,
                        asymmetric: bool, mode: str):
    """The (I, D) / (I,) gradient tables of the dense apply, from the
    negatives' [table | b'] sums ``neg_sum`` (or None) and the positives'
    values, summed in one aggregation over one plan of ``items``: with
    ``pack`` the output- and input-side gradients are added before it,
    else summed apart and added after (cdae_tpu's order of adds)."""
    def plus_neg(col, pos):
        return pos.contiguous() if neg_sum is None else neg_sum[:, col] + pos

    if pack:
        pos = _aggregate(items, (out_vals + in_grad, bp_pos_vals), I, mode)
        return {"W": plus_neg(slice(0, D), pos[:, :D]),
                "b_prime": plus_neg(D, pos[:, D])}
    pos = _aggregate(items, (out_vals, in_grad, bp_pos_vals), I, mode)
    grads = {"b_prime": plus_neg(D, pos[:, 2 * D])}
    if asymmetric:
        grads["W"] = pos[:, D:2 * D].contiguous()
        grads["V"] = plus_neg(slice(0, D), pos[:, :D])
    else:
        grads["W"] = plus_neg(slice(0, D), pos[:, :D]) + pos[:, D:2 * D]
    return grads


def _data_loss_batch(params, uids, items, mask, weight, seed: int, *,
                     cfg: CDAEConfig, loss: Loss, coll: Collectives,
                     uniforms=None) -> torch.Tensor:
    """Sparse-batch reconstruction loss over the positives, averaged over
    ``num_corruptions`` corruptions. ``uniforms[c]`` (optional) is the
    (B, L) corruption draw of corruption c; otherwise draw c of ``seed``.
    ``coll``: this rank's rows of the batch, the item and user rows
    gathered from their owners, the loss summed over 'data'."""
    dt = params["W"].dtype
    q = cfg.corruption_ratio
    ncorr = cfg.num_corruptions
    uids_all = uids
    sl = coll.rows(uids.shape[0])
    uids, items, mask, weight = (x[sl] for x in (uids, items, mask, weight))
    mask_f = mask.to(dt) * weight.to(dt)[:, None]
    if uniforms is None and q > 0.0:
        uniforms = _draw_uniforms(seed, tuple(mask.shape), range(ncorr), cfg,
                                  mask.device,
                                  (sl.start, 0, (uids_all.shape[0],
                                                 mask.shape[1])))
    scale = input_scale(q, cfg.scaled)
    items = items.long()
    user_rows = {n: coll.gather_users(params[n], uids_all)[sl]
                 for n in ("Uu", "Wu") if n in params}
    rows = coll.gather_items(params["W"], items.clamp(0, coll.num_items - 1))
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for c in range(ncorr):
        keep = mask & (uniforms[c] > q) if q > 0.0 else mask
        z = _hidden(params, uids, items, keep, scale, cfg, rows=rows,
                    user_rows=user_rows)
        preds, _ = _decode_at(params, z, items, cfg, coll)
        total = total + torch.sum(loss.evaluate(preds, 1.0) * mask_f)
    return coll.data_sum(total) / ncorr
