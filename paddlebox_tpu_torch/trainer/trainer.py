"""Training loop — the train_from_dataset path.

Port of ``paddlebox_tpu/trainer/trainer.py`` (≙ BoxPSTrainer::Run →
BoxPSWorker::TrainFiles, boxps_trainer.cc:282, boxps_worker.cc:1278):
pull → seqpool + CVM → model fwd/bwd → merged push → sparse optimizer
rule → dense Adam → AUC buckets, on one of four sparse lowerings:

* ``mxu``       — sorted gather / merged scatter kernels (ps/mxu_path.py);
  what ``auto`` resolves to with one device; its two crossings take the
  "take" or "sort" lowering (ops/crossing.py, FLAGS_mxu_crossing);
* ``fast``      — padded-dense, its pull the fused ``gather_pool`` kernel
  (ps/fast_path.py); adagrad only;
* ``ragged``    — CSR [U]-domain step (ps/ragged_path.py); needs the
  pass-resident feed's host-built plans;
* ``reference`` — the JAX package's exact step: a gather pull
  (``embedding.pull_sparse``), ``ops.seqpool_cvm.fused_seqpool_cvm``
  with its reference backward, and a merged push
  (``embedding.push_sparse_grads``); what ``auto`` resolves to with
  ``fast_path=False``.

``amp=True`` runs the whole model in bfloat16 on every lowering: each
step casts every parameter and input to bf16 and the logits back to f32
(the JAX package's ``strategy.amp``); the loss, the sigmoid, the dense
optimizer and the master weights stay f32.

Two entry points: ``train_pass(dataset)`` packs batches on host threads
through a bounded Channel while the device trains (≙ PackBatchTask,
boxps_worker.cc:1259); ``train_pass(build_pass_feed(dataset))`` packs the
whole pass once, keeps it on the device with its per-batch plans, and
the loop indexes batch i (≙ SlotPaddleBoxDataFeed's whole-pass pack,
data_feed.h:2036).

Models that declare ``extra_inputs`` (``RankAttentionCTR``'s
``rank_offset``, an InputTable slot's index plane) get those feed planes
as keyword arguments on every lowering; ``uid_slot`` adds the per-user
AUC (uauc / wuauc), accumulated on the host from each batch's preds.

An expand ("NNCross", ``mf_ex``) table trains on ``mxu`` (what ``auto``
resolves to): its columns follow mf in the pull table and the push
payload, and the pooled output is [B, S, 3 + D + Dex].  Explicit
``fast`` and ``reference`` train the base columns and carry ``mf_ex``
through; ``ragged`` refuses it, as in the JAX package.

``TrainerConfig(dense_sync_mode="async_table")`` moves the dense update
to a host table (trainer/async_dense.py, ≙ BoxPSAsynDenseTable): the step
runs the backward but no optimizer step, its dense grads are copied to
the host and pushed, and ``pull()`` is copied into the module every
``sync_weight_step`` batches and at the end of the pass.
``TrainerConfig(dump_path=...)`` writes ``dump-pass-<pass_id>.txt``
with one ``ins_id\tlabel\tpred`` line per real record (≙ TrainerDesc
dump_fields / DumpWorkField).

PyTorch runs the step eagerly, so there is no jit and no donation: the
working set, the dense params, the optimizer state and the AUC buckets
are updated in place on the device.  Not ported yet: the multi-device
lowering.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import DataFeedConfig, TrainerConfig
from paddlebox_tpu_torch.data.batch_pack import BatchPacker, PackedBatch
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.metrics.auc import (AucCalculator, WuAucCalculator,
                                             accumulate_auc, make_auc_state)
from paddlebox_tpu_torch.ops import crossing as cx
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps import embedding, fast_path, mxu_path, ragged_path
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.utils import intervals, trace
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.monitor import stat_get, stat_observe
from paddlebox_tpu_torch.utils.timer import TimerRegistry


# the step's own planes of a batch; every other plane is an extra input
_STEP_PLANES = ("indices", "lengths", "dense", "labels", "valid")


class SparseTrainer:
    def __init__(self, engine: BoxPSEngine, model: torch.nn.Module,
                 feed_config: DataFeedConfig, batch_size: int,
                 label_slot: str = "label",
                 dense_optimizer: Optional[torch.optim.Optimizer] = None,
                 use_cvm: bool = True, auc_table_size: int = 100_000,
                 amp: bool = False, fast_path: bool = True,
                 sparse_path: str = "auto", seed: int = 0,
                 device: DeviceLike = None,
                 trainer_config: Optional[TrainerConfig] = None):
        """``model`` is re-initialised from ``seed`` (its
        ``reset_parameters(generator)``) and moved to ``device``; load
        other weights afterwards (``model.load_jax_params``).
        ``dense_optimizer`` defaults to Adam(lr=1e-3) over the model's
        parameters — the same update as the JAX package's
        ``optax.adam(1e-3)``: bias-corrected moments, eps added after the
        square root.  ``amp``: bf16 model compute over f32 master
        weights.  ``fast_path=False`` makes ``auto`` resolve to the
        ``reference`` lowering.  ``trainer_config``: the dense sync mode
        (``"async_table"`` with ``sync_weight_step`` and the table's Adam
        settings) and ``dump_path``."""
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine works on {engine.device}, trainer "
                             f"asked for {self.device}")
        if self.device.type == "cuda":
            # the reference trains in full f32, and the parity tolerances
            # assume f32 products: TF32 would keep ~10 mantissa bits in
            # every matmul (and cuDNN enables it by default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.engine = engine
        self.packer = BatchPacker(feed_config, batch_size, label_slot)
        self.batch_size = batch_size
        self.use_cvm = use_cvm
        self.amp = amp
        self.fast_path = fast_path
        self.trainer_config = trainer_config or TrainerConfig()
        if sparse_path == "auto" \
                and flags.get_flags("sparse_step_path") != "auto":
            sparse_path = flags.get_flags("sparse_step_path")
        self.sparse_path = sparse_path
        # (pull, push) crossing lowerings of the mxu step, resolved at the
        # start of each pass (_crossing_modes)
        self._mxu_crossing = ("take", "take")
        self.timers = TimerRegistry()
        self.slot_ids = np.array(
            [s.slot_id for s in feed_config.sparse_slots], np.int32)
        self._slot_ids_dev = torch.as_tensor(self.slot_ids,
                                             device=self.device)

        # dynamic per-slot mf dims (≙ CtrDymfAccessor): mask [S, 3+D]
        # zeroing each slot's unused tail columns of the pooled features
        self._dym_mask = None
        if engine.config.sgd.slot_mf_dims:
            d_max = engine.config.embedding_dim
            m = np.ones((len(self.slot_ids), 3 + d_max), np.float32)
            for i, sid in enumerate(self.slot_ids):
                m[i, 3 + engine.config.slot_mf_dim(int(sid)):] = 0.0
            self._dym_mask = torch.as_tensor(m, device=self.device)

        # models declaring extra feed inputs (RankAttentionCTR's
        # rank_offset) must have the feed produce them: fail here, not
        # mid-pass
        need = set(getattr(model, "extra_inputs", ()))
        have = ({"rank_offset", "ads_offset"}
                | {s.name for s in feed_config.string_slots})
        unknown = need - have
        if unknown:
            raise ValueError(
                f"model.extra_inputs {sorted(unknown)} are not feed planes "
                f"this feed supplies (available: {sorted(have)})")
        if "ads_offset" in need and not feed_config.ads_offset:
            raise ValueError(
                "model requires the ads_offset plane — set "
                "DataFeedConfig(ads_offset=True) (and call "
                "dataset.preprocess_instance())")
        if "rank_offset" in need:
            if not feed_config.rank_offset:
                raise ValueError(
                    "model requires the rank_offset plane — set "
                    "DataFeedConfig(rank_offset=True) (and call "
                    "dataset.preprocess_instance() so batches hold whole "
                    "page views)")
            mr = getattr(model, "max_rank", None)
            if mr is not None and mr != feed_config.max_rank:
                raise ValueError(
                    f"model.max_rank={mr} != DataFeedConfig.max_rank="
                    f"{feed_config.max_rank}: rank_param blocks would be "
                    "mis-addressed")

        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.dense_opt = dense_optimizer or torch.optim.Adam(
            self.model.parameters(), lr=1e-3)
        # ≙ BoxPSAsynDenseTable (dense_sync_mode="async_table"): the dense
        # params live in a host table updated by a background thread; the
        # step only computes the dense grads.  dense_opt stays (the
        # checkpoint saves its state) but does not step, as the JAX
        # package's opt_state does not
        self.async_dense = None
        if self.trainer_config.dense_sync_mode == "async_table":
            if dense_optimizer is not None:
                raise ValueError(
                    "dense_sync_mode='async_table' uses the table's own "
                    "adam rule (TrainerConfig.async_dense_*); an explicit "
                    "dense_optimizer would be silently ignored")
            from paddlebox_tpu_torch.trainer.async_dense import \
                AsyncDenseTable
            tc = self.trainer_config
            self.async_dense = AsyncDenseTable(
                {n: p.detach().cpu().numpy()
                 for n, p in self.model.named_parameters()},
                learning_rate=tc.async_dense_learning_rate,
                beta1=tc.async_dense_beta1, beta2=tc.async_dense_beta2,
                eps=tc.async_dense_eps)
        self.auc_table_size = auc_table_size
        self.auc_state = make_auc_state(auc_table_size, self.device)
        self.auc = AucCalculator(auc_table_size)
        # per-user metrics (≙ WuAucMetricMsg via MultiSlotDesc.uid_slot):
        # host records, so each batch's preds come back to the host, as the
        # reference's add_uid_data copies them (metrics.cc:440)
        self.wuauc = WuAucCalculator() if feed_config.uid_slot else None
        self._check_nan = flags.get_flags("check_nan_inf")

    # ------------------------------------------------------------------
    def _resolve_path(self) -> str:
        """Resolve sparse_path='auto' against the live working set: with
        one device and no topology the JAX package resolves to mxu, or to
        reference under fast_path=False (its escape hatch to the exact
        step)."""
        assert self.engine.ws is not None, \
            "engine pass lifecycle must run before building the step " \
            "(begin_feed_pass/add_keys/end_feed_pass/begin_pass)"
        if embedding.is_quantized(self.engine.ws):
            raise ValueError(
                "the working set is serving-frozen; training requires the "
                "f32 store — rebuild the pass")
        if self.sparse_path != "auto":
            return self.sparse_path
        if not self.fast_path:
            return "reference"
        if "mf_ex" in self.engine.ws and self._dym_mask is not None:
            # no lowering trains mf_ex under per-slot dynamic dims
            raise ValueError(
                "extended (mf_ex) tables do not compose with per-slot "
                "dynamic mf dims — drop slot_mf_dims or the expand "
                "embedding")
        return "mxu"

    def _validate_path(self, path: str) -> None:
        """Reject configs a path cannot honor (both entry points), as the
        JAX package's ``_validate_path`` does; explicit ``fast`` and
        ``reference`` take an expand table and leave its mf_ex as it
        is."""
        has_ex = "mf_ex" in self.engine.ws
        if path == "mxu":
            if has_ex and self._dym_mask is not None:
                raise ValueError(
                    "sparse_path='mxu' with an extended (mf_ex) table does "
                    "not compose with per-slot dynamic mf dims — drop "
                    "slot_mf_dims or the expand embedding")
        elif path == "fast":
            if self.engine.config.sgd.optimizer != "adagrad":
                raise ValueError(
                    "sparse_path='fast' implements the adagrad rule only "
                    f"(got {self.engine.config.sgd.optimizer!r})")
        elif path == "ragged":
            if has_ex:
                raise ValueError(
                    "sparse_path='ragged' pulls only the 3+D pooled "
                    "columns — extended (mf_ex) tables need the mxu path")
        elif path == "reference":
            if self.async_dense is not None:
                raise ValueError(
                    "dense_sync_mode='async_table' requires the mxu, "
                    "fast or ragged sparse path")
        elif path == "mxu_sharded":
            raise ValueError("sparse_path 'mxu_sharded' is not ported to "
                             "the PyTorch package")
        else:
            raise ValueError(f"unknown sparse_path {path!r}")

    def _crossing_modes(self, s: int, l: int, b: int,
                        eff_p_pad: Optional[int] = None,
                        planes: bool = False):
        """(pull, push) crossing lowerings of the mxu step
        (ops/crossing.py): the pull's take emits p canonical rows, the
        push's take only the kept (trimmed) width.  With the static
        payload planes the push crosses only the 1+D dynamic columns; the
        legacy payload carries the exact slot column, so it never crosses
        in bf16."""
        p = s * l * b
        d = (int(self.engine.ws["mf"].shape[1])
             + mxu_path._ex_dim(self.engine.ws))
        dev = self.device.type
        dt = ("bfloat16" if flags.get_flags("mxu_crossing_bf16")
              else "float32")
        pull = cx.best_mode(p, p, 3 + d, dev, dt)
        if planes:
            push = cx.best_mode(eff_p_pad or p, p, 1 + d, dev, dt)
        else:
            push = cx.best_mode(eff_p_pad or p, p, 4 + d, dev)
        return (pull, push)

    # ------------------------------------------------------------------
    def _ins_cvm(self, labels: torch.Tensor) -> torch.Tensor:
        """The instance's (show, click) for the push: (1, label)."""
        return torch.stack([torch.ones_like(labels), labels], dim=1)

    def _model_extras(self, extras) -> Dict[str, torch.Tensor]:
        """The feed planes the model declares in ``extra_inputs``."""
        if not extras:
            return {}
        return {k: extras[k] for k in getattr(self.model, "extra_inputs", ())}

    def _forward(self, x: torch.Tensor, dense: torch.Tensor,
                 extras=None) -> torch.Tensor:
        """The model's f32 logits.  Under amp the whole forward runs in
        bf16 over per-step bf16 copies of the parameters, whose grads flow
        back to the f32 masters (≙ the JAX package casting the params
        pytree and inputs; ``torch.autocast`` would keep reductions and
        many elementwise ops in f32, another function).  The extra feed
        planes pass uncast."""
        kw = self._model_extras(extras)
        if not self.amp:
            return self.model(x, dense, **kw)
        bf16 = torch.bfloat16
        params = {n: p.to(bf16) for n, p in self.model.named_parameters()}
        logits = torch.func.functional_call(
            self.model, params, (x.to(bf16), dense.to(bf16)), kw)
        return logits.to(torch.float32)

    def _loss_and_preds(self, x, dense, labels, valid, extras=None):
        """Masked-mean BCE of the logits and the (detached) predictions."""
        logits = self._forward(x, dense, extras)
        w = valid.to(torch.float32)
        per = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
        loss = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)
        return loss, torch.sigmoid(logits.detach())

    def _accumulate_metrics(self, preds, labels, valid) -> None:
        accumulate_auc(self.auc_state, preds, labels, valid)

    def _dense_step(self, x, dense, labels, valid, extras=None):
        """Model fwd/bwd, dense optimizer step and AUC; the backward also
        fills ``.grad`` of whatever leaf ``x`` came from.  Under the async
        dense table the step stops at the grads (the table applies them,
        :meth:`_async_dense_step`).  Returns (loss, preds)."""
        loss, preds = self._loss_and_preds(x, dense, labels, valid, extras)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.async_dense is None:
            self.dense_opt.step()
        self._accumulate_metrics(preds, labels, valid)
        return loss.detach(), preds

    def _require_main_thread(self, what: str) -> None:
        """The async table's device traffic (grads to the host, params
        back) runs on the main thread only; the table's own thread is
        numpy only."""
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                f"{what} on thread {threading.current_thread().name!r}: it "
                "copies between the device and the host, so only the main "
                "thread may run it")

    def _load_async_params(self) -> None:
        """Copy the table's snapshot into the module's parameters in place
        (≙ PullDense's snapshot refresh, boxps_worker.cc:1301)."""
        self._require_main_thread("the async dense pull")
        snap = self.async_dense.pull()
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(torch.from_numpy(snap[n]))

    def _async_dense_step(self, n_done: int, log) -> None:
        """After batch ``n_done`` (1-based) under the async table: the
        dense grads to the host and into the table (≙ PushDense,
        boxps_worker.cc:252), and every ``sync_weight_step`` batches the
        table's snapshot back into the module."""
        self._require_main_thread("the async dense push")
        t0 = time.perf_counter()
        grads = {n: (p.grad.detach().cpu().numpy() if p.grad is not None
                     else np.zeros(tuple(p.shape), np.float32))
                 for n, p in self.model.named_parameters()}
        log["dense_copy_s"] += time.perf_counter() - t0
        self.async_dense.push(grads)
        if n_done % max(self.trainer_config.sync_weight_step, 1) == 0:
            self._load_async_params()

    def _finish_async_dense(self) -> None:
        """End of a pass: every pushed grad applied, then the table's
        params into the module."""
        if self.async_dense is not None:
            self.async_dense.drain()
            self._load_async_params()

    def _pooled_dense_half(self, pooled, dense, labels, valid, extras=None):
        """Dense half of the pooled-based steps (mxu/fast/ragged): returns
        (loss, preds, d_pooled) — the pooled grads feed the sparse push."""
        b = pooled.shape[0]
        pooled = pooled.detach().requires_grad_(True)
        x = pooled
        if self._dym_mask is not None:
            x = x * self._dym_mask[None]
        x = x if self.use_cvm else x[:, :, 2:]
        loss, preds = self._dense_step(x.reshape(b, -1), dense, labels,
                                       valid, extras)
        return loss, preds, pooled.grad

    def _reference_step(self, idx_slb, lengths, dense, labels, valid,
                        extras=None):
        """The reference lowering (≙ JAX trainer.py:606-659): pull →
        fused_seqpool_cvm → model → BCE → backward → merged push → sparse
        rule → dense optimizer → AUC."""
        ws = self.engine.ws
        indices = idx_slb.permute(0, 2, 1)                  # [S, B, L]
        # 1. pull (≙ PullSparseCaseGPU box_wrapper_impl.h:25)
        with torch.no_grad():
            emb = embedding.pull_sparse(ws, indices)
        emb.requires_grad_(True)
        # 2-3. forward + backward over the dense params and the pulled
        # embeddings; the seqpool backward puts the instance cvm in the
        # show/click grad columns
        pooled = fused_seqpool_cvm(emb, lengths, self._ins_cvm(labels),
                                   self.use_cvm)
        if self._dym_mask is not None:
            # the pooled output is [B, S*E] flattened; with use_cvm=False
            # the two cvm columns are dropped first
            m = self._dym_mask if self.use_cvm else self._dym_mask[:, 2:]
            pooled = pooled * m.reshape(-1)[None]
        loss, preds = self._dense_step(pooled, dense, labels, valid, extras)
        # 4-6. merged push + sparse optimizer (≙ PushSparseGradCaseGPU,
        # box_wrapper_impl.h:373)
        with torch.no_grad():
            acc = embedding.push_sparse_grads(ws, indices, emb.grad,
                                              self._slot_ids_dev)
            sparse_opt.apply_push(ws, acc, self.engine.config.sgd)
        return loss, preds

    def _core(self, path, idx_slb, lengths, dense, labels, valid,
              plan=None, extras=None):
        """One step of ``path`` on device tensors, updating the working
        set, the dense params and the AUC state in place: idx_slb
        [S, L, B]; plan is the feed's plan of this batch (None → the mxu
        lowering plans in-step; ragged needs one); extras the batch's
        extra feed planes by name."""
        if path == "reference":
            return self._reference_step(idx_slb, lengths, dense, labels,
                                        valid, extras)
        ws = self.engine.ws
        s, l, b = idx_slb.shape
        sgd = self.engine.config.sgd
        ins_cvm = self._ins_cvm(labels)
        pull_cross, push_cross = self._mxu_crossing
        with torch.no_grad():
            if path == "mxu":
                # geometry from the live working set, so a per-pass table
                # resize gets the right dims (and sentinel)
                dims = mxu_path.make_dims(s * l * b, ws["show"].shape[0])
                if plan is None:
                    # the packer parks padding at row 0; the mask makes
                    # in-step planning safe for hand-built batches too
                    live = torch.arange(l, device=idx_slb.device)[
                        None, :, None] < lengths[:, None, :]
                    idx_slb = torch.where(live, idx_slb,
                                          torch.zeros_like(idx_slb))
                    plan = mxu_path.build_plan(idx_slb, dims)
                pooled = mxu_path.pull_pool_cvm(ws, plan, dims, (s, l, b),
                                                self.use_cvm, pull_cross)
            elif path == "fast":
                pooled = fast_path.pull_pool_cvm(ws, idx_slb, lengths,
                                                 self.use_cvm)
            else:
                if plan is None:
                    raise ValueError(
                        "sparse_path='ragged' needs the pass-resident "
                        "feed's CSR plans (build_pass_feed)")
                pooled = ragged_path.pull_pool_cvm(ws, plan, (s, l, b),
                                                   self.use_cvm)
        loss, preds, d_pooled = self._pooled_dense_half(pooled, dense,
                                                        labels, valid, extras)
        with torch.no_grad():
            if path == "mxu":
                mxu_path.push_and_update(ws, plan, dims, idx_slb, d_pooled,
                                         ins_cvm, self._slot_ids_dev, sgd,
                                         push_cross)
            elif path == "fast":
                fast_path.push_and_update(ws, idx_slb, lengths, d_pooled,
                                          ins_cvm, self._slot_ids_dev, sgd)
            else:
                ragged_path.push_and_update(ws, plan, d_pooled, ins_cvm,
                                            (s, l, b), sgd)
        return loss, preds

    def _put_batch(self, batch: PackedBatch):
        """Host batch → device tensors (pinned, asynchronous on a card):
        the step's five planes and a dict of the extra planes."""
        planes = tuple(pf.to_device(a, self.device)
                       for a in (batch.indices, batch.lengths, batch.dense,
                                 batch.labels, batch.valid))
        extras = {}
        if batch.rank_offset is not None:
            extras["rank_offset"] = batch.rank_offset
        if batch.aux:
            extras.update(batch.aux)
        if batch.ads_offset is not None:
            extras["ads_offset"] = batch.ads_offset
        return planes + ({k: pf.to_device(v, self.device)
                          for k, v in extras.items()},)

    # ------------------------------------------------------------------
    def train_pass(self, dataset, prefetch: int = 4, pack_threads: int = 1,
                   progress=None) -> Dict[str, float]:
        """Run one full pass over the dataset (≙ TrainFiles loop).

        A ``SlotDataset`` streams: packing runs in background threads
        feeding a bounded channel so the device step overlaps host batch
        assembly; pack_threads > 1 fans batch assembly over a thread pool
        while the channel of ordered futures keeps batch order.  A
        ``PackedPassFeed`` (``build_pass_feed``) routes to the
        device-resident loop instead.  progress, if given, is called as
        progress(n_batches_done) after every step.

        Returns the AUC stats, ``batches``, per-batch ``losses``, their
        mean ``loss`` and, on a card, ``step_ms``: the device time of each
        step between CUDA events recorded around its launches.  With a
        ``uid_slot``: ``uauc``, ``wuauc``, ``wuauc_users`` and
        ``wuauc_s`` (host seconds of the preds' copy and record append)."""
        t0 = time.perf_counter()
        with trace.span("trainer.train_pass", pass_id=self.engine.pass_id):
            if isinstance(dataset, pf.PackedPassFeed):
                stats = self._train_packed(dataset, progress)
            else:
                stats = self._train_stream(dataset, prefetch, pack_threads,
                                           progress)
        dt = time.perf_counter() - t0
        self.engine.timers.add("train", dt)
        stat_observe("trainer.train_pass_s", dt)
        if getattr(self.engine, "cache", None) is not None:
            # this pass's HBM-tier hit rate (set at adoption) rides along
            # with the training metrics for callers like fleet
            stats["cache_hit_rate"] = stat_get("ps.cache.hit_rate")
        return stats

    def _timed_step(self, path, log, *args, plan=None, extras=None,
                    uid=None, dump=None) -> None:
        """Run one step, append its loss (and CUDA events) to ``log``.
        ``uid``: (uids, labels, valid) of the batch on the host, when the
        per-user AUC is on; ``dump``: (ins_ids, labels) of the batch's
        real records on the host, when the instance dump is on."""
        cuda = self.device.type == "cuda"
        m_step = time.monotonic()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with self.timers("step"):
            loss, preds = self._core(path, *args, plan=plan, extras=extras)
        if cuda:
            ev[1].record()
            log["events"].append(ev)
        # host enqueue window (the device may run past it)
        intervals.record("device", m_step, time.monotonic())
        if self.async_dense is not None:
            self._async_dense_step(len(log["losses"]) + 1, log)
        if self._check_nan and not np.isfinite(float(loss)):
            raise FloatingPointError(
                f"NaN/Inf loss at batch {len(log['losses'])}")
        log["losses"].append(loss)
        if dump is not None:
            t0 = time.perf_counter()
            ids, lbl = dump
            cnt = len(lbl)
            if cnt:
                p = preds if preds.dim() == 1 else preds[:, 0]
                p = p[:cnt].cpu().numpy()
                ids = ids if ids is not None else [""] * cnt
                log["dump_file"].write("".join(
                    f"{ids[j]}\t{lbl[j]:g}\t{p[j]:.6f}\n"
                    for j in range(cnt)))
            log["dump_s"] += time.perf_counter() - t0
        if uid is not None:
            t0 = time.perf_counter()
            uids, lbl, valid = uid
            p = preds if preds.dim() == 1 else preds[:, 0]
            self.wuauc.add_data(p.cpu().numpy(),
                                lbl if lbl.ndim == 1 else lbl[:, 0],
                                uids, valid)
            log["wuauc_s"] += time.perf_counter() - t0

    def _pass_stats(self, log) -> Dict[str, float]:
        losses = log["losses"]
        out = self._finalize_metrics(self.auc_state)
        out["batches"] = len(losses)
        # one stacked device->host copy, not one per batch scalar
        per_batch = (torch.stack(losses).cpu().numpy() if losses
                     else np.zeros((0,), np.float32))
        out["losses"] = [float(x) for x in per_batch]
        out["loss"] = float(per_batch.mean()) if losses else float("nan")
        if self.device.type == "cuda":
            # read after the synchronising copy above
            out["step_ms"] = [a.elapsed_time(b) for a, b in log["events"]]
        if self.wuauc is not None:
            # host seconds of the per-batch preds copy and record append
            out["wuauc_s"] = log["wuauc_s"]
        if self.async_dense is not None:
            # host seconds of the dense grads' copies to the host
            out["dense_copy_s"] = log["dense_copy_s"]
        if log["dump_file"] is not None:
            # host seconds of the preds' copies and the dump writes
            out["dump_s"] = log["dump_s"]
        return out

    def _new_log(self) -> Dict:
        """A pass's step log, with the dump file opened when
        ``dump_path`` is set (≙ TrainerDesc dump_fields/dump_path,
        trainer_desc.proto:38-40, DumpWorkField)."""
        log = {"losses": [], "events": [], "wuauc_s": 0.0,
               "dense_copy_s": 0.0, "dump_s": 0.0, "dump_file": None}
        if self.trainer_config.dump_path:
            os.makedirs(self.trainer_config.dump_path, exist_ok=True)
            log["dump_file"] = open(os.path.join(
                self.trainer_config.dump_path,
                f"dump-pass-{self.engine.pass_id}.txt"), "w")
        return log

    def _train_stream(self, dataset: SlotDataset, prefetch: int,
                      pack_threads: int, progress) -> Dict[str, float]:
        """Per-batch host-pack path of train_pass."""
        self._require_pv_for_rank(dataset)
        path = self._resolve_path()
        self._validate_path(path)
        if path == "ragged":
            raise ValueError(
                "sparse_path='ragged' requires the pass-resident feed "
                "(build_pass_feed / train_pass(feed)) — the streaming "
                "per-batch path has no host CSR plan build")
        self._mxu_crossing = ("take", "take")
        if path == "mxu":
            self._mxu_crossing = self._crossing_modes(
                len(self.packer.sparse_slots), self.packer.capacity,
                self.batch_size)
        engine = self.engine
        mapper = engine.mapper
        ch = Channel(capacity=prefetch)
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, pack_threads),
            thread_name_prefix="pbox-pack")

        def pack_one(block):
            t0 = time.perf_counter()
            m0 = time.monotonic()
            b = self.packer.pack(block, key_mapper=mapper)
            intervals.record("pack", m0, time.monotonic())
            self.timers.add("pack", time.perf_counter() - t0)
            return b

        def packer_thread():
            try:
                for block in dataset.batches(self.batch_size):
                    if not ch.put(pool.submit(pack_one, block)):
                        break  # consumer closed the channel (failed pass)
            finally:
                ch.close()

        t = threading.Thread(target=packer_thread, daemon=True)
        t.start()
        log = self._new_log()
        try:
            while True:
                try:
                    batch = ch.get().result()
                except ChannelClosed:
                    break
                indices, lengths, dense, labels, valid, extras = \
                    self._put_batch(batch)
                uid = ((batch.uid, batch.labels, batch.valid)
                       if self.wuauc is not None else None)
                dump = None
                if log["dump_file"] is not None:
                    dump = (batch.ins_ids, batch.labels[:batch.num_real])
                self._timed_step(path, log, indices.permute(0, 2, 1),
                                 lengths, dense, labels, valid,
                                 extras=extras, uid=uid, dump=dump)
                if progress is not None:
                    progress(len(log["losses"]))
        finally:
            # on any exit unblock the producer, reap it and cancel queued
            # packs, and never leak the dump file across failed passes
            ch.close()
            t.join()
            pool.shutdown(wait=False, cancel_futures=True)
            if log["dump_file"] is not None:
                log["dump_file"].close()
        self._finish_async_dense()
        return self._pass_stats(log)

    # ------------------------------------------------------------------
    # pass-resident path (≙ SlotPaddleBoxDataFeed whole-pass GPU pack,
    # data_feed.h:2036 + data_feed.cu:1210-1318): the loop indexes batch i
    # of device-resident stacked tensors; the mxu plans (trimmed, with the
    # static payload planes) and the ragged CSR plans are built once at
    # feed build, so the hot step contains no sort of its own plan.
    def pack_pass_host(self, dataset: SlotDataset, mapper=None,
                       on_plane=None) -> pf.HostPassArrays:
        """Host half of :meth:`build_pass_feed`: pack + translate the
        whole pass into SoA planes (and, on the ragged lowering, its CSR
        plans).  No device work (unless the caller hands in an
        ``on_plane`` stager, which only the main thread may run) and no
        dependence on the adopted working set: with an explicit
        ``mapper`` (``engine.peek_next_mapper()``) the pass prefetcher
        runs this on its worker thread while the previous pass still
        trains."""
        self._require_pv_for_rank(dataset)
        label = (self.packer.label_slots
                 if len(self.packer.label_slots) > 1
                 else self.packer.label_slot)
        # pv-grouped datasets batch on page-view boundaries
        counts = None
        if getattr(dataset, "_pv_grouped", False):
            counts = [hi - lo
                      for lo, hi in dataset.batch_bounds(self.batch_size)]
        arrays = pf.pack_pass(dataset.get_blocks(), self.packer.config,
                              self.batch_size, label,
                              key_mapper=(self.engine.mapper if mapper is None
                                          else mapper),
                              batch_counts=counts, on_plane=on_plane)
        if self.sparse_path == "ragged":
            # lowered here, so that the prefetch worker hides the CSR build
            # under the previous pass's training
            arrays.csr = pf.build_csr_plans(arrays.indices, self.slot_ids,
                                            arrays.n_batches,
                                            arrays.batch_size)
        return arrays

    def finish_pass_feed(self, arrays: pf.HostPassArrays,
                         staged: Optional[pf.PlaneStager] = None,
                         keep_host: bool = False) -> pf.PackedPassFeed:
        """Device half of :meth:`build_pass_feed`: upload + relayout the
        packed planes and build the lowering's per-batch plans.  Needs
        the pass's working set adopted (plan dims read its height), so the
        prefetcher calls it on the main thread right after
        ``engine.begin_pass()``.  ``staged``: the PlaneStager that
        pack_pass_host was handed (its planes are already uploading).
        ``keep_host`` (always, when ``dump_path`` is set): the feed keeps
        the host arrays (``feed.host``), which the dump reads."""
        assert self.engine.ws is not None, "engine lifecycle must run first"
        path = self._resolve_path()
        self._validate_path(path)
        keep = keep_host or bool(self.trainer_config.dump_path)
        feed = pf.upload_pass(arrays, self.device, staged=staged,
                              keep_host=keep)
        if path == "mxu":
            n, s, l, b = feed.data["indices"].shape
            dims = mxu_path.make_dims(s * l * b,
                                      self.engine.ws["show"].shape[0])
            # padding occurrences (row 0) are dead kernel work — trim the
            # plans to the widest batch's real-occurrence count (host
            # lengths are exact, so this is a static bound for the pass)
            per_batch = arrays.lengths.reshape(s, n, b).sum(axis=(0, 2))
            eff = sp.trimmed_dims(dims, int(per_batch.max()))
            pf.precompute_plans(feed, dims, eff, slot_ids=self.slot_ids)
        elif path == "ragged":
            csr = arrays.csr
            if csr is None:
                csr = pf.build_csr_plans(arrays.indices, self.slot_ids,
                                         arrays.n_batches,
                                         arrays.batch_size)
            feed.plans = {k: pf.to_device(v, self.device)
                          for k, v in csr.items()}
            feed.plan_dims = self._ragged_plan_key(feed)
        return feed

    def build_pass_feed(self, dataset: SlotDataset,
                        keep_host: bool = False) -> pf.PackedPassFeed:
        """Pack + translate + upload the whole pass and build its plans
        (pack_pass_host, then finish_pass_feed)."""
        assert self.engine.ws is not None, "engine lifecycle must run first"
        return self.finish_pass_feed(self.pack_pass_host(dataset),
                                     keep_host=keep_host)

    def _require_pv_for_rank(self, dataset) -> None:
        """rank_offset / ads_offset mean something only when every batch
        holds whole page views (the reference emits them under pv merge
        only): a pv split across dense batch cuts would see only its
        fragment's peers, so refuse."""
        if (self.packer.config.rank_offset
                or self.packer.config.ads_offset) \
                and not getattr(dataset, "_pv_grouped", False):
            raise ValueError(
                "DataFeedConfig(rank_offset/ads_offset) requires "
                "pv-grouped batches — call dataset.preprocess_instance() "
                "before training (≙ GetRankOffset's whole-pv batches, "
                "data_feed.cc:1855)")

    def _ragged_plan_key(self, feed: pf.PackedPassFeed):
        """Geometry a feed's CSR plans were built for: u_rows are
        pass-local rows, so a table resize makes them corrupting."""
        return ("ragged", tuple(feed.data["indices"].shape),
                self.engine.ws["show"].shape[0])

    def _train_packed(self, feed: pf.PackedPassFeed,
                      progress=None) -> Dict[str, float]:
        """Device-resident train loop: per-batch host work is indexing
        batch i (≙ the reference train loop consuming pre-packed GPU
        batches, data_feed.h:519 MiniBatchGpuPack)."""
        path = self._resolve_path()
        self._validate_path(path)
        if feed.data["indices"].device.type != self.device.type:
            raise ValueError(f"feed lives on {feed.data['indices'].device}, "
                             f"trainer on {self.device}")
        n, s, l, b = feed.data["indices"].shape
        plans = None
        if path == "mxu" and feed.plans is not None:
            # plans encode the table geometry (sentinel tile); a cross-pass
            # resize makes them corrupting, not just stale
            cur = mxu_path.make_dims(s * l * b,
                                     self.engine.ws["show"].shape[0])
            if cur != feed.plan_dims:
                raise ValueError(
                    "PackedPassFeed plans were built for table dims "
                    f"{feed.plan_dims}, but the working set now needs "
                    f"{cur} — rebuild the feed (build_pass_feed) after a "
                    "table resize")
            plans = feed.plans
        elif path == "ragged" and feed.plans is not None:
            cur = self._ragged_plan_key(feed)
            if cur != feed.plan_dims:
                raise ValueError(
                    "PackedPassFeed CSR plans were built for "
                    f"{feed.plan_dims}, but the pass now needs {cur} — "
                    "rebuild the feed (build_pass_feed)")
            plans = feed.plans
        self._mxu_crossing = ("take", "take")
        if path == "mxu":
            eff_p_pad = None
            if plans is not None:
                r = plans["rows2d"].shape           # [N, n_chunks, 1, c]
                eff_p_pad = int(r[1]) * int(r[3])
            self._mxu_crossing = self._crossing_modes(
                s, l, b, eff_p_pad, plans is not None and "bs" in plans)
        if self.wuauc is not None and (feed.uid is None
                                       or feed.host_labels is None):
            raise ValueError(
                "uid_slot is configured but this feed carries no host "
                "uids/labels — build it with build_pass_feed")
        if self.trainer_config.dump_path and feed.host is None:
            raise ValueError(
                "dump_path requires build_pass_feed(keep_host=True)")
        log = self._new_log()
        b = feed.batch_size
        try:
            for i in range(feed.n_batches):
                bt = pf.slice_batch(feed.data, i)
                plan = (pf.plan_tuple(pf.slice_batch(plans, i))
                        if plans is not None else None)
                # rank_offset rows are batch-local: the slice needs no base
                extras = {k: v for k, v in bt.items()
                          if k not in _STEP_PLANES}
                uid = None
                if self.wuauc is not None:
                    sl = slice(i * b, (i + 1) * b)
                    uid = (feed.uid[sl], feed.host_labels[sl],
                           feed.host_valid[sl])
                dump = None
                if log["dump_file"] is not None:
                    h = feed.host
                    lo, cnt, base = h.real_range(i)
                    dump = (h.ins_ids[base:base + cnt] if h.ins_ids
                            else None, h.labels[lo:lo + cnt])
                self._timed_step(path, log, bt["indices"], bt["lengths"],
                                 bt["dense"], bt["labels"], bt["valid"],
                                 plan=plan, extras=extras, uid=uid,
                                 dump=dump)
                if progress is not None:
                    progress(i + 1)
        finally:
            if log["dump_file"] is not None:
                log["dump_file"].close()
        self._finish_async_dense()
        return self._pass_stats(log)

    def _finalize_metrics(self, auc_state) -> Dict[str, float]:
        self.auc.reset()
        self.auc.merge_device_state(
            {k: v.cpu().numpy() for k, v in auc_state.items()})
        out = self.auc.compute()
        pos, neg = self.auc.folded_buckets()
        out["auc_buckets"] = {"pos": pos.tolist(), "neg": neg.tolist()}
        self._finalize_wuauc(out)
        return out

    def _finalize_wuauc(self, out: Dict) -> None:
        """uauc / wuauc / wuauc_users into the pass stats; the records are
        dropped (a per-pass metric, ≙ reset_records)."""
        if self.wuauc is None:
            return
        w = self.wuauc.compute()
        out["uauc"] = w["uauc"]
        out["wuauc"] = w["wuauc"]
        out["wuauc_users"] = w["user_cnt"]
        self.wuauc.reset()

    def reset_metrics(self) -> None:
        """Start the AUC buckets afresh (they accumulate across passes
        until this is called, as in the JAX package)."""
        self.auc_state = make_auc_state(self.auc_table_size, self.device)
        self.auc.reset()
        if self.wuauc is not None:
            self.wuauc.reset()
