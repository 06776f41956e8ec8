"""Training loop — the train_from_dataset path.

Port of ``paddlebox_tpu/trainer/trainer.py`` (≙ BoxPSTrainer::Run →
BoxPSWorker::TrainFiles, boxps_trainer.cc:282, boxps_worker.cc:1278):
pull → seqpool + CVM → model fwd/bwd → merged push → sparse optimizer
rule → dense Adam → AUC buckets, on one of five sparse lowerings:

* ``mxu``       — sorted gather / merged scatter kernels (ps/mxu_path.py);
  what ``auto`` resolves to with no topology;
* ``mxu_sharded`` — the HeterComm-style sharded exchange
  (ps/sharded_embedding.py) over a ``HybridTopology``: the working set
  split in contiguous row blocks over the table axes, each shard's
  batch block planned against its rows, both sorted kernels run once a
  shard (see :meth:`SparseTrainer._sharded_step`); what ``auto``
  resolves to on a pure dp × sharding mesh that divides the batch and
  the table;
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
are updated in place on the device.

Under a topology one controller drives every shard, as HeterPS drives a
node's cards from one process and the JAX package one program over its
mesh.  With every shard on one device the dense half runs once over the
global batch, the function GSPMD computes for a replicated net, and
explicit ``mxu``, ``fast`` and ``reference`` run their one-device
lowering over the global batch; ``_resolve_path()`` names the lowering
that runs, the same on every placement of the mesh.  With shards on
distinct devices (``HybridTopology(devices=[...])``) each shard's
working-set block and batch columns of the feed sit on the shard's
device, values move between devices only through the collectives, and
the dense half runs as one replica per device over its batch blocks, the
replicas' grads summed in device order and the one optimizer step copied
to every replica (:meth:`_replica_dense_half`).  ``mxu_sharded`` runs its
exchange with per-shard plans (:meth:`_sharded_step`); explicit ``mxu``,
``fast`` and ``reference`` — and ``auto`` where it resolves to them, on a
mesh ``mxu_sharded`` cannot take — run the one-device function with
each row block of the working set pulling, merging and stepping its own
rows on its device (:meth:`_blocks_step`); under dp × sharding each
table block steps on its first node's device and the other nodes'
replicas of it take a copy.  A batch the dp × sharding blocks do not
divide is padded with empty records on distinct devices, at the end of
its last block, so the page-view planes' batch-local rows stay valid.  A
model that reads them (``RankAttentionCTR``) gets each replica's rows'
``rank_offset``, the whole ``ads_offset`` and the whole batch's input
for its peer rows (:meth:`_replica_dense_half`).

A topology whose dp axis spans processes (one process a node, over a
``torch.distributed`` group: ``HybridTopology(process_group=)``) trains
every lowering but ``ragged``.  Every process reads the whole pass and
holds its own shards' blocks of the working set: one whole replica on
the multi-node layout, its own row blocks where the table is split
across processes (``table_spec``).  It runs the step for its own
shards' batch columns and its own row blocks, and what another process
needs crosses the group through the collectives: on the multi-node
layout the push's second tier; where the table is split the
``mxu_sharded`` exchange (ids, pulled values, push payload) or the row
blocks' ids, pull parts and grads (``gather_onto_shards`` /
``reduce_scatter_onto_shards``); always the dense half's count, losses and
grads (summed in global device order).  Every sum is folded in the order
of one process holding every shard, so every rank takes the same steps
and equals that process.  The AUC buckets are summed over the group at
the end of a pass.  Under the async dense table every rank pushes the
same folded grads into its own table, so the tables stay equal, and
each reload waits for its table's queue, so every rank reloads the same
weights; a
page-view model's replicas get the whole batch's input from every
process and send the grads of it back to the rows' owners
(:meth:`_replica_dense_half`).  The instance dump and the per-user AUC
raise there (ROADMAP item 4.5): they read the whole batch's preds on the
host, which the JAX package cannot do across hosts either.
"""

from __future__ import annotations

import concurrent.futures
import copy
import logging
import os
import threading
import time
from typing import Dict, List, Optional

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
                                             accumulate_auc, make_auc_state,
                                             sum_auc_state)
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.parallel import collective as col
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Sharded,
                                                   Spec, device_key,
                                                   on_device,
                                                   physical_device,
                                                   same_device)
from paddlebox_tpu_torch.ps import embedding, fast_path, mxu_path, ragged_path
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps import sharded_embedding as se
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.utils import intervals, trace
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.monitor import stat_get, stat_observe
from paddlebox_tpu_torch.utils.timer import TimerRegistry


# the step's own planes of a batch; every other plane is an extra input
_STEP_PLANES = ("indices", "lengths", "dense", "labels", "valid")
# the page-view planes: their entries address rows of the whole batch
_PV_PLANES = {"rank_offset", "ads_offset"}
# what a dense replica of a page-view model gets besides its own rows:
# the whole batch's input and the row of it each of its rows is
_PEER_KEYS = ("peers", "peer_rows")


def _mask_padding(idx_slb: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """[S, L, B] ids with every position past its record's length at row
    0 (the packer parks padding there; the mask makes hand-built batches
    safe too)."""
    live = torch.arange(idx_slb.shape[1], device=idx_slb.device)[
        None, :, None] < lengths[:, None, :]
    return torch.where(live, idx_slb, torch.zeros_like(idx_slb))


class SparseTrainer:
    def __init__(self, engine: BoxPSEngine, model: torch.nn.Module,
                 feed_config: DataFeedConfig, batch_size: int,
                 label_slot: str = "label",
                 dense_optimizer: Optional[torch.optim.Optimizer] = None,
                 use_cvm: bool = True, auc_table_size: int = 100_000,
                 amp: bool = False, fast_path: bool = True,
                 sparse_path: str = "auto", seed: int = 0,
                 device: DeviceLike = None,
                 trainer_config: Optional[TrainerConfig] = None,
                 topology: Optional[HybridTopology] = None):
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
        settings) and ``dump_path``.  ``topology``: the mesh of shards
        the working set and the batch are split over, its first shard on
        this trainer's device."""
        self.device = resolve_device(device)
        if not same_device(engine.device, self.device):
            raise ValueError(f"engine works on {engine.device}, trainer "
                             f"asked for {self.device}")
        if topology is not None and not same_device(topology.device,
                                                    self.device):
            raise ValueError(f"topology's shards live on {topology.device}, "
                             f"the trainer on {self.device}")
        self.topology = topology
        # shards on distinct devices: per-device blocks and dense replicas
        self._multi = topology is not None and topology.multi_device
        self._replicas: Optional[List[torch.nn.Module]] = None
        self._owners = None
        self._consts: Dict = {}
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
        # FLAGS_sharded_exchange_bf16 as the mxu_sharded step reads it,
        # taken at the start of each pass
        self._exchange_bf16 = False
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
        # rank_offset / ads_offset address rows anywhere in the batch: on
        # distinct devices each dense replica also gets the whole batch's
        # input (_replica_dense_half)
        self._reads_pv = bool(need & _PV_PLANES)
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

        if topology is not None:
            self._refuse_cross_process()
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
        """Resolve sparse_path='auto' against the live working set, as the
        JAX package does: reference under fast_path=False (its escape
        hatch to the exact step); mxu with no topology; mxu_sharded on a
        shardable one (:meth:`_mxu_shardable`); else fast for adagrad and
        reference for the other rules (an expand table raises there).
        The answer is the same whether the shards share a device or
        not."""
        assert self.engine.ws is not None, \
            "engine pass lifecycle must run before building the step " \
            "(begin_feed_pass/add_keys/end_feed_pass/begin_pass)"
        if embedding.is_quantized(self.engine.ws):
            raise ValueError(
                "the working set is serving-frozen; training requires the "
                "f32 store — rebuild the pass")
        if self.sparse_path != "auto":
            return self.sparse_path
        has_ex = "mf_ex" in self.engine.ws
        if not self.fast_path:
            return "reference"
        if has_ex and self._dym_mask is not None:
            # no lowering trains mf_ex under per-slot dynamic dims
            raise ValueError(
                "extended (mf_ex) tables do not compose with per-slot "
                "dynamic mf dims — drop slot_mf_dims or the expand "
                "embedding")
        if self.topology is None:
            return "mxu"
        if self._mxu_shardable():
            return "mxu_sharded"
        if has_ex:
            # fast/reference pull only 3+D columns
            raise ValueError(
                "extended (mf_ex) tables need the mxu or mxu_sharded "
                "path — this topology does not satisfy "
                "_mxu_shardable (pure dp×sharding mesh, divisible "
                "batch/table)")
        if self.engine.config.sgd.optimizer == "adagrad":
            return "fast"
        return "reference"

    def _mxu_shardable(self) -> bool:
        """mxu_sharded wants the HeterComm-symmetric layout: every shard
        holds a batch block and a table block, on a pure dp × sharding
        mesh (pp/mp/sp/ep all 1) with an evenly divisible batch and
        table.  With both axes > 1 the multi-node layout applies (table
        split over ``sharding``, replicated over ``dp``), so the table
        must divide by the sharding degree only."""
        if self.topology is None:
            return False
        t = self.topology
        if any(t.axis_size(a) != 1 for a in ("pp", "mp", "sp", "ep")):
            return False
        n_dev = t.axis_size(("dp", "sharding"))
        n_tbl = t.axis_size("sharding") if t.multinode_table() else n_dev
        return (self.batch_size % n_dev == 0
                and self.engine.ws["show"].shape[0] % n_tbl == 0)

    def _sharded_layout(self):
        """(batch_axes, tbl_axes, n_tbl, rows_loc, multinode) of the
        mxu_sharded exchange — one source for the step, the pass plans
        and the stale-plan check."""
        batch_axes = ("dp", "sharding")
        multinode = self.topology.multinode_table()
        tbl_axes = ("sharding",) if multinode else batch_axes
        n_tbl = self.topology.axis_size(tbl_axes)
        n_rows = self.engine.ws["show"].shape[0]
        return batch_axes, tbl_axes, n_tbl, n_rows // n_tbl, multinode

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
        elif path == "mxu_sharded":
            if has_ex and self._dym_mask is not None:
                raise ValueError(
                    "sparse_path='mxu_sharded' with an extended (mf_ex) "
                    "table does not compose with per-slot dynamic mf dims "
                    "— drop slot_mf_dims or the expand embedding")
            if not self._mxu_shardable():
                raise ValueError(
                    "sparse_path='mxu_sharded' needs a topology with a "
                    "pure dp×sharding mesh (pp/mp/sp/ep == 1) and batch/"
                    "table sizes divisible by the device count")
        elif path == "fast":
            if self.engine.config.sgd.optimizer != "adagrad":
                raise ValueError(
                    "sparse_path='fast' implements the adagrad rule only "
                    f"(got {self.engine.config.sgd.optimizer!r})")
        elif path == "ragged":
            if has_ex:
                raise ValueError(
                    "sparse_path='ragged' pulls only the 3+D pooled "
                    "columns — extended (mf_ex) tables need the mxu or "
                    "mxu_sharded path")
            if self.topology is not None:
                raise ValueError(
                    "sparse_path='ragged' builds its CSR step plans "
                    "host-side against a single-host working set — use "
                    "mxu_sharded under a topology")
        elif path == "reference":
            if self.async_dense is not None:
                raise ValueError(
                    "dense_sync_mode='async_table' requires the mxu, "
                    "mxu_sharded, fast or ragged sparse path")
        else:
            raise ValueError(f"unknown sparse_path {path!r}")

    def _refuse_cross_process(self) -> None:
        """What a dp axis across processes does not carry raises through
        the topology, when the trainer is built, naming ROADMAP item 4.5:
        the instance dump and the per-user AUC read every batch's preds on
        the host, which the JAX package does with ``np.asarray`` — no
        defined answer for a batch split across hosts, where no process
        holds the whole batch — so neither package carries them."""
        why = ("it reads the whole batch's preds on the host, as the JAX "
               "package does with np.asarray, which a batch split across "
               "hosts does not allow (in neither package)")
        for what, on in (
                ("dump_path", bool(self.trainer_config.dump_path)),
                ("uid_slot (the per-user AUC)",
                 bool(self.packer.config.uid_slot))):
            if on:
                self.topology.refuse_cross_process(what, why)

    # ------------------------------------------------------------------
    def _ins_cvm(self, labels: torch.Tensor) -> torch.Tensor:
        """The instance's (show, click) for the push: (1, label)."""
        return torch.stack([torch.ones_like(labels), labels], dim=1)

    def _model_extras(self, extras) -> Dict[str, torch.Tensor]:
        """The feed planes the model declares in ``extra_inputs``, and a
        dense replica's peer rows (:meth:`_replica_dense_half`)."""
        if not extras:
            return {}
        out = {k: extras[k] for k in getattr(self.model, "extra_inputs", ())}
        out.update((k, extras[k]) for k in _PEER_KEYS if k in extras)
        return out

    def _forward(self, x: torch.Tensor, dense: torch.Tensor,
                 extras=None, model=None) -> torch.Tensor:
        """The model's f32 logits.  Under amp the whole forward runs in
        bf16 over per-step bf16 copies of the parameters, whose grads flow
        back to the f32 masters (≙ the JAX package casting the params
        pytree and inputs; ``torch.autocast`` would keep reductions and
        many elementwise ops in f32, another function).  The extra feed
        planes pass uncast, a replica's ``peers`` cast with ``x``.
        ``model``: a dense replica (default: the trainer's model)."""
        model = self.model if model is None else model
        kw = self._model_extras(extras)
        if not self.amp:
            return model(x, dense, **kw)
        bf16 = torch.bfloat16
        if "peers" in kw:
            kw["peers"] = kw["peers"].to(bf16)
        params = {n: p.to(bf16) for n, p in model.named_parameters()}
        logits = torch.func.functional_call(
            model, params, (x.to(bf16), dense.to(bf16)), kw)
        return logits.to(torch.float32)

    def _loss_and_preds(self, x, dense, labels, valid, extras=None,
                        model=None, count=None):
        """Masked-mean BCE of the logits and the (detached) predictions.
        ``model``: a dense replica (default: the trainer's model);
        ``count``: the count of valid records the mean divides by, at
        least 1 (default: this batch's; a replica gets the global
        batch's)."""
        logits = self._forward(x, dense, extras, model)
        w = valid.to(torch.float32)
        per = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
        if count is None:
            count = torch.sum(w)
        loss = torch.sum(per * w) / torch.clamp(count, min=1.0)
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
        (≙ PullDense's snapshot refresh, boxps_worker.cc:1301).  Under a
        dp axis across processes each rank holds its own table, so the
        reload first waits until the table has applied every pushed grad:
        every rank then reads the same state (a snapshot taken wherever
        its update thread has got to would differ between ranks, and so
        would the weights the next batch trains on)."""
        self._require_main_thread("the async dense pull")
        if self.topology is not None and self.topology.spans_processes:
            self.async_dense.drain()
        snap = self.async_dense.pull()
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(torch.from_numpy(snap[n]))
        self._sync_replicas()

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

    def _dense_input(self, pooled: torch.Tensor) -> torch.Tensor:
        """The model's input [B, S*(3+D)] from pooled features
        [B, S, 3+D]: the dynamic-dim mask applied, the two cvm columns
        dropped under ``use_cvm=False``."""
        x = pooled
        if self._dym_mask is not None:
            x = x * self._const(self._dym_mask, x.device)[None]
        x = x if self.use_cvm else x[:, :, 2:]
        return x.reshape(x.shape[0], -1)

    def _pooled_dense_half(self, pooled, dense, labels, valid, extras=None):
        """Dense half of the pooled-based steps (mxu/fast/ragged): returns
        (loss, preds, d_pooled) — the pooled grads feed the sparse push."""
        pooled = pooled.detach().requires_grad_(True)
        loss, preds = self._dense_step(self._dense_input(pooled), dense,
                                       labels, valid, extras)
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
        [S, L, B]; plan is the feed's plan of this batch (mxu: a
        ``mxu_path.StepPlan``, None → planned in-step; ragged: a
        ``ragged_path.CsrPlan``, required); extras the batch's extra
        feed planes by name."""
        if self._multi and path in ("mxu", "fast", "reference"):
            return self._blocks_step(path, idx_slb, lengths, dense, labels,
                                     valid, plan, extras)
        if path == "reference":
            return self._reference_step(idx_slb, lengths, dense, labels,
                                        valid, extras)
        if path == "mxu_sharded":
            return self._sharded_step(idx_slb, lengths, dense, labels,
                                      valid, plan, extras)
        ws = self.engine.ws
        s, l, b = idx_slb.shape
        sgd = self.engine.config.sgd
        ins_cvm = self._ins_cvm(labels)
        dev = self.device
        with trace.span("trainer.step.pull", device=dev), torch.no_grad():
            if path == "mxu":
                # geometry from the live working set, so a per-pass table
                # resize gets the right dims (and sentinel)
                dims = mxu_path.make_dims(s * l * b, ws["show"].shape[0])
                if plan is None:
                    idx_slb = _mask_padding(idx_slb, lengths)
                    plan = mxu_path.StepPlan(
                        mxu_path.build_plan(idx_slb, dims))
                pooled = mxu_path.pull_pool_cvm(ws, plan.plan, dims,
                                                (s, l, b), self.use_cvm)
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
        with trace.span("trainer.step.dense", device=dev):
            loss, preds, d_pooled = self._pooled_dense_half(
                pooled, dense, labels, valid, extras)
        with trace.span("trainer.step.push", device=dev), torch.no_grad():
            if path == "mxu":
                mxu_path.push_and_update(ws, plan.plan, dims, idx_slb,
                                         d_pooled, ins_cvm,
                                         self._slot_ids_dev, sgd,
                                         payload=plan.payload,
                                         rule=plan.rule)
            elif path == "fast":
                fast_path.push_and_update(ws, idx_slb, lengths, d_pooled,
                                          ins_cvm, self._slot_ids_dev, sgd)
            else:
                ragged_path.push_and_update(ws, plan, d_pooled, ins_cvm,
                                            (s, l, b), sgd)
        return loss, preds

    def _sharded_step(self, idx_slb, lengths, dense, labels, valid,
                      plan=None, extras=None):
        """The mxu_sharded step (≙ heter_comm_inl.h:1296 pull_merge_sparse,
        :1730 push merge, :2027 gather_one_node_grad).  Shard k reads
        batch columns [k*B_loc, (k+1)*B_loc) (``batch_spec``) and owns the
        working-set rows of its ``table_spec`` block.  Pull: its ids
        gathered over the table axes, each shard's sorted gather over its
        block, the values reduce-scattered back to their requesters and
        pooled.  Dense half: one replica per device over its shards'
        columns (:meth:`_replica_dense_half`; on one device, once over the
        global batch).  Push: the legacy payload (slot id in column
        D + 3) split by batch block, gathered over the table axes and
        merged by each owner (multi-node: merged within a node, then
        summed across nodes), then the optimizer step: over the joined
        deltas on one device, else once a table block on the device of
        its first shard (:meth:`_apply_push_blocks`).

        The batch planes are global tensors on one device, or per-shard
        lists (each shard's columns on its device) when the shards sit on
        distinct devices.  plan: the feed's per-shard plans of this batch
        (each array with a leading shard dim, or a list of per-shard
        tuples), else planned here."""
        ws = self.engine.ws
        topo = self.topology
        batch_axes, tbl_axes, n_tbl, rows_loc, multinode = \
            self._sharded_layout()
        d_main = ws["mf"].shape[1]
        d = d_main + mxu_path._ex_dim(ws)
        bspec = Spec(None, None, batch_axes)        # [S, L, B(, W)]
        tspec = Spec(None, tbl_axes)                # [W, rows]
        with torch.no_grad():
            if isinstance(idx_slb, list):
                s, l, b_loc = idx_slb[topo.local_shards[0]].shape
                idx_loc = [None if x is None else
                           _mask_padding(x, n).reshape(-1)
                           for x, n in zip(idx_slb, lengths)]
            else:
                s, l, b = idx_slb.shape
                b_loc = b // topo.axis_size(batch_axes)
                idx_slb = _mask_padding(idx_slb, lengths)
                idx_loc = [x.reshape(-1) for x in topo.split(idx_slb, bspec)]
            if plan is None:
                _, plans = se.local_plan(idx_loc, rows_loc, topo, tbl_axes)
            elif isinstance(plan, list):
                plans = plan
            else:
                plans = [sp.Plan(*(a[k] for a in plan))
                         for k in range(topo.world_size)]
            vals = se.pull_rows_sharded_mxu(
                self._shard_tables(ws, tspec), idx_loc, topo, tbl_axes,
                plans, self._exchange_bf16)
            # each device's shards' columns, in flat shard order
            pooled = [mxu_path.pool_cvm_values(torch.cat(
                [vals[k].T.reshape(s, l, b_loc, 4 + d) for k in ks], dim=2),
                self.use_cvm) for _, ks in topo.groups]
        labels_g = self._per_device(labels)
        extras_g = self._extras_per_device(extras)
        loss, preds, d_pooled = self._replica_dense_half(
            pooled, self._per_device(dense), labels_g,
            self._per_device(valid), extras_g)
        if not self._multi:
            preds = preds[0]
        else:
            preds = self._join_columns(preds, b_loc)
            self._accumulate_metrics(preds, self._join_columns(labels),
                                     self._join_columns(valid))
        with torch.no_grad():
            pay_loc = [None] * topo.world_size
            for (dev, ks), dp, lab in zip(topo.groups, d_pooled, labels_g):
                payload = mxu_path.push_payload(
                    dp, self._ins_cvm(lab), self._const(self._slot_ids_dev,
                                                        dev),
                    (s, l, dp.shape[0]))
                for i, k in enumerate(ks):
                    pay_loc[k] = payload[:, :, i * b_loc:(i + 1) * b_loc
                                         ].reshape(-1, d + 4).T
            if multinode:
                delta = se.push_rows_sharded_mxu_multinode(
                    idx_loc, pay_loc, rows_loc, topo, tbl_axes, "dp",
                    first_only_col=d + 3, plans=plans,
                    exchange_bf16=self._exchange_bf16)
            else:
                delta = se.push_rows_sharded_mxu(
                    idx_loc, pay_loc, rows_loc, topo, tbl_axes,
                    first_only_col=d + 3, plans=plans,
                    exchange_bf16=self._exchange_bf16)
            sgd = self.engine.config.sgd
            if isinstance(ws["show"], Sharded):
                self._apply_push_blocks(ws, delta, rows_loc, d_main, sgd)
            else:
                acc = mxu_path.acc_from_delta(topo.join(delta, tspec),
                                              ws["show"].shape[0],
                                              d_main=d_main)
                sparse_opt.apply_push(ws, acc, sgd)
        return loss, preds

    def _blocks_step(self, path, idx_slb, lengths, dense, labels, valid,
                     plan=None, extras=None):
        """Explicit ``mxu``, ``fast`` or ``reference`` with the shards on
        distinct devices: the function the one-device lowering computes
        (GSPMD's answer for the sharded table and batch), in the
        owner-computes pattern of HeterComm (heter_comm_inl.h:1296,1730).

        The batch planes are per-shard lists; batch block b is read from
        its first shard (:meth:`_batch_owners`), so shards that share
        batch columns (mp > 1) count them once.  Each row block of the
        working set works at its home (``Sharded.row_homes``: its first
        shard on each process that holds it), over the whole batch's ids
        gathered there in batch order (ids it does not hold localized
        away); where a process holds no copy of a row block, another
        process's home serves it:

        * pull — ``fast``: ``gather_pool`` over the block gives its part
          of every pooled sum; ``mxu``: ``gather_sorted`` over the
          block's plan gives the values of the occurrences it holds
          (zeros elsewhere); ``reference``: the plain gather, likewise.
          The parts are reduce-scattered to the batch blocks' devices,
          summed in row-block order, then pooled and CVM'd there.
        * dense half — one replica per device over its batch blocks
          (:meth:`_replica_dense_half`).
        * push — the pooled grads (``reference``: the per-occurrence
          grads) gathered to every row block, which merges the
          occurrences it holds with ``scatter_add_sorted`` in their
          canonical order and steps its rows (``fast``: the fused adagrad,
          else ``apply_push``, both with ``row0=``); the block's replicas
          (dp × sharding) take a copy (:meth:`_step_row_blocks`).

        ``plan``: the feed's per-row-block plans of this batch (mxu),
        else planned here.  Partial pooled sums in row-block order differ
        from the one-device sum in the last ulp (fast); the values of
        mxu and reference have one contributor each."""
        ws = self.engine.ws
        topo = self.topology
        owners, _ = self._batch_owners()
        # every row block over every process, each read and stepped at
        # its home on this process (None where another process alone
        # holds it: the table split across processes)
        homes = ws["show"].row_homes()
        srcs = [ks for ks, _ in homes]
        here = [next((k for k in ks if topo.is_local(k)), None)
                for ks in srcs]
        sgd = self.engine.config.sgd
        s, l, b_loc = idx_slb[topo.local_shards[0]].shape
        d = ws["mf"].shape[1] + mxu_path._ex_dim(ws)
        n_b = len(owners)

        def block(k):
            return {f: t.parts[k] for f, t in ws.items()}
        with torch.no_grad():
            len_b = [lengths[k] for k in owners]
            idx_b = [None if n is None else _mask_padding(idx_slb[k], n)
                     for k, n in zip(owners, len_b)]
            # another process's blocks, batch or row, are None here
            idx_h = self._to_homes(idx_b, homes, 2)          # [S, L, B]
            if path == "fast":
                len_h = self._to_homes(len_b, homes, 1)
                parts = [None if x is None else fast_path.pull_pool(
                    block(k), x, n, row0=sl.start)
                    for k, (_, sl), x, n in zip(here, homes, idx_h, len_h)]
                raw = col.reduce_scatter_onto_shards(parts, srcs, owners,
                                                     topo, dim=1)
                pooled_b = [None if r is None
                            else embedding.cvm_pooled(r, self.use_cvm)
                            for r in raw]
            elif path == "mxu":
                if plan is None:
                    plan = [None if x is None else mxu_path.block_plan(
                        x, sl.start, sl.stop - sl.start)[1]
                        for (_, sl), x in zip(homes, idx_h)]
                parts = []
                for k, (_, sl), pl in zip(here, homes, plan):
                    dims = mxu_path.make_dims(s * l * b_loc * n_b,
                                              sl.stop - sl.start)
                    parts.append(None if pl is None else
                                 mxu_path.pull_values_block(
                                     block(k), pl, dims).reshape(
                                         s, l, b_loc * n_b, -1))
                vals = col.reduce_scatter_onto_shards(parts, srcs, owners,
                                                      topo, dim=2)
                pooled_b = [None if v is None
                            else mxu_path.pool_cvm_values(v, self.use_cvm)
                            for v in vals]
            else:
                parts = [None if x is None else embedding.pull_sparse(
                    block(k), x.permute(0, 2, 1), row0=sl.start)
                    for k, (_, sl), x in zip(here, homes, idx_h)]
                emb_b = col.reduce_scatter_onto_shards(parts, srcs, owners,
                                                       topo, dim=1)
        labels_b = [labels[k] for k in owners]
        ins_b = [None if x is None else self._ins_cvm(x) for x in labels_b]
        extras_g = self._extras_per_device(extras)
        if path == "reference":
            leaves = self._per_device_blocks(emb_b, dim=1)
            lens_g = self._per_device_blocks(len_b, dim=1)
            ins_g = self._per_device_blocks(ins_b, dim=0)

            def make_input(g):
                def to_input(emb):
                    x = fused_seqpool_cvm(emb, lens_g[g], ins_g[g],
                                          self.use_cvm)
                    if self._dym_mask is not None:
                        m = self._const(self._dym_mask, emb.device)
                        m = m if self.use_cvm else m[:, 2:]
                        x = x * m.reshape(-1)[None]
                    return x
                return to_input
            inputs = [make_input(g) for g in range(len(topo.groups))]
        else:
            leaves = self._per_device_blocks(pooled_b, dim=0)
            inputs = None
        loss, preds, grads = self._replica_dense_half(
            leaves, self._per_device(dense), self._per_device(labels),
            self._per_device(valid), extras_g, inputs)
        preds = self._join_columns(preds, b_loc)
        self._accumulate_metrics(preds, self._join_columns(labels),
                                 self._join_columns(valid))
        with torch.no_grad():
            grads = self._split_columns(grads, b_loc,
                                        1 if path == "reference" else 0)
            if path == "reference":
                g_h = self._to_homes(grads, homes, 1)
            else:
                dp_h = self._to_homes(grads, homes, 0)
                ins_h = self._to_homes(ins_b, homes, 0)
            home_of = {sl.start: i for i, (_, sl) in enumerate(homes)}

            def step(k, blk, row0):
                i = home_of[row0]
                slot_ids = self._const(self._slot_ids_dev, topo.devices[k])
                if path == "fast":
                    fast_path.push_and_update(
                        blk, idx_h[i], len_h[i], dp_h[i], ins_h[i],
                        slot_ids, sgd, row0=row0)
                elif path == "mxu":
                    dims = mxu_path.make_dims(s * l * b_loc * n_b,
                                              blk["show"].shape[0])
                    payload = mxu_path.push_payload(
                        dp_h[i], ins_h[i], slot_ids, (s, l, b_loc * n_b))
                    mxu_path.push_block(blk, plan[i], dims,
                                        payload.reshape(-1, d + 4), sgd,
                                        row0)
                else:
                    acc = embedding.push_sparse_grads(
                        blk, idx_h[i].permute(0, 2, 1), g_h[i], slot_ids,
                        row0=row0)
                    sparse_opt.apply_push(blk, acc, sgd, row0=row0)
            self._step_row_blocks(ws, step)
        return loss, preds[:self.batch_size]

    def _to_homes(self, xs, homes, dim: int):
        """The batch blocks' ``xs`` (:meth:`_batch_owners` order, None
        where another process owns the block) concatenated in batch order
        along ``dim`` at each row block's home on this process
        (``homes``: ``Sharded.row_homes``), None where another process
        alone holds the row block: one gather over every process's
        homes."""
        topo = self.topology
        owners, _ = self._batch_owners()
        every = [k for ks, _ in homes for k in ks]
        got = dict(zip(every, col.gather_onto_shards(xs, owners, every, topo,
                                                     dim=dim)))
        return [next((got[k] for k in ks if topo.is_local(k)), None)
                for ks, _ in homes]

    def _apply_push_blocks(self, ws, delta, rows_loc: int, d_main: int,
                           sgd) -> None:
        """The rule over a ``Sharded`` working set, each table block with
        its first shard's slice of the merged delta
        (:meth:`_step_row_blocks`)."""
        def step(k, blk, row0):
            acc = mxu_path.acc_from_delta(delta[k], rows_loc, d_main=d_main)
            sparse_opt.apply_push(blk, acc, sgd, row0=row0)
        self._step_row_blocks(ws, step)

    @staticmethod
    def _step_row_blocks(ws, step) -> None:
        """``step(shard, block, row0)`` once for each row block of a
        ``Sharded`` working set (``Sharded.row_blocks``: a dict of the
        fields' blocks, updated in place on the device of its first
        shard).  The rules are elementwise over rows, so that is the
        whole update; under dp × sharding the other nodes' replicas of
        the block then take a copy of it, so the replicas stay bit-equal
        (a card and the host may round a rule differently), as the dense
        replicas take the one dense step.  Across processes each process
        steps its own home of a replicated block (``Sharded.row_homes``)
        from the same gathered inputs, so theirs stay bit-equal too."""
        stepped = {}
        for k, sl, _ in ws["show"].row_blocks():
            blk = {f: t.parts[k] for f, t in ws.items()}
            step(k, blk, sl.start)
            stepped[sl.start] = blk
        for k, blk in ws["show"].unique():
            home = stepped[ws["show"].rows(k).start]
            if blk is home["show"]:
                continue
            for f, t in ws.items():
                t.parts[k].copy_(home[f])

    def _shard_tables(self, ws, tspec: Spec) -> List[torch.Tensor]:
        """Each shard's feature-major pull table [3 + D (+ Dex) + 1,
        rows_loc]: show, click, embed_w, mf (, mf_ex), mf_size.  From a
        ``Sharded`` set each is stacked on the shard's device from its own
        block; on one device, the views of one stacked table."""
        def stack(f):
            cols = [f["show"], f["click"], f["embed_w"], *f["mf"].T]
            if "mf_ex" in f:
                cols += list(f["mf_ex"].T)
            cols.append(f["mf_size"].to(torch.float32))
            return torch.stack(cols)
        if not isinstance(ws["show"], Sharded):
            return self.topology.split(stack(ws), tspec)
        shard_of = {id(blk): k for k, blk in ws["show"].unique()}
        return ws["show"].map_blocks(lambda blk: stack(
            {f: t.parts[shard_of[id(blk)]] for f, t in ws.items()})).parts

    def _batch_owners(self):
        """(owners, by_device): the first shard (flat order) that holds
        each batch block of ``batch_spec`` — shards that differ only
        along mp / sp / ep / pp hold the same columns, and the owner's
        copy is the one read — and, for each device of
        ``topology.groups``, the batch blocks whose owner sits there, in
        order (possibly none)."""
        if self._owners is None:
            t = self.topology
            axes = ("dp", "sharding")
            owners = [None] * t.axis_size(axes)
            for k in range(t.world_size):
                b = t.axis_index(k, axes)
                if owners[b] is None:
                    owners[b] = k
            self._owners = (owners, [[b for b, k in enumerate(owners)
                                      if k in ks] for _, ks in t.groups])
        return self._owners

    def _per_device(self, x) -> List[Optional[torch.Tensor]]:
        """A batch plane (dim 0 the batch) as one tensor per device of
        ``topology.groups``: its batch blocks' columns in order (None on
        a device that owns none).  A global tensor is the one device's."""
        if not isinstance(x, list):
            if len(self.topology.groups) != 1:
                raise ValueError("a global batch plane under a topology "
                                 "whose shards sit on distinct devices")
            return [x]
        owners, _ = self._batch_owners()
        return self._per_device_blocks([x[k] for k in owners])

    def _extras_per_device(self, extras) -> List[Optional[Dict]]:
        """The model's extra planes (:meth:`_model_extras`) as one dict
        per device of ``topology.groups``: a per-record plane's batch
        blocks (:meth:`_per_device`); ``ads_offset``, a per-batch plane
        replicated on every shard, the device's own copy."""
        extras = self._model_extras(extras)
        groups = self.topology.groups
        if not extras:
            return [None] * len(groups)
        per = {k: ([v[ks[0]] for _, ks in groups]
                   if k == "ads_offset" and isinstance(v, list)
                   else self._per_device(v)) for k, v in extras.items()}
        return [{k: v[g] for k, v in per.items()}
                for g in range(len(groups))]

    def _per_device_blocks(self, blocks, dim: int = 0
                           ) -> List[Optional[torch.Tensor]]:
        """Per-batch-block tensors (each on its owner's device) → one per
        device of ``topology.groups``, concatenated along ``dim``."""
        _, by_dev = self._batch_owners()
        return [None if not bs else blocks[bs[0]] if len(bs) == 1
                else torch.cat([blocks[b] for b in bs], dim=dim)
                for bs in by_dev]

    def _split_columns(self, x, b_loc: int, dim: int = 0) -> List:
        """Per-device tensors (:meth:`_per_device_blocks`) → the batch
        blocks' tensors of ``b_loc`` columns along ``dim``, in order."""
        owners, by_dev = self._batch_owners()
        out = [None] * len(owners)
        for bs, t in zip(by_dev, x):
            for i, b in enumerate(bs):
                out[b] = t.narrow(dim, i * b_loc, b_loc)
        return out

    def _join_columns(self, x, b_loc: int = 0) -> torch.Tensor:
        """Per-shard planes (or, with ``b_loc``, per-device ones in
        ``topology.groups`` order) → the batch on the trainer's device,
        in batch order (under a dp axis across processes, the columns
        this process holds)."""
        if b_loc:
            x = self._split_columns(x, b_loc)
        else:
            owners, _ = self._batch_owners()
            x = [x[k] for k in owners]
        # another process's columns are None here
        return torch.cat([on_device(t, self.device) for t in x
                          if t is not None])

    def _const(self, t: torch.Tensor, dev) -> torch.Tensor:
        """A constant of the trainer (slot ids, the dynamic-dim mask) on
        ``dev``'s memory, copied there once."""
        if same_device(t.device, dev):
            return t
        key = (id(t), device_key(physical_device(dev)))
        if key not in self._consts:
            self._consts[key] = on_device(t, dev)
        return self._consts[key]

    def dense_replicas(self) -> List[torch.nn.Module]:
        """The dense half's replicas, one per device of the topology in
        ``topology.groups`` order; the first is ``self.model``."""
        if not self._multi:
            return [self.model]
        if self._replicas is None:
            self._replicas = [self.model] + [
                copy.deepcopy(self.model).to(physical_device(dev))
                for dev, _ in self.topology.groups[1:]]
        return self._replicas

    def _sync_replicas(self) -> None:
        """Copy the model's parameters and buffers into every other
        replica."""
        reps = self.dense_replicas()
        if len(reps) == 1:
            return
        src = self.model.state_dict()
        with torch.no_grad():
            for r in reps[1:]:
                for k, v in r.state_dict().items():
                    v.copy_(src[k])

    def _replica_dense_half(self, pooled, dense, labels, valid, extras,
                            inputs=None):
        """The dense half over one replica per device, each on its
        batch blocks' columns (lists in ``topology.groups`` order; None
        on a device that owns no batch block, whose replica sits the step
        out).  The loss is the global masked mean (each replica's
        :meth:`_loss_and_preds` over the global count of valid records,
        summed), the replicas' grads are summed in device order on the
        trainer's device, and the one optimizer step
        taken there is copied to every replica, so the replicas stay
        bit-equal: the function GSPMD computes for a replicated net over
        a batch-sharded input.  (A step taken on each device would round
        differently where a card's elementwise kernel contracts a
        multiply-add that the host does not.)  Under a dp axis that spans
        processes the count, the losses and the grads of every process's
        replicas are gathered over the group and summed in global device
        order (``collective.fold_ranks``: rank 0's devices, then rank
        1's), and every process takes the same optimizer step, so the
        ranks' dense params stay bit-equal and equal one process holding
        every replica.  ``pooled``: the leaves the grads are taken for;
        ``inputs[g](leaf)`` makes device g's model input of its leaf
        (default :meth:`_dense_input`).

        A model that reads a page-view plane reaches rows anywhere in the
        batch (``rank_attention``'s peer rows): every replica also gets
        the whole batch's input, gathered in batch order onto its device
        (``peers``, with ``peer_rows`` the rows it owns), and the grads
        of that copy are summed onto the rows' owners in device order
        (``reduce_scatter_onto_shards``), then added to each replica's
        own.
        Returns (loss, each replica's preds, each leaf's grad); one
        device is :meth:`_pooled_dense_half`."""
        if not self._multi:
            loss, preds, d_pooled = self._pooled_dense_half(
                pooled[0], dense[0], labels[0], valid[0], extras[0])
            return loss, [preds], [d_pooled]
        models = self.dense_replicas()
        group = self.topology.process_group
        inputs = inputs or [self._dense_input] * len(pooled)
        count = col.fold_ranks(
            [None if v is None else [torch.sum(v.to(torch.float32))]
             for v in valid], self.device, group, "count")[0]
        leaves = [None if x is None else x.detach().requires_grad_(True)
                  for x in pooled]
        xs = [None if x is None else make(x)
              for x, make in zip(leaves, inputs)]
        peers = self._peer_inputs(xs) if self._reads_pv else None
        losses, preds, own = [], [], []
        for g, ((dev, _), model, x, dn, lb, v, ex) in enumerate(zip(
                self.topology.groups, models, xs, dense, labels, valid,
                extras)):
            for prm in model.parameters():
                prm.grad = None
            if x is None:
                losses.append(None)
                preds.append(None)
                own.append(None)
                continue
            if peers is not None:
                x = x.detach().requires_grad_(True)
                ex = dict(ex or {}, peers=peers[g][0],
                          peer_rows=peers[g][1])
            loss, p = self._loss_and_preds(x, dn, lb, v, ex, model,
                                           on_device(count, dev))
            loss.backward()
            losses.append(loss.detach())
            preds.append(p)
            own.append(x)
        if peers is not None:
            back = self._peer_grads(peers)
            for x, xi, pg in zip(xs, own, back):
                if x is not None:
                    x.backward(xi.grad + pg)
        with torch.no_grad():
            total, *grads = col.fold_ranks(
                [None if ls is None else [ls] + [prm.grad for prm in
                                                 m.parameters()]
                 for ls, m in zip(losses, models)],
                self.device, group, "dense_grads")
            for prm, acc in zip(self.model.parameters(), grads):
                prm.grad = acc
        if self.async_dense is None:
            self.dense_opt.step()
            self._sync_replicas()
        return total, preds, [None if x is None else x.grad for x in leaves]

    def _replica_homes(self) -> List[tuple]:
        """(the first shard, the batch blocks) of every dense replica over
        every process, in global device order (rank 0's devices of
        ``topology.groups``, then rank 1's, ...): every process places its
        shards alike, as ``collective.fold_ranks`` has every rank hold as
        many replicas."""
        t = self.topology
        owners, _ = self._batch_owners()
        pos = [[t.local_shards.index(k) for k in ks] for _, ks in t.groups]
        out = []
        for r in range(t.nranks):
            mine = t.shards_of(r)
            for p in pos:
                ks = [mine[i] for i in p]
                out.append((ks[0], [b for b, k in enumerate(owners)
                                    if k in ks]))
        return out

    def _peer_inputs(self, xs) -> List[Optional[tuple]]:
        """For each device of ``topology.groups`` that holds batch
        blocks (its model input ``xs[g]``, else None): (the whole batch's
        model input gathered there in batch order, a leaf of its own;
        the rows of it that the device's blocks are).  Every process's
        replicas gather alike (``collective.gather_onto_shards``)."""
        owners, by_dev = self._batch_owners()
        b_loc = next(x.shape[0] // len(bs) for x, bs in zip(xs, by_dev)
                     if x is not None)
        blocks = self._split_columns([None if x is None else x.detach()
                                      for x in xs], b_loc)
        dsts = [k for k, bs in self._replica_homes() if bs]
        whole = dict(zip(dsts, col.gather_onto_shards(
            blocks, owners, dsts, self.topology, dim=0)))
        out = [None] * len(xs)
        for g, ((_, ks), x) in enumerate(zip(self.topology.groups, xs)):
            if x is None:
                continue
            w = whole[ks[0]]
            rows = torch.cat([torch.arange(b * b_loc, (b + 1) * b_loc,
                                           device=w.device)
                              for b in by_dev[g]])
            out[g] = (w.requires_grad_(True), rows)
        return out

    def _peer_grads(self, peers) -> List[Optional[torch.Tensor]]:
        """The grads of every replica's copy of the whole batch's input
        (:meth:`_peer_inputs`) summed in global device order onto each
        batch block's owner, as one tensor per device (its blocks' rows).
        Every process's replicas take part
        (``collective.reduce_scatter_onto_shards``)."""
        owners, _ = self._batch_owners()
        mine = {ks[0]: p for (_, ks), p in zip(self.topology.groups, peers)}
        srcs = [k for k, bs in self._replica_homes() if bs]
        blocks = col.reduce_scatter_onto_shards(
            [mine[k][0].grad if k in mine else None for k in srcs],
            [(k,) for k in srcs], owners, self.topology, dim=0)
        return self._per_device_blocks(blocks, dim=0)

    def _put_batch(self, batch: PackedBatch):
        """Host batch → device tensors (pinned, asynchronous on a card):
        the step's five planes and a dict of the extra planes.  With
        shards on distinct devices each plane is a per-shard list, each
        shard's batch columns uploaded to its device; ``ads_offset``, a
        per-batch plane, is replicated: every shard holds the whole plane
        (one copy a device), as the JAX package replicates it."""
        extras = {}
        if batch.rank_offset is not None:
            extras["rank_offset"] = batch.rank_offset
        if batch.aux:
            extras.update(batch.aux)
        if batch.ads_offset is not None:
            extras["ads_offset"] = batch.ads_offset
        if self._multi:
            # indices [S, B, L] and lengths [S, B] carry the batch on dim 1
            put = self._put_columns
            return (put(batch.indices, 1), put(batch.lengths, 1),
                    put(batch.dense, 0), put(batch.labels, 0),
                    put(batch.valid, 0),
                    {k: put(v, None if k == "ads_offset" else 0)
                     for k, v in extras.items()})
        planes = tuple(pf.to_device(a, self.device)
                       for a in (batch.indices, batch.lengths, batch.dense,
                                 batch.labels, batch.valid))
        return planes + ({k: pf.to_device(v, self.device)
                          for k, v in extras.items()},)

    def _put_columns(self, a: np.ndarray, dim: Optional[int]
                     ) -> List[torch.Tensor]:
        """Each shard's block of host plane ``a`` along its batch dim
        ``dim`` (``batch_spec``; :func:`pf.batch_columns`; ``dim`` None:
        the whole plane), uploaded to the shard's device once (shards
        with the same columns on one device share it)."""
        topo = self.topology
        made, out = {}, [None] * topo.world_size
        for k in topo.local_shards:
            idx, n = ((0, 1) if dim is None
                      else topo.block(topo.batch_spec(), k, 0))
            key = (idx, device_key(topo.device_of(k)))
            if key not in made:
                made[key] = pf.to_device(
                    a if dim is None else pf.batch_columns(a, dim, idx, n),
                    topo.device_of(k))
            out[k] = made[key]
        return out

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
        # the replicas start every pass from the model's weights (loaded,
        # resumed or stepped since)
        self._sync_replicas()
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
        real records on the host, when the instance dump is on.

        Each step's host dispatch seconds (before ``_core`` to after it,
        before the loss is read back) are observed as
        ``trainer.step_dispatch_s``, as in the JAX package; with no jit
        there is no ``trainer.step_compile_s``."""
        cuda = self.device.type == "cuda"
        m_step = time.monotonic()
        t_step = time.perf_counter()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        loss, preds = self._core(path, *args, plan=plan, extras=extras)
        if cuda:
            ev[1].record()
            log["events"].append(ev)
        stat_observe("trainer.step_dispatch_s", time.perf_counter() - t_step)
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
        """A pass's stats: its metrics and losses read back from the
        device (the pass's one wait for it), traced as
        ``trainer.pass_end``."""
        with trace.span("trainer.pass_end"):
            losses = log["losses"]
            out = self._finalize_metrics(self.auc_state)
            out["batches"] = len(losses)
            # one stacked device->host copy, not one per batch scalar
            per_batch = (torch.stack(losses).cpu().numpy() if losses
                         else np.zeros((0,), np.float32))
            out["losses"] = [float(x) for x in per_batch]
            out["loss"] = (float(per_batch.mean()) if losses
                           else float("nan"))
            if self.device.type == "cuda":
                # read after the synchronising copy above
                out["step_ms"] = [a.elapsed_time(b)
                                  for a, b in log["events"]]
            if self.wuauc is not None:
                # host seconds of the per-batch preds copy and record
                # append
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
        self._exchange_bf16 = bool(flags.get_flags("sharded_exchange_bf16"))
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
                idx = ([None if x is None else x.permute(0, 2, 1)
                        for x in indices]
                       if isinstance(indices, list)
                       else indices.permute(0, 2, 1))
                self._timed_step(path, log, idx, lengths, dense, labels,
                                 valid, extras=extras, uid=uid, dump=dump)
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
        placed = ({"topology": self.topology,
                   "shardings": self.pass_shardings(arrays)}
                  if self._multi else {})
        feed = pf.upload_pass(arrays, self.device, staged=staged,
                              keep_host=keep, **placed)
        if path == "mxu" and self._multi:
            self._precompute_block_plans(feed)
        elif path == "mxu":
            n, s, l, b = feed.data["indices"].shape
            dims = mxu_path.make_dims(s * l * b,
                                      self.engine.ws["show"].shape[0])
            # padding occurrences (row 0) are dead kernel work — trim the
            # plans to the widest batch's real-occurrence count (host
            # lengths are exact, so this is a static bound for the pass)
            per_batch = arrays.lengths.reshape(s, n, b).sum(axis=(0, 2))
            eff = sp.trimmed_dims(dims, int(per_batch.max()))
            pf.precompute_plans(feed, dims, eff, slot_ids=self.slot_ids)
        elif path == "mxu_sharded":
            self._precompute_sharded_plans(feed, self.pass_shardings(arrays))
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

    def pass_shardings(self, arrays: pf.HostPassArrays
                       ) -> Optional[Dict[str, Spec]]:
        """Per-shard batch layout of the resident pass's planes under a
        topology (the batch dim split over dp × sharding: shard k reads
        batch columns [k*B_loc, (k+1)*B_loc); ``ads_offset``, a per-batch
        plane, is replicated); None with no topology.  On one device the
        planes stay one set of tensors and a shard's block is
        ``topology.split(plane, spec)[k]``; on distinct devices each
        shard's block is uploaded to its device (``pf.upload_pass``)."""
        if self.topology is None:
            return None
        dp = ("dp", "sharding")
        specs = {
            "indices": Spec(None, None, None, dp),      # [N, S, L, B]
            "lengths": Spec(None, None, dp),            # [N, S, B]
            "dense": Spec(None, dp, None),              # [N, B, D]
            "labels": (Spec(None, dp) if arrays.labels.ndim == 1
                       else Spec(None, dp, None)),
            "valid": Spec(None, dp),
        }
        for k in arrays.extra_planes():
            specs[k] = Spec(None, dp, None)
        if arrays.ads_offset is not None:
            specs["ads_offset"] = Spec()
        return specs

    def _precompute_sharded_plans(self, feed: pf.PackedPassFeed,
                                  specs: Dict[str, Spec]) -> None:
        """Pass-resident per-shard exchange plans: each shard's localized
        sorted-spmm plan of every batch, built once at pass build, so the
        hot step sorts nothing (≙ the pass-scope shard index of
        split_input_to_shard, heter_comm_inl.h:1117).  Each plan array is
        stacked [N, shards, ...] on one device; on distinct devices it is
        a list of each shard's [N, ...] stack, built on the shard's
        device.

        The plans are untrimmed (a shard's non-owned ids sort to the
        back, so padding is no droppable prefix) and scale as
        n_batches × shards × gathered P; their bytes are logged."""
        _, tbl_axes, _, rows_loc, _ = self._sharded_layout()
        topo = self.topology
        idx = feed.data["indices"]
        blocks = (idx.parts if isinstance(idx, Sharded)
                  else topo.split(idx, specs["indices"]))
        per_batch = []
        for i in range(feed.n_batches):
            _, plans = se.local_plan([None if x is None else x[i].reshape(-1)
                                      for x in blocks],
                                     rows_loc, topo, tbl_axes)
            per_batch.append(plans if self._multi else
                             [torch.stack([pl[j] for pl in plans])
                              for j in range(len(pf.PLAN_KEYS))])
        if self._multi:
            feed.plans = {key: [torch.stack([p[k][j] for p in per_batch])
                                if topo.is_local(k) else None
                                for k in range(topo.world_size)]
                          for j, key in enumerate(pf.PLAN_KEYS)}
        else:
            feed.plans = {key: torch.stack([p[j] for p in per_batch])
                          for j, key in enumerate(pf.PLAN_KEYS)}
        feed.plan_dims = self._sharded_plan_key(feed)
        logging.getLogger(__name__).info(
            "sharded pass plans resident: %.0f MB (n_batches x shards x "
            "gathered P, untrimmed)",
            sum(t.numel() * t.element_size()
                for v in feed.plans.values()
                for t in (v if isinstance(v, list) else [v])
                if t is not None) / 1e6)

    def _precompute_block_plans(self, feed: pf.PackedPassFeed) -> None:
        """Pass-resident plans of explicit mxu on distinct devices: for
        each row block of the working set, the plan of every batch's
        whole ids (gathered in batch order onto the block's device,
        padding masked) against the block's rows
        (``mxu_path.block_plan``), stacked [N, ...] on that device.
        ``feed.plan_shards`` names each list entry's shard."""
        topo = self.topology
        owners, _ = self._batch_owners()
        homes = self.engine.ws["show"].row_homes()
        idx = self._to_homes([feed.data["indices"].parts[k]
                              for k in owners], homes, 3)
        lens = self._to_homes([feed.data["lengths"].parts[k]
                               for k in owners], homes, 2)
        per_home = []
        for (_, sl), x, n in zip(homes, idx, lens):
            if x is None:               # another process's row block
                per_home.append(None)
                continue
            plans = [mxu_path.block_plan(_mask_padding(x[i], n[i]),
                                         sl.start, sl.stop - sl.start)[1]
                     for i in range(feed.n_batches)]
            per_home.append([torch.stack([p[j] for p in plans])
                             for j in range(len(pf.PLAN_KEYS))])
        feed.plans = {key: [None if h is None else h[j] for h in per_home]
                      for j, key in enumerate(pf.PLAN_KEYS)}
        feed.plan_shards = [next((k for k in ks if topo.is_local(k)), None)
                            for ks, _ in homes]
        feed.plan_dims = self._block_plan_key(feed)

    def _block_plan_key(self, feed: pf.PackedPassFeed):
        """Geometry a feed's per-row-block mxu plans were built for (feed
        shape, table height, row blocks): a change makes them
        corrupting."""
        return ("mxu_blocks", tuple(feed.data["indices"].shape),
                self.engine.ws["show"].shape[0],
                len(self.engine.ws["show"].row_homes()))

    def _sharded_plan_key(self, feed: pf.PackedPassFeed):
        """Geometry sharded plans were built for (feed shape, table
        height, table axes): any change makes resident plans corrupting,
        so the packed loop compares it before every pass."""
        _, tbl_axes, n_tbl, _, _ = self._sharded_layout()
        return ("mxu_sharded", tuple(feed.data["indices"].shape),
                self.engine.ws["show"].shape[0], tbl_axes, n_tbl)

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
        if (feed.topology is not None) != self._multi:
            raise ValueError(
                "the feed was placed for "
                + ("shards on distinct devices" if feed.topology is not None
                   else "one device")
                + ", the trainer's topology is not — rebuild the feed "
                "(build_pass_feed) with this trainer")
        n, s, l, b = feed.data["indices"].shape
        plans = None
        if path == "mxu" and feed.plans is not None:
            # plans encode the table geometry (sentinel tile); a cross-pass
            # resize makes them corrupting, not just stale
            cur = (self._block_plan_key(feed) if self._multi else
                   mxu_path.make_dims(s * l * b,
                                      self.engine.ws["show"].shape[0]))
            if cur != feed.plan_dims:
                raise ValueError(
                    "PackedPassFeed plans were built for table dims "
                    f"{feed.plan_dims}, but the working set now needs "
                    f"{cur} — rebuild the feed (build_pass_feed) after a "
                    "table resize")
            plans = feed.plans
        elif path == "mxu_sharded" and feed.plans is not None:
            cur = self._sharded_plan_key(feed)
            if cur != feed.plan_dims:
                raise ValueError(
                    "PackedPassFeed sharded plans were built for "
                    f"{feed.plan_dims}, but the exchange now needs {cur} — "
                    "rebuild the feed (build_pass_feed) after a table or "
                    "mesh change")
            plans = feed.plans
        elif path == "ragged" and feed.plans is not None:
            cur = self._ragged_plan_key(feed)
            if cur != feed.plan_dims:
                raise ValueError(
                    "PackedPassFeed CSR plans were built for "
                    f"{feed.plan_dims}, but the pass now needs {cur} — "
                    "rebuild the feed (build_pass_feed)")
            plans = feed.plans
        self._exchange_bf16 = bool(flags.get_flags("sharded_exchange_bf16"))
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
                if plans is None:
                    plan = None
                elif feed.topology is not None:
                    plan = [None if plans["rows2d"][k] is None else
                            sp.Plan(*(plans[key][k][i]
                                      for key in pf.PLAN_KEYS))
                            for k in range(len(plans["rows2d"]))]
                elif path == "mxu":
                    plan = pf.mxu_step_plan(pf.slice_batch(plans, i))
                elif path == "ragged":
                    plan = pf.csr_plan(pf.slice_batch(plans, i))
                else:
                    plan = sp.Plan(**pf.slice_batch(plans, i))
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
        # the other processes' records too: every rank reports the
        # global AUC
        auc_state = sum_auc_state(
            auc_state, getattr(self.topology, "process_group", None))
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
