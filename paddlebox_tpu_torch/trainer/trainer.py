"""Training loop — the train_from_dataset path.

Port of ``paddlebox_tpu/trainer/trainer.py`` (≙ BoxPSTrainer::Run →
BoxPSWorker::TrainFiles, boxps_trainer.cc:282, boxps_worker.cc:1278):
pull → seqpool + CVM → DeepFM fwd/bwd → merged push → sparse adagrad →
dense Adam → AUC buckets, on one of three sparse lowerings:

* ``mxu``    — sorted gather / merged scatter kernels (ps/mxu_path.py);
  what ``auto`` resolves to with one device;
* ``fast``   — padded-dense, its pull the fused ``gather_pool`` kernel
  (ps/fast_path.py); adagrad only;
* ``ragged`` — CSR [U]-domain step (ps/ragged_path.py); needs the
  pass-resident feed's host-built plans.

Two entry points: ``train_pass(dataset)`` packs batches on host threads
through a bounded Channel while the device trains (≙ PackBatchTask,
boxps_worker.cc:1259); ``train_pass(build_pass_feed(dataset))`` packs the
whole pass once, keeps it on the device with its per-batch plans, and
the loop indexes batch i (≙ SlotPaddleBoxDataFeed's whole-pass pack,
data_feed.h:2036).

PyTorch runs the step eagerly, so there is no jit and no donation: the
working set, the dense params, the optimizer state and the AUC buckets
are updated in place on the device.  Not ported yet: the ``reference``
and multi-device lowerings, the async dense table, amp, dumps and WuAUC.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.batch_pack import BatchPacker, PackedBatch
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.metrics.auc import (AucCalculator, accumulate_auc,
                                             make_auc_state)
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import embedding, fast_path, mxu_path, ragged_path
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.utils import intervals, trace
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.monitor import stat_observe
from paddlebox_tpu_torch.utils.timer import TimerRegistry


class SparseTrainer:
    def __init__(self, engine: BoxPSEngine, model: torch.nn.Module,
                 feed_config: DataFeedConfig, batch_size: int,
                 label_slot: str = "label",
                 dense_optimizer: Optional[torch.optim.Optimizer] = None,
                 use_cvm: bool = True, auc_table_size: int = 100_000,
                 sparse_path: str = "auto", seed: int = 0,
                 device: DeviceLike = None):
        """``model`` is re-initialised from ``seed`` (its
        ``reset_parameters(generator)``) and moved to ``device``; load
        other weights afterwards (``model.load_jax_params``).
        ``dense_optimizer`` defaults to Adam(lr=1e-3) over the model's
        parameters — the same update as the JAX package's
        ``optax.adam(1e-3)``: bias-corrected moments, eps added after the
        square root."""
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
        if sparse_path == "auto" \
                and flags.get_flags("sparse_step_path") != "auto":
            sparse_path = flags.get_flags("sparse_step_path")
        self.sparse_path = sparse_path
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

        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.dense_opt = dense_optimizer or torch.optim.Adam(
            self.model.parameters(), lr=1e-3)
        self.auc_state = make_auc_state(auc_table_size, self.device)
        self.auc = AucCalculator(auc_table_size)
        self._check_nan = flags.get_flags("check_nan_inf")

    # ------------------------------------------------------------------
    def _resolve_path(self) -> str:
        """Resolve sparse_path='auto' against the live working set: with
        one device and no topology the JAX package resolves to mxu."""
        assert self.engine.ws is not None, \
            "engine pass lifecycle must run before building the step " \
            "(begin_feed_pass/add_keys/end_feed_pass/begin_pass)"
        if embedding.is_quantized(self.engine.ws):
            raise ValueError(
                "the working set is serving-frozen; training requires the "
                "f32 store — rebuild the pass")
        return "mxu" if self.sparse_path == "auto" else self.sparse_path

    def _validate_path(self, path: str) -> None:
        """Reject configs a path cannot honor (both entry points)."""
        if "mf_ex" in self.engine.ws:
            raise ValueError("extended (mf_ex) tables are not ported")
        if path == "fast":
            if self.engine.config.sgd.optimizer != "adagrad":
                raise ValueError(
                    "sparse_path='fast' implements the adagrad rule only "
                    f"(got {self.engine.config.sgd.optimizer!r})")
        elif path in ("reference", "mxu_sharded"):
            raise ValueError(f"sparse_path {path!r} is not ported to the "
                             "PyTorch package")
        elif path not in ("mxu", "ragged"):
            raise ValueError(f"unknown sparse_path {path!r}")

    # ------------------------------------------------------------------
    def _pooled_dense_half(self, pooled, dense, labels, valid):
        """Dense fwd/bwd + dense optimizer + AUC; returns (loss, preds,
        d_pooled) — the pooled grads feed the sparse push."""
        b = pooled.shape[0]
        pooled = pooled.detach().requires_grad_(True)
        x = pooled
        if self._dym_mask is not None:
            x = x * self._dym_mask[None]
        x = x if self.use_cvm else x[:, :, 2:]
        logits = self.model(x.reshape(b, -1), dense)
        w = valid.to(torch.float32)
        per = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
        loss = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.dense_opt.step()
        preds = torch.sigmoid(logits.detach())
        accumulate_auc(self.auc_state, preds, labels, valid)
        return loss.detach(), preds, pooled.grad

    def _core(self, path, idx_slb, lengths, dense, labels, valid,
              plan=None):
        """One step of ``path`` on device tensors, updating the working
        set, the dense params and the AUC state in place: idx_slb
        [S, L, B]; plan is the feed's plan of this batch (None → the mxu
        lowering plans in-step; ragged needs one)."""
        ws = self.engine.ws
        s, l, b = idx_slb.shape
        sgd = self.engine.config.sgd
        ins_cvm = torch.stack([torch.ones_like(labels), labels], dim=1)
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
                                                self.use_cvm)
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
                                                        labels, valid)
        with torch.no_grad():
            if path == "mxu":
                mxu_path.push_and_update(ws, plan, dims, idx_slb, d_pooled,
                                         ins_cvm, self._slot_ids_dev, sgd)
            elif path == "fast":
                fast_path.push_and_update(ws, idx_slb, lengths, d_pooled,
                                          ins_cvm, self._slot_ids_dev, sgd)
            else:
                ragged_path.push_and_update(ws, plan, d_pooled, ins_cvm,
                                            (s, l, b), sgd)
        return loss, preds

    def _put_batch(self, batch: PackedBatch):
        """Host batch → device tensors (pinned, asynchronous on a card)."""
        return tuple(pf.to_device(a, self.device)
                     for a in (batch.indices, batch.lengths, batch.dense,
                               batch.labels, batch.valid))

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
        step between CUDA events recorded around its launches."""
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
        return stats

    def _timed_step(self, path, log, *args, plan=None) -> None:
        """Run one step, append its loss (and CUDA events) to ``log``."""
        cuda = self.device.type == "cuda"
        m_step = time.monotonic()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with self.timers("step"):
            loss, _ = self._core(path, *args, plan=plan)
        if cuda:
            ev[1].record()
            log["events"].append(ev)
        # host enqueue window (the device may run past it)
        intervals.record("device", m_step, time.monotonic())
        if self._check_nan and not np.isfinite(float(loss)):
            raise FloatingPointError(
                f"NaN/Inf loss at batch {len(log['losses'])}")
        log["losses"].append(loss)

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
        return out

    def _train_stream(self, dataset: SlotDataset, prefetch: int,
                      pack_threads: int, progress) -> Dict[str, float]:
        """Per-batch host-pack path of train_pass."""
        path = self._resolve_path()
        self._validate_path(path)
        if path == "ragged":
            raise ValueError(
                "sparse_path='ragged' requires the pass-resident feed "
                "(build_pass_feed / train_pass(feed)) — the streaming "
                "per-batch path has no host CSR plan build")
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
        log = {"losses": [], "events": []}
        try:
            while True:
                try:
                    batch = ch.get().result()
                except ChannelClosed:
                    break
                indices, lengths, dense, labels, valid = \
                    self._put_batch(batch)
                self._timed_step(path, log, indices.permute(0, 2, 1),
                                 lengths, dense, labels, valid)
                if progress is not None:
                    progress(len(log["losses"]))
        finally:
            # on any exit unblock the producer, reap it and cancel queued
            # packs
            ch.close()
            t.join()
            pool.shutdown(wait=False, cancel_futures=True)
        return self._pass_stats(log)

    # ------------------------------------------------------------------
    # pass-resident path (≙ SlotPaddleBoxDataFeed whole-pass GPU pack,
    # data_feed.h:2036 + data_feed.cu:1210-1318): the loop indexes batch i
    # of device-resident stacked tensors; the mxu plans (trimmed, with the
    # static payload planes) and the ragged CSR plans are built once at
    # feed build, so the hot step contains no sort of its own plan.
    def pack_pass_host(self, dataset: SlotDataset) -> pf.HostPassArrays:
        """Host half of :meth:`build_pass_feed`: pack + translate the
        whole pass into SoA planes (and, on the ragged lowering, its CSR
        plans).  No device work."""
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
                              key_mapper=self.engine.mapper,
                              batch_counts=counts)
        if self.sparse_path == "ragged":
            arrays.csr = pf.build_csr_plans(arrays.indices, self.slot_ids,
                                            arrays.n_batches,
                                            arrays.batch_size)
        return arrays

    def finish_pass_feed(self, arrays: pf.HostPassArrays
                         ) -> pf.PackedPassFeed:
        """Device half of :meth:`build_pass_feed`: upload + relayout the
        packed planes and build the lowering's per-batch plans.  Needs
        the pass's working set (plan dims read its height)."""
        assert self.engine.ws is not None, "engine lifecycle must run first"
        path = self._resolve_path()
        self._validate_path(path)
        feed = pf.upload_pass(arrays, self.device)
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

    def build_pass_feed(self, dataset: SlotDataset) -> pf.PackedPassFeed:
        """Pack + translate + upload the whole pass and build its plans
        (pack_pass_host, then finish_pass_feed)."""
        assert self.engine.ws is not None, "engine lifecycle must run first"
        return self.finish_pass_feed(self.pack_pass_host(dataset))

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
        log = {"losses": [], "events": []}
        for i in range(feed.n_batches):
            bt = pf.slice_batch(feed.data, i)
            plan = (pf.plan_tuple(pf.slice_batch(plans, i))
                    if plans is not None else None)
            self._timed_step(path, log, bt["indices"], bt["lengths"],
                             bt["dense"], bt["labels"], bt["valid"],
                             plan=plan)
            if progress is not None:
                progress(i + 1)
        return self._pass_stats(log)

    def _finalize_metrics(self, auc_state) -> Dict[str, float]:
        self.auc.reset()
        self.auc.merge_device_state(
            {k: v.cpu().numpy() for k, v in auc_state.items()})
        out = self.auc.compute()
        pos, neg = self.auc.folded_buckets()
        out["auc_buckets"] = {"pos": pos.tolist(), "neg": neg.tolist()}
        return out
