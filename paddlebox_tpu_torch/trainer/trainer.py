"""Training loop driver — the train_from_dataset path, mxu lowering.

Port of ``paddlebox_tpu/trainer/trainer.py`` (≙ BoxPSTrainer::Run →
BoxPSWorker::TrainFiles, boxps_trainer.cc:282, boxps_worker.cc:1278):
per-batch pack → pull (sorted gather kernel) → seqpool + CVM → DeepFM
fwd/bwd → merged push (sorted scatter kernel) → sparse adagrad → dense
Adam → AUC buckets.  Host threads pack batches through a bounded
Channel while the device trains (≙ PackBatchTask boxps_worker.cc:1259).

PyTorch runs the step eagerly, so there is no jit and no donation: the
working set, the dense params, the optimizer state and the AUC buckets
are updated in place on the device.  Only the ``mxu`` lowering is
ported; the packed pass feed, the ragged/fast/reference lowerings, the
multi-device paths, the async dense table, amp, dumps and WuAUC are not.
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
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.metrics.auc import (AucCalculator, accumulate_auc,
                                             make_auc_state)
from paddlebox_tpu_torch.ps import embedding, mxu_path
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
        if path != "mxu":
            raise ValueError(
                f"sparse_path {path!r} is not ported to the PyTorch package "
                "(only 'mxu')")
        if "mf_ex" in self.engine.ws:
            raise ValueError("extended (mf_ex) tables are not ported")

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

    def _step(self, indices, lengths, dense, labels, valid):
        """One mxu step on device tensors: indices [S, B, L]."""
        ws = self.engine.ws
        idx_slb = indices.permute(0, 2, 1)                # [S, L, B]
        s, l, b = idx_slb.shape
        # geometry from the live working set, so a per-pass table resize
        # gets the right dims (and sentinel)
        dims = mxu_path.make_dims(s * l * b, ws["show"].shape[0])
        # the packer parks padding at row 0; the mask makes in-step
        # planning safe for hand-built batches too
        live = torch.arange(l, device=idx_slb.device)[None, :, None] \
            < lengths[:, None, :]
        idx_slb = torch.where(live, idx_slb, torch.zeros_like(idx_slb))
        with torch.no_grad():
            plan = mxu_path.build_plan(idx_slb, dims)
            pooled = mxu_path.pull_pool_cvm(ws, plan, dims, (s, l, b),
                                            self.use_cvm)
        loss, preds, d_pooled = self._pooled_dense_half(pooled, dense,
                                                        labels, valid)
        with torch.no_grad():
            ins_cvm = torch.stack([torch.ones_like(labels), labels], dim=1)
            mxu_path.push_and_update(ws, plan, dims, idx_slb, d_pooled,
                                     ins_cvm, self._slot_ids_dev,
                                     self.engine.config.sgd)
        return loss, preds

    def _put_batch(self, batch: PackedBatch):
        """Host batch → device tensors (pinned, asynchronous on a card)."""
        arrs = (batch.indices, batch.lengths, batch.dense, batch.labels,
                batch.valid)
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrs)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     .to(self.device, non_blocking=True) for a in arrs)

    # ------------------------------------------------------------------
    def train_pass(self, dataset: SlotDataset, prefetch: int = 4,
                   pack_threads: int = 1,
                   progress=None) -> Dict[str, float]:
        """Run one full pass over the dataset (≙ TrainFiles loop).

        Packing runs in background threads feeding a bounded channel so
        the device step overlaps host batch assembly; pack_threads > 1
        fans batch assembly over a thread pool while the channel of
        ordered futures keeps batch order.  progress, if given, is called
        as progress(n_batches_done) after every step."""
        t0 = time.perf_counter()
        with trace.span("trainer.train_pass", pass_id=self.engine.pass_id):
            stats = self._train_stream(dataset, prefetch, pack_threads,
                                       progress)
        dt = time.perf_counter() - t0
        self.engine.timers.add("train", dt)
        stat_observe("trainer.train_pass_s", dt)
        return stats

    def _train_stream(self, dataset: SlotDataset, prefetch: int,
                      pack_threads: int, progress) -> Dict[str, float]:
        """Per-batch host-pack path of train_pass."""
        self._validate_path(self._resolve_path())
        engine = self.engine
        assert engine.ws is not None, "call engine lifecycle first"
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
        cuda = self.device.type == "cuda"
        losses, events = [], []
        n_batches = 0
        try:
            while True:
                try:
                    batch = ch.get().result()
                except ChannelClosed:
                    break
                dev = self._put_batch(batch)
                m_step = time.monotonic()
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                with self.timers("step"):
                    loss, _ = self._step(*dev)
                if cuda:
                    ev[1].record()
                    events.append(ev)
                # host enqueue window (the device may run past it)
                intervals.record("device", m_step, time.monotonic())
                if self._check_nan and not np.isfinite(float(loss)):
                    raise FloatingPointError(
                        f"NaN/Inf loss at batch {n_batches}")
                losses.append(loss)
                n_batches += 1
                if progress is not None:
                    progress(n_batches)
        finally:
            # on any exit unblock the producer, reap it and cancel queued
            # packs
            ch.close()
            t.join()
            pool.shutdown(wait=False, cancel_futures=True)
        out = self._finalize_metrics(self.auc_state)
        out["batches"] = n_batches
        # one stacked device->host copy, not one per batch scalar
        per_batch = (torch.stack(losses).cpu().numpy() if losses
                     else np.zeros((0,), np.float32))
        out["losses"] = [float(x) for x in per_batch]
        out["loss"] = float(per_batch.mean()) if losses else float("nan")
        if cuda:
            # device time of each step, between events recorded around
            # the step's launches (read after the synchronising copy above)
            out["step_ms"] = [a.elapsed_time(b) for a, b in events]
        return out

    def _finalize_metrics(self, auc_state) -> Dict[str, float]:
        self.auc.reset()
        self.auc.merge_device_state(
            {k: v.cpu().numpy() for k, v in auc_state.items()})
        out = self.auc.compute()
        pos, neg = self.auc.folded_buckets()
        out["auc_buckets"] = {"pos": pos.tolist(), "neg": neg.tolist()}
        return out
